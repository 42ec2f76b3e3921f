#!/usr/bin/env python3
"""Which torch.distributed operations gloo takes on CUDA tensors.

    PYTHONPATH=src python3 tools/gloo_cuda_probe.py

Runs each operation on its own 2 ranks on a one-card machine (where
`spawn` picks gloo: both ranks on card 0), handing it
CUDA tensors directly, as `repro_torch.distributed` never does (it stages a
card's payload through host memory under gloo). Prints one line a
operation: "takes" with the result checked, or the error it raised (a hang
ends at the 30 s collective timeout). Needs one NVIDIA GPU.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

OPS = ("all_reduce", "broadcast", "reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
       "send_recv", "batch_isend_irecv", "barrier")


def probe(rank, world, dev, op):
    import torch
    import torch.distributed as dist
    x = torch.full((4,), float(rank + 1), device=dev)
    if op == "all_reduce":
        dist.all_reduce(x)
        want = [3.0] * 4
    elif op == "broadcast":
        dist.broadcast(x, 0)
        want = [1.0] * 4
    elif op == "reduce":
        dist.reduce(x, 0)
        want = [3.0] * 4 if rank == 0 else x.tolist()
    elif op == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        x, want = out, [1.0] * 4 + [2.0] * 4
    elif op == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        x, want = out, [3.0] * 2
    elif op == "send_recv":
        if rank == 0:
            dist.send(x, 1)
            want = x.tolist()
        else:
            dist.recv(x, 0)
            want = [1.0] * 4
    elif op == "batch_isend_irecv":
        got = torch.empty(4, device=dev)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                         dist.P2POp(dist.irecv, got, 1 - rank)]):
            w.wait()
        x, want = got, [float(2 - rank)] * 4
    else:
        dist.barrier()
        want = x.tolist()
    return x.tolist() == want   # tolist() waits for the card


def main() -> int:
    import torch
    from repro_torch import distributed as D
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    for op in OPS:
        try:
            ok = all(D.spawn(probe, 2, op, device="cuda", timeout=30))
            print(f"{op}: {'takes CUDA tensors' if ok else 'runs, but the result is wrong'}")
        except RuntimeError as e:
            last = [ln for ln in str(e).splitlines() if ln.strip()][-1]
            print(f"{op}: refused: {last[:160]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
