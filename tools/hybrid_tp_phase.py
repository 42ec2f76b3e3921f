#!/usr/bin/env python3
"""Phase 16 of chip_smoke.py alone: tensor parallelism of the hybrid (zamba2)
and whisper over the "model" axis, on the cards present.

    PYTHONPATH=src python3 tools/hybrid_tp_phase.py [--seed N]

Builds the kernels, then runs `chip_smoke.hybrid_tp_phase` (16a zamba2-2.7b
x 12 of 54 layers serving 4 x 1024 tokens and 8 decode steps on 4 ranks;
16b zamba2-2.7b x 6 trained 2 steps; 16c whisper-tiny served and trained;
16d the SSD scan, flash and decode at a rank's shapes) with its gates, and
prints the ranks' launches and the phase's wall time. On one card the ranks
share it over gloo; with a card a rank (four) they run over NCCL.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=19)
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("hybrid_tp_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    t0 = time.perf_counter()
    build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = C.hybrid_tp_phase(args.seed, dev, smi, gen)
    kernels = out.pop("kernels")
    print({k: v for k, v in out.items() if not isinstance(v, dict) or k.endswith("_by_path")},
          flush=True)
    print({name: [{k: r.get(k, r.get("path")) for k in ("shape", "kernel", "ms", "plain_ms",
                                                         "bound_ms", "library_ms", "max_abs_err")}
                  for r in rows] for name, rows in kernels.items()}, flush=True)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s wall", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
