#!/usr/bin/env python3
"""The rounding floor of the ranks' update gate: how far two single-process
bf16 training runs move apart when only the order of their sums differs.

    PYTHONPATH=src python3 tools/update_floor.py [--arch zamba2-2.7b] [--layers 6]
        [--seq 1024] [--steps 2] [--seed 19] [--optimizer adamw] [--groups 1]
    PYTHONPATH=src python3 tools/update_floor.py --arch phi3.5-moe-42b-a6.6b --layers 2 \
        --optimizer adafactor --groups 2      # 17a's config
    PYTHONPATH=src python3 tools/update_floor.py --arch qwen1.5-32b --layers 2 \
        --optimizer adafactor                 # 17b's

Trains `--layers` layers of the arch at published width, as chip_smoke.py's
phases 14-17 train a single process (dp_run: the optimizer at its
`train_lr`, DP_LR for AdamW and AF_LR for Adafactor, 4 x seq TokenPipeline
tokens in 2 microbatches, whisper with its stub frames,
an MoE's tokens in `--groups` dispatch groups), once on the CUDA kernels
and once on their plain PyTorch versions (`chip_smoke.plain_kernels`; an
MoE's second run replaying the first's routing, so that only the order of
sums differs), from the same seed, and prints the params' distance between
the two runs over the update (the quantity phases 14-17 gate at
DP_UPDATE_TOL between a rank and the single process), with the leaves that
carry most of it, and each run's losses and grad norms.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "adafactor"))
    ap.add_argument("--groups", type=int, default=1, help="an MoE's dispatch groups")
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.tree import flatten, leaves, tree_map
    if not torch.cuda.is_available():
        print("update_floor: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = get_config(args.arch).replace(n_layers=args.layers, optimizer=args.optimizer)
    runs, routing = {}, []
    for name in ("kernels", "plain"):
        with (C.plain_kernels() if name == "plain" else C.contextlib.nullcontext()), \
                C.routed_as(routing, replay=name == "plain"):
            state, r = C.dp_run(cfg, args.seed, dev, args.steps, 2, 4, args.seq,
                                n_groups=args.groups)
        runs[name] = (tree_map(lambda t: t.float().cpu(), state["params"]), r)
        del state
        torch.cuda.empty_cache()
    p0 = build_model(cfg, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(args.seed))
    sq = upd = 0.0
    by_leaf = []
    for (path, a), b, first in zip(flatten(runs["kernels"][0]), leaves(runs["plain"][0]),
                                   leaves(p0)):
        d = float(torch.sum(torch.square(a - b)))
        u = float(torch.sum(torch.square(a - first.float().cpu())))
        sq, upd = sq + d, upd + u
        by_leaf.append(("/".join(map(str, path)), d, u))
    print(f"[{smi}] {cfg.name} x {cfg.n_layers} ({cfg.optimizer}), {args.steps} steps of 4 x "
          f"{args.seq}: the "
          f"kernel run's params against the plain run's, over the update: "
          f"{(sq / upd) ** 0.5:.3e} (update {upd ** 0.5:.3f})", flush=True)
    for k, d, u in sorted(by_leaf, key=lambda t: -t[1])[:5]:
        print(f"  {k}: {d / sq * 100:.0f}% of the distance, {(d / u) ** 0.5:.3f} of its update")
    for name, (_, r) in runs.items():
        print(f"  {name}: losses {r['losses']}, grad norms {r['norms']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
