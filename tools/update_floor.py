#!/usr/bin/env python3
"""The rounding floor of the ranks' update gate: how far two single-process
bf16 training runs move apart when only the order of their sums differs.

    PYTHONPATH=src python3 tools/update_floor.py [--arch zamba2-2.7b] [--layers 6]
        [--seq 1024] [--steps 2] [--seed 19]

Trains `--layers` layers of the arch at published width, as chip_smoke.py's
phases 14-16 train a single process (dp_run: AdamW at DP_LR, 4 x seq
TokenPipeline tokens in 2 microbatches, whisper with its stub frames), once
on the CUDA kernels and once on their plain PyTorch versions
(`chip_smoke.plain_kernels`), from the same seed, and prints the params'
distance between the two runs over the update (the quantity phases 14-16
gate at DP_UPDATE_TOL between a rank and the single process), with the
leaves that carry most of it, and each run's losses and grad norms.
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
    cfg = get_config(args.arch).replace(n_layers=args.layers)
    runs = {}
    for name in ("kernels", "plain"):
        with (C.plain_kernels() if name == "plain" else C.contextlib.nullcontext()):
            state, r = C.dp_run(cfg, args.seed, dev, args.steps, 2, 4, args.seq)
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
    print(f"[{smi}] {cfg.name} x {cfg.n_layers}, {args.steps} steps of 4 x {args.seq}: the "
          f"kernel run's params against the plain run's, over the update: "
          f"{(sq / upd) ** 0.5:.3e} (update {upd ** 0.5:.3f})", flush=True)
    for k, d, u in sorted(by_leaf, key=lambda t: -t[1])[:5]:
        print(f"  {k}: {d / sq * 100:.0f}% of the distance, {(d / u) ** 0.5:.3f} of its update")
    for name, (_, r) in runs.items():
        print(f"  {name}: losses {r['losses']}, grad norms {r['norms']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
