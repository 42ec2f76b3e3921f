#!/usr/bin/env python3
"""Phases 3a-3d, 4, 6 and 7 of chip_smoke.py for several trees of this
repository, one after the other on one card, so that their times compare.

    python3 tools/chip_ab.py TREE [TREE ...]     # e.g. parent change change parent

Each TREE is the root of a checkout (an unpacked `git archive`, say). Each
runs in a process of its own, with its own `chip_smoke.py`, its own kernel
sources and its own build directory: the kernels are built (phase 2), then
the attention kernels are checked and timed at llama3-8b's, zamba2's and
stablelm-12b's widths (phases 3a-3c and 3a'-3b'), the grouped expert matmul
too (phase 3d), llama3-8b is served at its published width and depth
(phase 4), phi3.5-moe at its published width and 16 layers (phase 6), and
zamba2-2.7b prefills and decodes at its published width and depth (phase
7), with the arguments `chip_smoke.py` gives them. Needs a CUDA device;
exits non-zero if any tree fails.
"""
from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path


def run_tree(root: Path, seed: int) -> int:
    """Phases 2, 3a-3d, 4, 6 and 7 of the chip_smoke.py at `root`, in this
    process."""
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)   # puts root/src first on sys.path
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"== tree {root}: {smi}", flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"  built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for phase in (smoke.kernel_phase, smoke.head_dim_phase, smoke.gmm_phase):
        phase(gen, dev)
        torch.cuda.empty_cache()
    smoke.serve_phase(get_config("llama3-8b"), seed, n_requests=16, batch_slots=8,
                      max_len=2048, new_tokens=32, prompt_range=(16, 1024), dev=dev,
                      label="llama3-8b")
    torch.cuda.empty_cache()
    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=16)
    smoke.serve_phase(cfg, seed + 2, n_requests=16, batch_slots=8, max_len=2048,
                      new_tokens=32, prompt_range=(16, 1024), dev=dev,
                      label="phi3.5-moe, 16 layers", gate_layers=4)
    torch.cuda.empty_cache()
    smoke.hybrid_phase(get_config("zamba2-2.7b"), seed + 3, batch=4, prompt_len=1024,
                       new_tokens=32, dev=dev)
    print(f"== tree {root}: done", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return run_tree(args.trees[0].resolve(), args.seed)
    rc = 0
    for tree in args.trees:
        out = subprocess.run([sys.executable, __file__, "--one", "--seed", str(args.seed),
                              str(tree)])
        if out.returncode:
            print(f"chip_ab: tree {tree} failed (exit {out.returncode})", file=sys.stderr)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
