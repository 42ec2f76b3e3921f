#!/usr/bin/env python3
"""Phase 11 of chip_smoke.py alone: the multi-rank paths on the cards present.

    PYTHONPATH=src python3 tools/ranks_phase.py [--seed N]

Builds the kernels, then runs `chip_smoke.ranks_phase` (the int8 ring, the
data-parallel and ZeRO-2 steps, the MoE dispatch groups, the resharded
restore) with its gates, and prints what it returns. On one card the ranks
share it over gloo; with a card a rank (e.g. four) they run over NCCL.
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("ranks_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(C.ranks_phase(args.seed, torch.device("cuda"), smi), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
