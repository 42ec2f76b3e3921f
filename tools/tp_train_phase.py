#!/usr/bin/env python3
"""Phase 14 of chip_smoke.py alone: tensor-parallel training on the cards present.

    PYTHONPATH=src python3 tools/tp_train_phase.py [--seed N]

Builds the kernels, then runs `chip_smoke.tp_train_phase` (14a llama3-8b
x 4 layers on a (1, 4) mesh, 14b phi3.5-moe x 2 on (1, 2), 14c llama3-8b
x 2 on (2, 2) with ZeRO-2, each against one process's steps; 14d the
kernels at a rank's training shapes) with its gates. On one card the ranks
share it over gloo; with a card a rank (e.g. four) they run over NCCL.
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
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("tp_train_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = C.tp_train_phase(args.seed, dev, smi, gen)
    print({k: v for k, v in out.items() if k not in ("kernels",)}, flush=True)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s wall", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
