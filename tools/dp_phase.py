#!/usr/bin/env python3
"""Phases 15 and 17 of chip_smoke.py alone, with 12d and 17d, in their one
spawn of ranks: FSDP and expert parallelism over the "data" axis, then
Adafactor and checkpoints, on the cards present.

    PYTHONPATH=src python3 tools/dp_phase.py [--seed N]

Builds the kernels, writes the dry-run's meta accounts of 15b's and 17a's
rank 0 (`chip_smoke.meta_account_main`), then runs `chip_smoke.dp_phase` (15a
phi3.5-moe x 2 layers on a (2, 2) mesh with EP, expert-TP and ZeRO-2; 15b
qwen1.5-32b x 2 with FSDP, TP and ZeRO-2, each against one process's steps;
15c decode on (2, 2) of both; 17a and 17b the same two with Adafactor, each
against one process's steps and its rounding floor; 17c 17a's state saved
from the ranks and restored into one process and into the ranks; 12d and
17d the meta accounts against 15b's and 17a's ranks on the card; 15d the
kernels at a rank's shapes) with its gates. On one card the ranks share it
over gloo; with a card a rank (four) they run over NCCL.
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
    ap.add_argument("--seed", type=int, default=18)
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("dp_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    t0 = time.perf_counter()
    build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    C.meta_account_main(C.DP_ACCOUNT_FILE)
    C.meta_account_main(C.AF_ACCOUNT_FILE, run="17a")
    print(f"12d's and 17d's meta accounts in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = C.dp_phase(args.seed, dev, smi, gen)
    print({k: v for k, v in out.items() if k not in ("kernels",)}, flush=True)
    print(f"phases 15 and 17: {time.perf_counter() - t0:.1f} s wall", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
