#!/usr/bin/env python3
"""Phase 13 of chip_smoke.py alone: tensor-parallel serving on the cards present.

    PYTHONPATH=src python3 tools/tp_phase.py [--seed N]

Builds the kernels, then runs `chip_smoke.tp_serving_phase` (13a llama3-8b
on 4 ranks and 13b phi3.5-moe x 8 on 2 through the engine, 13c qwen1.5-32b
x 16 on 4 through the model interface, 13d the kernels at the ranks'
shapes) with its gates, and prints the ranks' launches. On one card the
ranks share it over gloo; with a card a rank (e.g. four) they run over
NCCL. Phase 13a's greedy outputs are compared with phase 4's only in the
whole chip_smoke.py run.
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("tp_phase: needs an NVIDIA GPU", file=sys.stderr)
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
    out = C.tp_serving_phase(args.seed, dev, smi, gen)
    out.pop("kernels")
    print({k: v for k, v in out.items() if k != "parts"}, flush=True)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s wall", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
