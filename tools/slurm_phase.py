#!/usr/bin/env python3
"""Phase 18 of chip_smoke.py alone: the Slurm and Kubernetes GPU backends'
rendered `rank_<id>.sh` run as each node would run it, on the card present.

    PYTHONPATH=src python3 tools/slurm_phase.py

Builds the kernels, then runs `chip_smoke.cluster_phase`: 18a one node x one
card (the store decides NCCL), llama3-8b at full width and 1 of 32 layers
trained 2 steps, its flash launches exact and all `flash_wgmma` with the
lse; 18b two nodes x one card on this one card (the store decides gloo),
llama3-8b SMOKE on (2, 1) with ZeRO-2, one rank sent SIGTERM, both
stopping at one step, relaunched and held to one process's run; 18c the
Kubernetes indexed Job's pod script of one node x one card on 18a's job,
held as 18a is; 18d two nodes x one card on this card serving llama3-8b at
full width and 2 layers on 2x1 behind rank 0's router, one rank sent
SIGTERM, held to this process's replay of rank 0's run; 18e three nodes x
one card on this card serving the same model on 3x1 with its rows
autoscaled, 36 requests arriving open loop, held to the replay of rank 0's
run with its offer ticks and scaling decisions.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    import chip_smoke as C
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("slurm_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    C.say(smi)
    t0 = time.perf_counter()
    build.build()
    C.say(f"  built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = C.cluster_phase(torch.device("cuda"), smi)
    C.say(f"  [phase 18: {time.perf_counter() - t0:.1f} s wall]")
    C.say({k: v for k, v in out.items() if k in ("18a", "18b", "18c", "18d", "18e")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
