"""One rank of the port's training or serving job on a cluster node, the
per-rank entry that the `rank_<id>.sh` of `backends/slurm_gpu.py` and of
`backends/kubernetes_gpu.py` starts on every card of an allocation:

    python3 -m repro_torch.launch.rank --rendezvous DIR --cluster-id ID \\
        --job-id JOB --rank R --world N --local-rank L \\
        [--arch llama3-8b] [--layers K] [--mesh 2x4] [--optimizer adafactor] \\
        [--steps S] [--device cuda]

Every rank runs the same job (SPMD, as every TPU host runs the same JAX
program): it joins the process group (`distributed.init_rank`, at a store
in the shared directory named by cluster and `--job-id`, which the rendered
script makes of what names one launch, Slurm's job, step and restart or
the Kubernetes Job's UID, so a stale store of a killed launch never joins
a new group), lays the ranks out as a mesh over ("data", "model"), or
("pod", "data", "model") for a three-part `--mesh`, row-major over the
global ranks, so with node-major ranks the last axis stays inside a node;
builds `--arch` on that mesh (`--layers` cuts depth only) and trains it
with the port's Trainer and `--optimizer` (default: the config's, AdamW or
Adafactor), checkpointing to `DIR/ckpt/ID`, restoring from there where a
checkpoint exists. On SIGTERM the ranks agree on a step, save it and stop:
the rank exits EXIT_PREEMPTED (75), and a relaunch resumes from that step.

The device is the card (`cuda:(local rank % cards)`) unless `--device cpu`
is asked for; without a card a CUDA run raises. Each rank prints one JSON
line when it stops: its backend, store, device and mesh, the step it
started and stopped at, each step's loss, grad norm and wall ms, its peak
card memory, its kernels' launches, and the seconds it took to join the
group, to build and restore the state, and to train (with the checkpoints).

With `--serve` the ranks serve instead (`launch/serve.py`): a replica a
row of the `--mesh DxM`, the router on rank 0, `--requests` in (each at
its `arrival_s`) and `--outputs` out, the rows autoscaled with
`--autoscale`; SIGTERM retires a replica, whose ranks exit 75.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from repro_torch.backends.slurm_gpu import EXIT_PREEMPTED

SEED = 0
N_MICRO = 2
TIMEOUT_S = 1800.0   # the store's and every collective's


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.rank",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--rendezvous", required=True, help="the allocation's shared directory")
    ap.add_argument("--cluster-id", required=True)
    ap.add_argument("--job-id", required=True, help="names the job's store")
    ap.add_argument("--rank", type=int, required=True, help="global rank, node-major")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--local-rank", type=int, required=True, help="the rank on its node")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true", help="the arch's SMOKE config")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this (0: the "
                                                          "config's)")
    ap.add_argument("--param-dtype", choices=("bfloat16", "float32"), default=None,
                    help="the params' dtype (default: the config's)")
    ap.add_argument("--mesh", default=None,
                    help="DxM over (data, model) or PxDxM over (pod, data, model); "
                         "default: <world>x1")
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"), default=None,
                    help="the optimizer (default: the config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch, rows")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=10, help="steps of learning-rate warmup")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) or cpu; cuda without a card raises")
    serve = ap.add_argument_group("serving (launch/serve.py)")
    serve.add_argument("--serve", action="store_true",
                       help="serve --requests instead of training: a replica a row of the mesh, "
                            "the router on rank 0")
    serve.add_argument("--requests", help="JSONL: id, prompt, max_new_tokens, eos_id, arrival_s "
                                          "(seconds after the router's start, default 0)")
    serve.add_argument("--outputs", help="JSONL written by rank 0: id, replica, tick, output")
    serve.add_argument("--slots", type=int, default=4, help="a replica's decode slots")
    serve.add_argument("--max-len", type=int, default=1024, help="a slot's cache positions")
    serve.add_argument("--queue", type=int, default=8, help="the router's queue a replica")
    serve.add_argument("--replica-timeout", type=float, default=600.0,
                       help="seconds rank 0 waits for a replica's reply before failing it")
    serve.add_argument("--p99-window", type=int, default=512,
                       help="completions in the router's p99 latency")
    serve.add_argument("--autoscale", default=None, metavar="JSON",
                       help="ReplicaScalingConfig's fields: the mesh's rows are the allocation, "
                            "and the router serves through min_replicas to max_replicas of them "
                            "(at most the rows), grown and shrunk on its p99 and queue depth")
    return ap


def mesh_of(spec: Optional[str], world: int):
    """(shape, axis names) of a `--mesh` spec."""
    shape = tuple(int(n) for n in (spec or f"{world}x1").split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None:
        raise ValueError(f"--mesh {spec!r}: want DxM or PxDxM")
    return shape, axes


def job_config(args):
    """The model config of the job: `--arch` (its SMOKE config with
    `--smoke`), `--layers` deep, in `--param-dtype`."""
    from repro_torch.configs import get_config
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.param_dtype:
        cfg = cfg.replace(param_dtype=args.param_dtype)
    return cfg


def make_trainer(args, dev, mesh, ckpt_dir: str):
    """The job's Trainer on `mesh` (None: one process) and device `dev`."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = job_config(args)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                    global_batch=args.batch, seed=SEED))
    return Trainer(build_model(cfg, device=dev, mesh=mesh),
                   make_optimizer(args.optimizer or cfg.optimizer), pipe,
                   Checkpointer(ckpt_dir),
                   TrainerConfig(num_steps=args.steps, ckpt_every=args.ckpt_every, log_every=1,
                                 n_microbatches=N_MICRO, warmup=args.warmup))


def launches() -> dict:
    """The kernels' launches in this process, by wrapper; flash's with the
    lse and by kernel, decode's by kernel."""
    from repro_torch.kernels import decode_attention, flash_attention, moe_gmm, ssm_scan
    return {"flash_attention": flash_attention.launches,
            "flash_lse": flash_attention.lse_launches,
            "flash_by_path": dict(flash_attention.launches_by_path),
            "decode_attention": decode_attention.launches,
            "decode_by_path": dict(decode_attention.launches_by_path), "moe_gmm": moe_gmm.launches,
            "moe_gmm_dx": moe_gmm.dx_launches, "moe_gmm_dw": moe_gmm.dw_launches,
            "ssm_scan": ssm_scan.launches}


def main(argv: Optional[List[str]] = None) -> int:
    entered = time.time()
    ap = parser()
    args = ap.parse_args(argv)
    if args.serve and not (args.requests and args.outputs):
        ap.error("--serve needs --requests and --outputs")
    shape, axes = mesh_of(args.mesh, args.world)
    import torch
    import torch.distributed as dist
    from repro_torch import distributed as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Preempted
    store = os.path.join(args.rendezvous, "rdv", "torch", f"{args.cluster_id}-{args.job_id}")
    dev = D.init_rank(args.rank, args.world, args.local_rank, args.device, store, TIMEOUT_S)
    clock = {"joined": time.time()}
    try:
        if args.serve:
            from repro_torch.launch.serve import serve_rank
            return serve_rank(args, dev, store, entered, clock["joined"])
        mesh = make_mesh(shape, axes, device=dev)
        trainer = make_trainer(args, dev, mesh,
                               os.path.join(args.rendezvous, "ckpt", args.cluster_id))
        trainer.install_signal_handler()
        state = trainer.init_or_restore(SEED)
        start = int(state["step"])
        clock["ready"] = time.time()
        print(f"rank {args.rank} of {args.world} on {dev} ({dist.get_backend()}), mesh "
              f"{shape} over {axes}, {args.arch}, from step {start}", file=sys.stderr,
              flush=True)
        try:
            trainer.run(state)
            stopped, code = args.steps, 0
        except Preempted as e:
            stopped, code = e.step, EXIT_PREEMPTED
        clock["trained"] = time.time()
        del state
        walls = [0.0] + [h["wall_s"] for h in trainer.history]
        print(json.dumps({
            "rank": args.rank, "world": args.world, "backend": dist.get_backend(),
            "store": store, "device": str(dev), "mesh": list(shape), "start": start,
            "stopped": stopped, "preempted": code == EXIT_PREEMPTED,
            "history": [{"step": h["step"], "loss": h["loss"], "grad_norm": h["grad_norm"],
                         "ms": (walls[i + 1] - walls[i]) * 1e3}
                        for i, h in enumerate(trainer.history)],
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
            "launches": launches(), "entered": entered,
            "seconds": {"join": clock["joined"] - entered, "build": clock["ready"] - clock["joined"],
                        "train": clock["trained"] - clock["ready"]}}), flush=True)
        return code
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
