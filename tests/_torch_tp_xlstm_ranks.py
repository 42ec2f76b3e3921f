"""Rank bodies for tests/test_torch_tp_xlstm.py: each runs on every rank that
`repro_torch.distributed.spawn` starts (gloo on the CPU) and returns numpy
values, gathered by rank. Training runs through tests/_torch_tp_ranks.py's
`train_rank`. Imports no JAX."""
from __future__ import annotations

import os

import torch

from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import flatten

import _torch_tp_hybrid_ranks as HR
import _torch_tp_ranks as R

# the Trainer's run: 3 steps of 4 x 16 tokens from DataConfig seed 5, a
# checkpoint every 2, 2 microbatches, warmup_cosine(1e-2, 1, 3)
TRAINER = dict(num_steps=3, ckpt_every=2, log_every=1, n_microbatches=2, base_lr=1e-2, warmup=1)
DATA = dict(seq_len=16, global_batch=4, seed=5)


def plan_of(tp) -> dict:
    """The xLSTM part of a rank's plan, as lists and flags."""
    def sl(s):
        return None if s is None else [s.start, s.stop]
    return {"xl_heads": sl(tp.xl_heads), "xl_channels": sl(tp.xl_channels),
            "gather_ff": tp.gather_ff, "vocab_rows": sl(tp.vocab_rows)}


def serve_rank(rank, world, dev, cases):
    """Each case {"shape" (the mesh), "params" (JAX's, numpy), "batch", "S",
    "steps"} of xlstm SMOKE served by this rank on its data group's rows:
    the prefill's logits and (empty) states, each decode step's logits and
    the final states, its rows and its plan."""
    out = {}
    for name, c in cases.items():
        cfg = R.smoke_cfg("xlstm-350m")
        mesh = make_mesh(c["shape"], ("data", "model"), device=dev)
        model = build_model(cfg, device=dev, mesh=mesh)
        params = bridge.shard_params(bridge.params_from_jax(c["params"], dev), cfg, mesh, rank)
        rows = HR._rows(mesh, c["batch"]["tokens"].shape[0])
        res = dict(zip(("prefill", "prefill_cache", "decode", "cache"),
                       HR.serve(model, params, {k: v[rows] for k, v in c["batch"].items()},
                                c["S"], [t[rows] for t in c["steps"]])))
        res["rows"] = [rows.start, rows.stop]
        res["plan"] = plan_of(model.tp)
        out[name] = res
    return out


def trainer_rank(rank, world, dev, shape, root):
    """xlstm SMOKE (fp32, AdamW) trained by the Trainer on a `shape` mesh
    from the step-0 checkpoint in `root`/straight and `root`/crashed (the
    same state, one written in each): straight through 3 steps, and crashed
    at step 2 (after step 2's checkpoint committed) and restarted by a fresh
    Trainer. Whether the two final states are bit-identical, the step the
    restart began at, and how many leaves the rank holds a block of."""
    cfg = R.smoke_cfg("xlstm-350m")
    mesh = make_mesh(shape, ("data", "model"), device=dev)

    class Crash(Exception):
        pass

    def trainer(directory, crash_at=None):
        def hook(step):
            if step == crash_at:
                raise Crash(step)
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, **DATA))
        return Trainer(build_model(cfg, device=dev, mesh=mesh), make_optimizer("adamw"), pipe,
                       Checkpointer(directory), TrainerConfig(**TRAINER), failure_hook=hook)

    t = trainer(os.path.join(root, "straight"))
    straight = t.run(t.init_or_restore(0))
    t = trainer(os.path.join(root, "crashed"), crash_at=2)
    try:
        t.run(t.init_or_restore(0))
        raise AssertionError("the injected crash did not happen")
    except Crash:
        t.ckpt.wait()
    t = trainer(os.path.join(root, "crashed"))
    state = t.init_or_restore(0)
    start = int(state["step"])
    resumed = t.run(state)
    return {"equal": all(torch.equal(a, b) for (_, a), (_, b) in
                         zip(flatten(straight), flatten(resumed))),
            "start": start,
            "split": sum(1 for (p, v) in flatten(straight["params"])
                         if tuple(v.shape) != t.shardings.full_shape(("params",) + p))}


def world_rank(rank, world, dev, jobs):
    """Every job (a rank body's name and its arguments) on this rank, in
    order: one spawn serves a world size."""
    bodies = {"serve_rank": serve_rank, "train_rank": R.train_rank,
              "trainer_rank": trainer_rank}
    return {name: bodies[fn](rank, world, dev, *args) for name, (fn, args) in jobs.items()}
