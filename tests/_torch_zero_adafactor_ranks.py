"""Rank bodies for tests/test_torch_zero_adafactor.py: each runs on every
rank that `repro_torch.distributed.spawn` starts (gloo on the CPU) and
returns numpy values, gathered by rank. The training cases run through
tests/_torch_tp_ranks.py's `train_rank`."""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding.axes import rules_for
from repro_torch.sharding.rules import shardings_for, state_shardings
from repro_torch.train.steps import make_train_step, train_state
from repro_torch.tree import flatten, leaves

from _torch_tp_ranks import smoke_cfg, train_rank  # noqa: F401  (a job of world_rank)

LR = 1e-2


def world_rank(rank, world, dev, jobs):
    """Every job (a rank body's name here and its arguments) on this rank,
    in order: one spawn serves the module's cases of a world size."""
    return {name: globals()[fn](rank, world, dev, *args) for name, (fn, args) in jobs.items()}


def case_cfg(c):
    """The SMOKE config of a checkpoint case {"arch", "fsdp", "opt"}, fp32."""
    return smoke_cfg(c["arch"]).replace(fsdp=c["fsdp"], optimizer=c["opt"])


def whole_state(cfg, dev, seed=3):
    """A whole train state at step 0 from `seed` (alike on every rank)."""
    params = build_model(cfg, device=dev).init_params(torch.Generator(device=dev)
                                                      .manual_seed(seed))
    return train_state(params, make_optimizer(cfg.optimizer))


def on_mesh(cfg, shape, zero, dev):
    """The model on a `shape` mesh over ("data", "model"), its train step
    (ZeRO-2 with `zero`) at a constant LR in 2 microbatches, and the train
    state's shardings."""
    mesh = make_mesh(shape, ("data", "model"), device=dev)
    model = build_model(cfg, device=dev, mesh=mesh)
    opt = make_optimizer(cfg.optimizer)
    meta = build_model(cfg, device="meta").init_params(torch.Generator())
    rules = rules_for(mesh)
    gsh = shardings_for(meta, cfg, mesh, rules, zero1=True) if zero else None
    ssh = state_shardings(train_state(meta, opt), cfg, mesh, rules, gsh)
    step = make_train_step(model, opt, lambda s: torch.tensor(LR), n_microbatches=2,
                           grad_shardings=gsh, mesh=mesh)
    return mesh, gsh, ssh, step


def blocks(state):
    """Copies of a tree's leaves (fp32 and int32 here), by path."""
    return {"/".join(map(str, p)): t.detach().cpu().numpy().copy() for p, t in flatten(state)}


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def ckpt_rank(rank, world, dev, cases, root):
    """Each case {"arch", "fsdp", "opt", "shape", "zero", "other",
    "other_zero", "batches"}: from a whole state drawn from a seed, one step
    on the case's mesh, a sharded save of step 1, a second step (the
    straight run); the save restored on the same mesh and stepped again
    (the resumed run); then restored on the `other` mesh shape, against the
    rank's cut of the checkpoint restored whole, and one step from each."""
    out = {}
    for name, c in cases.items():
        cfg = case_cfg(c)
        whole0 = whole_state(cfg, dev)
        b1, b2 = ({k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in c["batches"])
        mesh, gsh, ssh, step = on_mesh(cfg, c["shape"], c["zero"], dev)
        state = bridge.shard_train_state(whole0, cfg, mesh, rank, gsh)
        state, _ = step(state, b1)
        directory = os.path.join(root, name)
        ck = Checkpointer(directory)
        ck.save(1, state, blocking=True, shardings=ssh)
        res = {"saved": blocks(state)}
        state, _ = step(state, b2)
        res["straight"] = blocks(state)
        like = bridge.shard_train_state(whole0, cfg, mesh, rank, gsh)
        ck.restore(like, step=1, shardings=ssh)
        res["restored"] = blocks(like)
        like, _ = step(like, b2)
        res["resumed"] = blocks(like)
        # another mesh shape: the rank's blocks read from the checkpoint, and
        # its cut of the checkpoint read whole; one step from each
        mesh2, gsh2, ssh2, step2 = on_mesh(cfg, c["other"], c["other_zero"], dev)
        mine = bridge.shard_train_state(whole0, cfg, mesh2, rank, gsh2)
        ck.restore(mine, step=1, shardings=ssh2)
        read = Checkpointer(directory).restore(whole_state(cfg, dev), step=1)
        cut = bridge.shard_train_state(read, cfg, mesh2, rank, gsh2)
        res["other_restored"] = same(mine, cut) and len(leaves(mine)) == len(leaves(cut))
        a, _ = step2(mine, b2)
        b, _ = step2(cut, b2)
        res["other_step"] = same(a, b)
        res["other_held"] = sum(t.numel() for t in leaves(a["opt"]))
        out[name] = res
    return out


def trainer_crash_rank(rank, world, dev, cases, root):
    """Each case {"arch", "fsdp", "opt", "shape"} (SMOKE, fp32)
    trained 3 steps by the Trainer on its mesh (a checkpoint every 2):
    straight, and crashed at step 2 (after step 2's checkpoint committed)
    and restarted by a fresh Trainer. Whether the two final states are
    bit-identical, the step the restart began at, and how many optimizer
    leaves the rank holds blocks of."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.train.trainer import Trainer, TrainerConfig

    class Crash(Exception):
        pass

    out = {}
    for name, c in cases.items():
        cfg = case_cfg(c)
        mesh = make_mesh(c["shape"], ("data", "model"), device=dev)

        def trainer(directory, crash_at=None):
            def hook(step):
                if step == crash_at:
                    raise Crash(step)
            pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                            global_batch=4, seed=5))
            return Trainer(build_model(cfg, device=dev, mesh=mesh),
                           make_optimizer(cfg.optimizer), pipe, Checkpointer(directory),
                           TrainerConfig(num_steps=3, ckpt_every=2, log_every=1,
                                         n_microbatches=2, base_lr=1e-2, warmup=1),
                           failure_hook=hook)

        directory = os.path.join(root, name)
        t = trainer(os.path.join(directory, "straight"))
        straight = t.run(t.init_or_restore(5))
        t = trainer(os.path.join(directory, "crashed"), crash_at=2)
        try:
            t.run(t.init_or_restore(5))
            raise AssertionError("the injected crash did not happen")
        except Crash:
            t.ckpt.wait()
        t = trainer(os.path.join(directory, "crashed"))
        state = t.init_or_restore(5)
        start = int(state["step"])
        resumed = t.run(state)
        out[name] = {"equal": same(straight, resumed), "start": start,
                     "cut": sum(1 for (p, v), b in zip(flatten(straight), t.shardings.index(
                         straight, rank)) if p[0] == "opt" and b is not None
                         and tuple(v.shape) != t.shardings.full_shape(p))}
    return out


def one_process(c, directory, batch):
    """The checkpoint at `directory` (step 1) of case `c` restored into one
    process, and one single-device step from it: (the state read, by path;
    the step's result, by path)."""
    cfg = case_cfg(c)
    state = Checkpointer(directory).restore(whole_state(cfg, "cpu"), step=1)
    read = blocks(state)
    step = make_train_step(build_model(cfg, device="cpu"), make_optimizer(cfg.optimizer),
                           lambda s: torch.tensor(LR), n_microbatches=2)
    state, _ = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    return read, blocks(state)
