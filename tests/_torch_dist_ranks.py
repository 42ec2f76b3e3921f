"""Rank bodies for tests/test_torch_distributed.py and the card tests: each
runs on every rank that `repro_torch.distributed.spawn` starts, imports
nothing of JAX (the spawned ranks import only this module and the port) and
returns numpy values, gathered by rank."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import build_model
from repro_torch.optim.compression import compressed_psum_mean
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding.axes import multi_pod_rules, single_pod_rules
from repro_torch.sharding.rules import (Shardings, model_shardings, placements, shardings_for,
                                       state_shardings)
from repro_torch.train.steps import make_train_step, train_state
from repro_torch.tree import flatten, leaves

LR = 1e-3   # a constant schedule: the reference's warmup_cosine is 0 at step 0


def _np(t):
    return t.detach().float().cpu().numpy()


def compression_rank(rank, world, dev, g_all, steps):
    """compressed_psum_mean of row `rank` of g_all (zero residual), then
    `steps` calls feeding the residual back: (mean, residual, the mean of
    the fed-back means)."""
    g = torch.from_numpy(g_all[rank:rank + 1]).to(dev)
    mean, err = compressed_psum_mean(g, torch.zeros_like(g))
    acc, e = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(steps):
        m, e = compressed_psum_mean(g, e)
        acc += m
    return _np(mean), _np(err), _np(acc / steps)


def pid_sum_rank(rank, world, dev, x):
    """(this process's id, the sum over the ranks of x + rank)."""
    import os
    from repro_torch import distributed as D
    t = torch.tensor([float(x + rank)], device=dev)
    return os.getpid(), float(D.all_reduce_(t)[0])


def raising_rank(rank, world, dev):
    """Rank 1 raises; the others wait at a collective rank 1 never joins."""
    from repro_torch import distributed as D
    if rank == 1:
        raise ValueError("rank 1 raises")
    D.all_reduce_(torch.zeros(1, device=dev))


def ring_collectives_rank(rank, world, dev, x_all):
    """D.reduce_scatter_ and D.all_gather_ (gloo's rings) against gloo's own
    reduce_scatter_tensor and all_gather_into_tensor on rows of x_all, each
    under a CostModel: (ring sum, gloo sum, ring gather, gloo gather, both
    accounts' collectives and by-op rows)."""
    import torch.distributed as dist
    from repro_torch import distributed as D
    from repro_torch.roofline import CostModel
    x = torch.from_numpy(x_all[rank]).to(dev)            # (world * k, m)
    k = x.shape[0] // world
    out = {}
    for name, rs, ag in (
            ("ring", D.reduce_scatter_, D.all_gather_),
            ("gloo", lambda o, i: (dist.reduce_scatter_tensor(o, i), o)[1],
             lambda o, i: (dist.all_gather_into_tensor(o, i), o)[1])):
        with CostModel(dev.type) as cm:
            s = rs(torch.empty(k, x.shape[1], dtype=x.dtype, device=dev), x)
            g = ag(torch.empty_like(x), s)
        out[name] = (_np(s), _np(g), {k_: list(v) for k_, v in cm.totals.collectives.items()},
                     {k_: list(v) for k_, v in cm.by_op.items()}, cm.totals.bytes)
    return out


def smoke_cfg(arch):
    return get_config(arch, smoke=True).replace(param_dtype="float32")


def dp_setup(rank, world, dev, arch, params_np, zero, stack=True):
    """The rank's mesh (world, 1) over ("data", "model"), its model, and a
    train state of the given params: ZeRO-1 state under the ZeRO-2 grad
    shardings with `zero`, else replicated."""
    cfg = smoke_cfg(arch)
    mesh = make_mesh((world, 1), ("data", "model"), device=dev)
    model = build_model(cfg, device=dev, mesh=mesh)
    opt = make_optimizer("adamw")
    params = bridge.params_from_jax(params_np, dev)
    shard = shardings_for(params, cfg, mesh, single_pod_rules(), zero1=True,
                          zero1_stack=stack) if zero else None
    return cfg, mesh, model, opt, shard, train_state(params, opt, shard)


def dp_train_rank(rank, world, dev, arch, params_np, batches, n_micro, zero):
    """`len(batches)` steps of the data-parallel step (ZeRO-2 with `zero`) on
    the global batches: the final params (stacked, numpy), each step's loss
    and grad norm, and the entries of this rank's accumulator and AdamW
    moments against the whole."""
    cfg, mesh, model, opt, shard, state = dp_setup(rank, world, dev, arch, params_np, zero)
    step = make_train_step(model, opt, lambda s: LR, n_microbatches=n_micro,
                           grad_shardings=shard, mesh=mesh)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = sum(p.numel() for p in leaves(state["params"]))
    held = sum(t.numel() for t in leaves(state["opt"]["m"]))
    return {"params": bridge.params_to_numpy(state["params"]), "losses": losses,
            "norms": norms, "held": held, "whole": whole}


def moe_loss_rank(rank, world, dev, arch, params_np, batch, global_aux):
    """The rank's loss, aux loss and gradients on its contiguous share of
    `batch` with n_groups=1, the aux loss's means over the group (or, with
    `global_aux` False, the rank's own). With the group the experts split
    over the ranks (EP): a rank's gradient of its experts comes summed over
    the ranks, and is handed back as the whole leaf's shape with its block
    in place and zeros elsewhere, so that the mean over the ranks is the
    mean of their gradients, as for the other leaves."""
    cfg = smoke_cfg(arch)
    mesh = make_mesh((world, 1), ("data", "model"), device=dev)
    model = build_model(cfg, device=dev, mesh=mesh if global_aux else None)
    params = bridge.params_from_jax(params_np, dev)
    sh = None
    if global_aux:
        sh = model_shardings(params, cfg, mesh, single_pod_rules())
        params = sh.take(params, rank)
    rows = batch["tokens"].shape[0] // world
    mine = {k: torch.from_numpy(v[rank * rows:(rank + 1) * rows]).to(dev)
            for k, v in batch.items()}
    live = {k: v for k, v in params.items()}
    for t in leaves(live):
        t.requires_grad_()
    loss, metrics = model.loss(live, mine)
    grads = [_np(g) for g in torch.autograd.grad(loss, leaves(live))]
    if sh is not None:
        for j, (path, g) in enumerate(zip([p for p, _ in flatten(live)], grads)):
            b = sh.block_of(path, rank)
            if g.shape != sh.full_shape(path):
                whole = np.zeros(sh.full_shape(path), dtype=g.dtype)
                whole[b] = g
                grads[j] = whole
    return {"loss": float(loss), "aux": float(metrics["aux"]), "grads": grads}


def masked_loss_rank(rank, world, dev, arch, params_np, batch):
    """The rank's loss on its contiguous share of a batch with a
    `loss_mask`, under the data-parallel group."""
    mesh = make_mesh((world, 1), ("data", "model"), device=dev)
    model = build_model(smoke_cfg(arch), device=dev, mesh=mesh)
    rows = batch["tokens"].shape[0] // world
    mine = {k: torch.from_numpy(v[rank * rows:(rank + 1) * rows]).to(dev)
            for k, v in batch.items()}
    with torch.no_grad():
        return float(model.loss(bridge.params_from_jax(params_np, dev), mine)[0])


def parity_rank(rank, world, dev, llama_np, batches, n_micro, phi_np, moe_batch, masked):
    """Everything the W=2 parity test needs from one start of the ranks: the
    plain and ZeRO-2 data-parallel runs, the MoE loss with the global and
    the per-rank aux loss, and masked losses ({arch: (params, batch)})."""
    return {"plain": dp_train_rank(rank, world, dev, "llama3-8b", llama_np, batches,
                                   n_micro, False),
            "zero": dp_train_rank(rank, world, dev, "llama3-8b", llama_np, batches,
                                  n_micro, True),
            "moe": moe_loss_rank(rank, world, dev, "phi3.5-moe-42b-a6.6b", phi_np,
                                 moe_batch, True),
            "moe_per_rank": moe_loss_rank(rank, world, dev, "phi3.5-moe-42b-a6.6b", phi_np,
                                          moe_batch, False),
            "masked": {arch: masked_loss_rank(rank, world, dev, arch, p, b)
                       for arch, (p, b) in masked.items()}}


def multi_pod_rank(rank, world, dev, params_np, batches, n_micro):
    """ZeRO-2 steps of phi3.5-moe SMOKE on a (2, 2, 1) mesh over ("pod",
    "data", "model") with the multi-pod rules, where the experts' blocks
    split two dims (experts over data, EP; d_model over pod, gathered before
    use): the rank's final blocks of the params (numpy, the port's
    structure) and the ways the step moves each leaf."""
    from repro_torch.train.steps import _Layout
    cfg = smoke_cfg("phi3.5-moe-42b-a6.6b")
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device=dev)
    model = build_model(cfg, device=dev, mesh=mesh)
    opt = make_optimizer("adamw")
    whole = bridge.params_from_jax(params_np, dev)
    shard = shardings_for(whole, cfg, mesh, multi_pod_rules(), zero1=True)
    params = bridge.shard_params(whole, cfg, mesh, rank)
    state = train_state(params, opt, shard, model.split)
    step = make_train_step(model, opt, lambda s: LR, n_microbatches=n_micro,
                           grad_shardings=shard, mesh=mesh)
    for b in batches:
        state, _ = step(state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
    own = [model.split.data_cut(p) for p, _ in flatten(state["params"])]
    modes = sorted({m[0] for m, _ in _Layout(state["params"], shard, world, rank,
                                             own=own).modes})
    return {"blocks": [_np(t) for t in leaves(state["params"])], "modes": modes}


def restore_arange_rank(rank, world, dev, directory):
    """Save w = arange(64).reshape(8, 8) split 8 ways on "d" (each rank its
    row), then restore it under a (4, 2) mesh over ("d", "m") as ("m", "d"):
    the rank's block, its slices and its placements."""
    w = np.arange(64.0).reshape(8, 8)
    save = Shardings(make_mesh((8,), ("d",), device=dev), {("w",): (8, 8)}, {("w",): ("d",)})
    ck = Checkpointer(directory)
    mine = save.index({"w": None}, rank)[0]
    ck.save(1, {"w": torch.from_numpy(w[mine]).to(dev)}, blocking=True, shardings=save)
    mesh = Mesh((4, 2), ("d", "m"))
    new = Shardings(mesh, {("w",): (8, 8)}, {("w",): ("m", "d")})
    b = new.index({"w": None}, rank)[0]
    like = {"w": torch.zeros(w[b].shape, dtype=torch.float64, device=dev)}
    ck.restore(like, shardings=new)
    return {"got": _np(like["w"]).astype(np.float64), "rows": (b[0].start, b[0].stop),
            "cols": (b[1].start, b[1].stop),
            "placements": [str(p) for p in placements(new.specs[("w",)], mesh)]}


def whole_state(cfg, opt):
    """A train state of whole meta tensors: the shapes the shardings read."""
    return train_state(build_model(cfg, device="meta").init_params(torch.Generator()), opt)


def dp_run(rank, world, dev, arch, params_np, batches, n_micro, directory, save_at=(),
           resume=None):
    """ZeRO-2 data-parallel steps on `batches`: from the given params, or
    from checkpoint step `resume` in `directory` (restored under this
    world's shardings); the state saved (gathered, written by rank 0) after
    each step in `save_at`."""
    cfg, mesh, model, opt, shard, state = dp_setup(rank, world, dev, arch, params_np, True)
    full = state_shardings(whole_state(cfg, opt), cfg, mesh, single_pod_rules(), shard)
    ck = Checkpointer(directory)
    first = 0
    if resume is not None:
        ck.restore(state, step=resume, shardings=full)
        first = resume
    step = make_train_step(model, opt, lambda s: LR, n_microbatches=n_micro,
                           grad_shardings=shard, mesh=mesh)
    for i in range(first, len(batches)):
        state, _ = step(state, {k: torch.from_numpy(v).to(dev) for k, v in batches[i].items()})
        if i + 1 in save_at:
            ck.save(i + 1, state, blocking=True, shardings=full)
    ck.wait()


def dp_resume_rank(rank, world, dev, arch, params_np, batches, n_micro, straight, resumed):
    """A straight ZeRO-2 run saved after steps 2 and 3 into `straight`; then
    a run resumed from its step 2, saved after step 3 into `resumed`."""
    dp_run(rank, world, dev, arch, params_np, batches, n_micro, straight, (2, 3))
    ck = Checkpointer(resumed)
    if rank == 0:
        import os
        os.symlink(os.path.join(straight, "step_0000000002"),
                   os.path.join(resumed, "step_0000000002"))
    torch.distributed.barrier()
    dp_run(rank, world, dev, arch, params_np, batches, n_micro, resumed, (3,), resume=2)
    ck.wait()


def dp_restore_rank(rank, world, dev, arch, params_np, directory, step):
    """Checkpoint `step` restored under this world's ZeRO-1 shardings, with
    the DP axes on the stacked axes (stack True) and on an inner dim (False):
    for each, every leaf's block (the slices it was asked for) by path."""
    out = {}
    for stack in (True, False):
        cfg, mesh, model, opt, shard, state = dp_setup(rank, world, dev, arch, params_np, True,
                                                       stack=stack)
        full = state_shardings(whole_state(cfg, opt), cfg, mesh, single_pod_rules(), shard)
        Checkpointer(directory).restore(state, step=step, shardings=full)
        out[str(stack)] = {"/".join(map(str, path)): (
            None if b is None else [(s.start, s.stop) for s in b], _np(t))
            for (path, t), b in zip(flatten(state), full.index(state, rank))}
    return out
