"""Rank bodies for tests/test_torch_fsdp_ep.py: each runs on every rank
that `repro_torch.distributed.spawn` starts (gloo on the CPU) and returns
numpy values, gathered by rank. The training cases run through
tests/_torch_tp_ranks.py's `train_rank`."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.launch.mesh import dp_group, make_mesh
from repro_torch.models import build_model
from repro_torch.models.data_parallel import ExpertAllToAll, FSDPGather
from repro_torch.tree import leaves

from _torch_tp_ranks import _np, smoke_cfg, train_rank  # noqa: F401  (a job of world_rank)


def world_rank(rank, world, dev, jobs):
    """Every job (a rank body's name here and its arguments) on this rank,
    in order: one spawn serves the module's cases."""
    return {name: globals()[fn](rank, world, dev, *args) for name, (fn, args) in jobs.items()}


def serve_rank(rank, world, dev, cases):
    """Each case {"arch", "shape", "params" (JAX's, numpy), "batch", "S",
    "steps"} served by this rank with FSDP on (cfg.fsdp, as the reference's
    `_serve_cfg` serves the large archs): the prefill of its data rank's
    rows of the batch, then `steps` greedy decode steps, each fed the
    argmax of the last logits; the prefill's and each step's logits, the
    tokens, and what the rank holds (param entries, whether a plan splits
    the experts)."""
    out = {}
    for name, c in cases.items():
        cfg = smoke_cfg(c["arch"]).replace(fsdp=True)
        mesh = make_mesh(c["shape"], ("data", "model"), device=dev)
        model = build_model(cfg, device=dev, mesh=mesh)
        params = bridge.shard_params(bridge.params_from_jax(c["params"], dev), cfg, mesh, rank)
        group = dp_group(mesh)
        n, r = dist.get_world_size(group), dist.get_rank(group)
        B, T = c["batch"]["tokens"].shape
        rows = slice(r * B // n, (r + 1) * B // n)
        with torch.inference_mode():
            logits, pc = model.prefill(params, {k: torch.from_numpy(v[rows]).to(dev)
                                                for k, v in c["batch"].items()})
            cache = model.init_cache(B // n, c["S"])
            for k in cache:
                cache[k][:, :, :T] = pc[k]
            lgs, toks = [_np(logits)], []
            for i in range(c["steps"]):
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
                toks.append(tok.numpy().copy())
                pos = torch.full((B // n,), T + i, dtype=torch.int32, device=dev)
                logits, cache = model.decode_step(params, cache, {"tokens": tok,
                                                                  "positions": pos})
                lgs.append(_np(logits))
        out[name] = {"logits": lgs, "tokens": toks,
                     "held": sum(t.numel() for t in leaves(params)),
                     "ep": model.dp is not None and model.dp.ep_group is not None,
                     "gathered": sorted("/".join(p) for p in model.dp.gathers)
                     if model.dp is not None else []}
    return out


def collective_rank(rank, world, dev):
    """`FSDPGather` and `ExpertAllToAll` on the rank's block against what
    they must compute and carry back (each the max abs error): the gather
    of dim 1 is the whole leaf and its backward the rank's block of the
    ranks' summed gradients; the experts' all-to-all puts rank q's slots for
    expert e where the expert's rank reads them, its backward returns each
    gradient to its slot, and the way back inverts it."""
    g = torch.Generator().manual_seed(0)   # the same draws on every rank
    group = dist.group.WORLD
    whole = torch.randn(3, 4 * world, 5, generator=g)
    cs = torch.randn(world, 3, 4 * world, 5, generator=g)
    x = whole[:, 4 * rank:4 * (rank + 1)].clone().requires_grad_()
    y = FSDPGather.apply(x, 1, group)
    (y * cs[rank]).sum().backward()
    res = {"gather": max(float((y - whole).abs().max()),
                         float((x.grad - cs.sum(0)[:, 4 * rank:4 * (rank + 1)]).abs().max()))}
    G, E, C, d = 2, 2 * world, 3, 4
    slots = torch.randn(world, G, E, C, d, generator=g)
    ws = torch.randn(world, E // world, world * G, C, d, generator=g)
    x = slots[rank].clone().requires_grad_()
    y = ExpertAllToAll.apply(x, group, True)
    (y * ws[rank]).sum().backward()
    el = E // world
    want = torch.stack([slots[q, :, rank * el:(rank + 1) * el] for q in range(world)])
    want = want.permute(2, 0, 1, 3, 4).reshape(el, world * G, C, d)
    grad = torch.stack([ws[q].reshape(el, world, G, C, d)[:, rank] for q in range(world)])
    grad = grad.permute(2, 0, 1, 3, 4).reshape(G, E, C, d)
    back = ExpertAllToAll.apply(y.detach(), group, False)
    res["to_experts"] = max(float((y - want).abs().max()), float((x.grad - grad).abs().max()))
    res["to_groups"] = float((back - slots[rank]).abs().max())
    return res
