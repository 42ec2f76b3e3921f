"""Rank bodies for tests/test_torch_tp_hybrid.py: each runs on every rank that
`repro_torch.distributed.spawn` starts (gloo on the CPU) and returns numpy
values, gathered by rank. Imports no JAX."""
from __future__ import annotations

import torch

from repro_torch import bridge
from repro_torch.launch.mesh import dp_group, make_mesh
from repro_torch.models import build_model

import _torch_tp_ranks as R


def fill(cache, prefilled, T):
    """The decode cache `cache` with a prefill's written in: the self k/v
    rows [0, T), every other buffer (the hybrid's conv and SSM states,
    whisper's cross k/v of the encoder's rows) the prefill's own."""
    for name, t in prefilled.items():
        if name in ("k", "v"):
            cache[name][:, :, :T] = t
        else:
            cache[name] = t.clone()
    return cache


def serve(model, params, batch, S, steps):
    """Prefill `batch`, its cache filled into one of S rows, then one
    decode step for each of `steps` ((B, 1) tokens) at positions T, T+1,
    ...: (prefill logits, prefill cache, each step's logits, the final
    cache), numpy."""
    dev = model.device
    B, T = batch["tokens"].shape
    with torch.inference_mode():
        logits, pc = model.prefill(params, {k: torch.from_numpy(v).to(dev)
                                            for k, v in batch.items()})
        cache = fill(model.init_cache(B, S), pc, T)
        out = []
        for i, t in enumerate(steps):
            pos = torch.full((B,), T + i, dtype=torch.int32, device=dev)
            lg, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(t).to(dev),
                                                          "positions": pos})
            out.append(R._np(lg))
    return (R._np(logits), {k: R._np(v) for k, v in pc.items()}, out,
            {k: R._np(v) for k, v in cache.items()})


def _rows(mesh, n_rows):
    """This rank's rows of a batch of n_rows: its data group's share."""
    group = dp_group(mesh)
    if group is None:
        return slice(0, n_rows)
    n, r = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
    return slice(r * n_rows // n, (r + 1) * n_rows // n)


def serve_rank(rank, world, dev, cases):
    """Each case {"arch", "config" (SMOKE overrides), "shape" (the mesh),
    "params" (JAX's, numpy), "batch", "S", "steps"} served by this rank on
    its data group's rows: `serve`'s results, its rows and its plan."""
    out = {}
    for name, c in cases.items():
        cfg = R.smoke_cfg(c["arch"]).replace(**c["config"])
        mesh = make_mesh(c["shape"], ("data", "model"), device=dev)
        model = build_model(cfg, device=dev, mesh=mesh)
        params = bridge.shard_params(bridge.params_from_jax(c["params"], dev), cfg, mesh, rank)
        rows = _rows(mesh, c["batch"]["tokens"].shape[0])
        res = dict(zip(("prefill", "prefill_cache", "decode", "cache"),
                       serve(model, params, {k: v[rows] for k, v in c["batch"].items()},
                             c["S"], [t[rows] for t in c["steps"]])))
        tp = model.tp
        res["rows"] = [rows.start, rows.stop]
        res["plan"] = {"q_split": tp.q_split, "gather_q": tp.gather_q, "gather_kv": tp.gather_kv,
                       "out_cols": tp.out_cols is not None, "cache_heads": tp.cache_heads,
                       "ssm_heads": None if tp.ssm_heads is None else
                       [tp.ssm_heads.start, tp.ssm_heads.stop]}
        out[name] = res
    return out


def world_rank(rank, world, dev, jobs):
    """Every job (a rank body's name here or in _torch_tp_ranks, and its
    arguments) on this rank, in order: one spawn serves a world size."""
    bodies = {"serve_rank": serve_rank, "train_rank": R.train_rank}
    return {name: bodies[fn](rank, world, dev, *args) for name, (fn, args) in jobs.items()}
