"""Rank bodies for tests/test_torch_tensor_parallel.py: each runs on every
rank that `repro_torch.distributed.spawn` starts (gloo on the CPU) and
returns numpy values, gathered by rank. Only `engine_rank` imports the
JAX package, for its `repro.serve.router.Router`."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch.mesh import dp_group, make_mesh, tp_group
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.tensor_parallel import TensorParallel
from repro_torch.serve.engine import Request, ServeEngine


def smoke_cfg(arch):
    return get_config(arch, smoke=True).replace(param_dtype="float32")


def _np(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype != torch.int8 else t.numpy().copy()


def serve(model, params, batch, S, steps):
    """Prefill `batch`, copy its cache into one of S rows, then one decode
    step for each of `steps` ((B, 1) tokens) at positions T, T+1, ...:
    (prefill logits, prefill cache, each step's logits, the final cache)."""
    dev = model.device
    B, T = batch["tokens"].shape
    with torch.inference_mode():
        logits, pc = model.prefill(params, {k: torch.from_numpy(v).to(dev)
                                            for k, v in batch.items()})
        cache = model.init_cache(B, S)
        for name in cache:
            cache[name][:, :, :T] = pc[name]
        out = []
        for i, t in enumerate(steps):
            pos = torch.full((B,), T + i, dtype=torch.int32, device=dev)
            lg, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(t).to(dev),
                                                          "positions": pos})
            out.append(_np(lg))
    return (_np(logits), {k: _np(v) for k, v in pc.items()}, out,
            {k: _np(v) for k, v in cache.items()})


def parity_rank(rank, world, dev, cases):
    """Each case {"arch", "params" (JAX's, numpy), "batch", "S", "steps"}
    served by this rank of a (1, world) mesh: `serve`'s results, and the
    plan's head layout. The params are the rank's blocks of the bridged
    whole params (bridge.shard_params)."""
    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    out = {}
    for name, c in cases.items():
        cfg = smoke_cfg(c["arch"])
        model = build_model(cfg, device=dev, mesh=mesh)
        params = bridge.shard_params(bridge.params_from_jax(c["params"], dev), cfg, mesh, rank)
        tp = model.tp
        out[name] = dict(zip(("prefill", "prefill_cache", "decode", "cache"),
                             serve(model, params, c["batch"], c["S"], c["steps"])))
        out[name]["plan"] = {"q_split": tp.q_split, "gather_q": tp.gather_q,
                             "gather_kv": tp.gather_kv, "kv_heads": tp.kv_heads is not None,
                             "out_cols": tp.out_cols is not None,
                             "cache_heads": tp.cache_heads}
    return out


def units_rank(rank, world, dev, vocab, d, tokens, x, n_valid):
    """Vocab-parallel embed and unembed of this rank's rows of a (vocab, d)
    table against the whole table's; and, on four ranks, the groups of a
    (2, 2) mesh."""
    g = torch.Generator().manual_seed(0)
    tok = torch.randn((vocab, d), generator=g)
    out_w = torch.randn((vocab, d), generator=g)
    cfg = smoke_cfg("llama3-8b").replace(vocab_size=n_valid)
    tp = TensorParallel.plan(cfg, dist.group.WORLD)
    rows = tp.vocab_rows
    mine = {"tok": tok[rows].clone(), "out": out_w[rows].clone()}
    whole = {"tok": tok, "out": out_w}
    t, xx = torch.from_numpy(tokens), torch.from_numpy(x)
    res = {"embed": float((L.embed(mine, t, tp) - L.embed(whole, t)).abs().max()),
           "unembed": float((L.unembed(mine, xx, n_valid, tp)
                             - L.unembed(whole, xx, n_valid)).abs().max()),
           "unembed_masked": bool((L.unembed(mine, xx, n_valid, tp)[..., n_valid:] == -1e9)
                                  .all())}
    if world == 4:
        mesh = make_mesh((2, 2), ("data", "model"), device=dev)
        res["dp_group"] = dist.get_process_group_ranks(dp_group(mesh))
        res["tp_group"] = dist.get_process_group_ranks(tp_group(mesh))
    return res


def engine_rank(rank, world, dev, params_np, specs, slots, max_len):
    """llama3-8b SMOKE served tensor-parallel by this rank's ServeEngine,
    driven by the JAX package's Router: each request's output."""
    from repro.serve.router import Router
    cfg = smoke_cfg("llama3-8b")
    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    model = build_model(cfg, device=dev, mesh=mesh)
    params = bridge.shard_params(bridge.params_from_jax(params_np, dev), cfg, mesh, rank)
    router = Router(max_queue_per_replica=len(specs))
    router.add_replica("tp", ServeEngine(model, params, batch_slots=slots, max_len=max_len,
                                         device=dev))
    reqs = [Request(id=i, prompt=list(p), max_new_tokens=n) for i, (p, n) in enumerate(specs)]
    assert all(router.submit(r) for r in reqs)
    done = router.flush()
    return {"done": sorted(r.id for r in done), "outputs": [r.output for r in reqs]}


def world_rank(rank, world, dev, jobs):
    """Every job (a rank body's name and its arguments) on this rank, in
    order: one spawn serves a module's cases."""
    return {name: globals()[fn](rank, world, dev, *args) for name, (fn, args) in jobs.items()}
