"""Rank bodies for tests/test_torch_tensor_parallel.py and
tests/test_torch_tp_train.py: each runs on every
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
from repro_torch.tree import flatten


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


def train_rank(rank, world, dev, cases):
    """Each case {"arch", "shape" (the mesh), "zero", "state" (JAX's train
    state at step 0, numpy), "batch", "lr", "steps", "micro"[, "fsdp",
    "config" (more SMOKE overrides)]}
    trained by this rank: its loss and its gradient blocks at the step-0
    params on the whole batch (its data group's share, averaged over the
    group; a block cut over the data axes comes summed over it), then
    `steps` steps of `make_train_step` with `micro` microbatches: each
    step's loss and grad norm, and its blocks of the final params and
    optimizer state, by path."""
    from repro_torch import distributed as D
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding.axes import rules_for
    from repro_torch.sharding.rules import shardings_for
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import leaves, tree_map
    out = {}
    for name, c in cases.items():
        cfg = smoke_cfg(c["arch"]).replace(fsdp=c.get("fsdp", False), **c.get("config", {}))
        mesh = make_mesh(c["shape"], ("data", "model"), device=dev)
        model = build_model(cfg, device=dev, mesh=mesh)
        whole = bridge.train_state_from_jax(c["state"], dev)
        gsh = shardings_for(whole["params"], cfg, mesh, rules_for(mesh), zero1=True) \
            if c["zero"] else None
        state = bridge.shard_train_state(whole, cfg, mesh, rank, gsh)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in c["batch"].items()}
        group = dp_group(mesh)
        n = dist.get_world_size(group) if group is not None else 1
        r = dist.get_rank(group) if group is not None else 0
        rows = next(iter(batch.values())).shape[0] // n
        share = {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}
        live = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        loss, _ = model.loss(live, share)
        grads = [g.detach() for g in torch.autograd.grad(loss, leaves(live))]
        loss = loss.detach()
        if group is not None:
            split = model.split
            for (path, _), g in zip(flatten(state["params"]), grads):
                if split is not None and split.data_cut(path):
                    g.div_(n)
                else:
                    D.all_reduce_(g, group=group).div_(n)
            D.all_reduce_(loss, group=group).div_(n)
        res = {"loss": float(loss),
               "grads": {"/".join(map(str, p)): _np(g)
                         for (p, _), g in zip(flatten(state["params"]), grads)}}
        opt = make_optimizer(cfg.optimizer)
        step = make_train_step(model, opt, lambda s: torch.tensor(c["lr"]),
                               n_microbatches=c["micro"], grad_shardings=gsh, mesh=mesh)
        metrics = []
        for _ in range(c["steps"]):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        res["metrics"] = metrics
        res["state"] = {"/".join(map(str, p)): _np(t) for p, t in flatten(
            {"params": state["params"], "opt": state["opt"]})}
        out[name] = res
    return out


def collective_rank(rank, world, dev):
    """The TP collectives' gradients against what they must carry (each the
    max abs error): `enter`'s backward sums the ranks' partial gradients,
    `all_reduce`'s passes a replicated one on, `all_gather`'s gives each
    rank its columns of the ranks' summed gradient; and the vocab-parallel
    softmax_xent and its gradient against the whole vocabulary's."""
    cfg = smoke_cfg("llama3-8b")
    tp = TensorParallel.plan(cfg, dist.group.WORLD)
    g = torch.Generator().manual_seed(0)   # the same draws on every rank
    x = torch.randn(2, 3, 8, generator=g)
    ws = torch.randn(world, 2, 3, 8, generator=g)
    xr = x.clone().requires_grad_()
    (tp.enter(xr) * ws[rank]).sum().backward()
    res = {"enter": float((xr.grad - ws.sum(0)).abs().max())}
    parts = torch.randn(world, 2, 3, 8, generator=g)
    c = torch.randn(2, 3, 8, generator=g)
    pr = parts[rank].clone().requires_grad_()
    y = tp.all_reduce(pr)
    (y * c).sum().backward()
    res["reduce"] = max(float((y - parts.sum(0)).abs().max()), float((pr.grad - c).abs().max()))
    cols = torch.randn(world, 2, 3, 4, generator=g)
    wg = torch.randn(world, 2, 3, 4 * world, generator=g)
    cr = cols[rank].clone().requires_grad_()
    y = tp.all_gather(cr)
    (y * wg[rank]).sum().backward()
    want = wg.sum(0)[..., 4 * rank:4 * (rank + 1)]
    res["gather"] = max(float((y - torch.cat(list(cols), -1)).abs().max()),
                        float((cr.grad - want).abs().max()))
    V = cfg.padded_vocab
    logits = torch.randn(2, 5, V, generator=g) * 3
    logits[..., cfg.vocab_size:] = -1e9
    targets = torch.randint(0, cfg.vocab_size, (2, 5), generator=g)
    whole = logits.clone().requires_grad_()
    lw = L.softmax_xent(whole, targets)
    lw.backward()
    local = logits[..., tp.vocab_rows].clone().requires_grad_()
    lt = L.softmax_xent(local, targets, tp=tp)
    lt.backward()
    res["xent"] = abs(float(lt) - float(lw))
    res["xent_grad"] = float((local.grad - whole.grad[..., tp.vocab_rows]).abs().max())
    return res


def trainer_run(dev, ckpt_dir, mesh=None):
    """llama3-8b SMOKE (fp32) trained 3 steps by the Trainer from seed 5,
    checkpointed every 2: its final state, by path (under `mesh`, the
    rank's blocks, checkpointed through the train state's shardings)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = smoke_cfg("llama3-8b")
    model = build_model(cfg, device=dev, mesh=mesh)
    opt = make_optimizer("adamw")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                                    seed=5))
    trainer = Trainer(model, opt, pipe, Checkpointer(ckpt_dir),
                      TrainerConfig(num_steps=3, ckpt_every=2, log_every=1, n_microbatches=2,
                                    base_lr=1e-2, warmup=1))
    state = trainer.run(trainer.init_or_restore(5))
    return {"/".join(map(str, p)): _np(t) for p, t in flatten(state)}


def trainer_rank(rank, world, dev, ckpt_dir):
    """`trainer_run` on a (1, world) mesh."""
    return trainer_run(dev, ckpt_dir, make_mesh((1, world), ("data", "model"), device=dev))
