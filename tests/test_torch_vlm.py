"""The port's VLM family (the dense LM with the stub frontend,
src/repro_torch/models/dense.py::_inject_frontend) against the JAX package
on the internvl2 SMOKE config, on the CPU.

Both sides run the same weights (JAX initialises them, `repro_torch.bridge`
hands them over) and the same numpy-seeded tokens and patch embeddings.
Tolerances, with their reasons, as tests/test_torch_dense.py and
tests/test_torch_train.py state them for the dense family:
  * fp32 logits and caches: atol=rtol=1e-5 (float rounding, with sums in
    another order);
  * bf16 logits and caches: atol=rtol=2e-2 (bf16 rounding);
  * lm_loss 1e-5 relative, each gradient leaf 1e-4 relative L2;
  * engine outputs at fp32: identical tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import dense as JD
from repro.models import layers as JL
from repro.serve import engine as jax_engine
from repro.serve.router import Router
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.tree import flatten, leaves, unflatten_like

ARCH = "internvl2-76b"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _setup(dtype, seed=0):
    jcfg = jax_get_config(ARCH, smoke=True).replace(param_dtype=dtype)
    cfg = get_config(ARCH, smoke=True).replace(param_dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jm, jp, cfg, build_model(cfg, device="cpu"), bridge.params_from_jax(jp)


def _batch(cfg, B, T, seed=1, targets=False):
    """Tokens and cfg.vlm.n_patches patch embeddings, which take the first
    positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(),
             "patch_embeds": rng.standard_normal((B, cfg.vlm.n_patches, cfg.d_model))
             .astype(np.float32)}
    if targets:
        batch["targets"] = toks[:, 1:].copy()
    return batch


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, dtype, name=""):
    np.testing.assert_allclose(_f32(got), _f32(want), err_msg=name, **TOL[dtype])


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inject_frontend_matches_jax(dtype):
    """The patches replace the first n_patches embeddings, cast to the
    working dtype; a text-only batch and the other families keep x."""
    _, jp, cfg, _, p = _setup(dtype)
    batch = _batch(cfg, 2, 12)
    jx = JL.embed(jp["embed"], jnp.asarray(batch["tokens"]))
    x = L.embed(p["embed"], torch.from_numpy(batch["tokens"]))
    jcfg = jax_get_config(ARCH, smoke=True).replace(param_dtype=dtype)
    want = JD._inject_frontend(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jx, jcfg)
    got = D._inject_frontend({k: torch.from_numpy(v) for k, v in batch.items()}, x, cfg)
    assert got.dtype == DT[dtype]
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert D._inject_frontend({"tokens": None}, x, cfg) is x
    assert D._inject_frontend(batch, x, cfg.replace(family="dense")) is x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_patches_matches_jax(dtype):
    jm, jp, cfg, m, p = _setup(dtype)
    batch = _batch(cfg, 2, 24)
    jlogits, jcache = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = m.prefill(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(logits.shape) == jlogits.shape and logits.dtype == DT[dtype]
    _close(logits, jlogits, dtype, "logits")
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        _close(cache[name], jcache[name], dtype, name)
    text, _ = m.prefill(p, {"tokens": torch.from_numpy(batch["tokens"])})
    assert not torch.allclose(text, logits)   # the patches reached the logits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_after_a_prefill_with_patches_matches_jax(dtype):
    jm, jp, cfg, m, p = _setup(dtype)
    B, T, S = 2, 16, 24
    batch = _batch(cfg, B, T, seed=2)
    jlogits, jpc = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jcache = jax.tree.map(lambda big, pc: big.at[:, :, :T].set(pc), jm.init_cache(B, S), jpc)
    cache = bridge.cache_from_jax(jcache)
    step = {"tokens": np.array(jnp.argmax(jlogits, -1), np.int32),
            "positions": np.full(B, T, np.int32)}
    jl, jc = jax.jit(jm.decode_step)(jp, jcache, {k: jnp.asarray(v) for k, v in step.items()})
    logits, out = m.decode_step(p, cache, {k: torch.from_numpy(v) for k, v in step.items()})
    _close(logits, jl, dtype, "logits")
    for name in cache:
        _close(out[name], jc[name], dtype, name)


def test_lm_loss_with_patches_and_grads_match_jax():
    jm, jp, cfg, m, p = _setup("float32")
    batch = _batch(cfg, 2, 16, seed=3, targets=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    live = [t.requires_grad_() for t in leaves(p)]
    loss, metrics = m.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(_f32(loss), np.asarray(jloss), rtol=1e-5, atol=0)
    np.testing.assert_allclose(_f32(metrics["xent"]), np.asarray(jmetrics["xent"]),
                               rtol=1e-5, atol=0)
    want = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    got = dict(flatten(bridge.params_to_numpy(unflatten_like(p, [g.detach() for g in grads]))))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path in got:
        assert _rel(got[path], want[path]) <= 1e-4, (path, _rel(got[path], want[path]))


def _run(engine, request_cls, specs):
    reqs = [request_cls(id=i, prompt=list(pr), max_new_tokens=n) for i, (pr, n) in
            enumerate(specs)]
    for r in reqs:
        engine.add_request(r)
    engine.run_until_drained()
    return reqs


def test_text_only_requests_through_the_router_match_the_jax_engine():
    """internvl2 SMOKE served text-only: the JAX engine and the port's
    engine behind repro.serve.router.Router give every request the same
    tokens at fp32."""
    jm, jp, cfg, m, p = _setup("float32", seed=4)
    specs = [([3 + i, 7, 1 + i % 4, 9], 3 + i % 3) for i in range(6)]
    want = _run(jax_engine.ServeEngine(jm, jp, batch_slots=2, max_len=24),
                jax_engine.Request, specs)

    router = Router(max_queue_per_replica=2)
    for rid in ("r0", "r1"):
        router.add_replica(rid, ServeEngine(m, p, batch_slots=2, max_len=24, device="cpu"))
    reqs = [Request(id=i, prompt=list(pr), max_new_tokens=n) for i, (pr, n) in
            enumerate(specs)]
    assert all(router.submit(r) for r in reqs)
    done = router.flush()
    assert sorted(r.id for r in done) == list(range(6))
    assert [r.output for r in reqs] == [r.output for r in want]
    assert all(len(r.output) == n for r, (_, n) in zip(reqs, specs))


def test_replicated_kv_cache_matches_jax():
    """kv_replication=2 (internvl2's published setting) on the SMOKE widths:
    the prefill's cache holds each kv head twice, and a decode step over it
    matches JAX."""
    jcfg = jax_get_config(ARCH, smoke=True).replace(param_dtype="float32", kv_replication=2)
    cfg = get_config(ARCH, smoke=True).replace(param_dtype="float32", kv_replication=2)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(5))
    m, p = build_model(cfg, device="cpu"), bridge.params_from_jax(jp)
    B, T, S = 2, 12, 16
    batch = _batch(cfg, B, T, seed=5)
    jlogits, jpc = jax.jit(jm.prefill)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, pc = m.prefill(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert pc["k"].shape[3] == cfg.cache_kv_heads == 2 * cfg.n_kv_heads
    _close(logits, jlogits, "float32", "logits")
    for name in pc:
        _close(pc[name], jpc[name], "float32", name)
    jcache = jax.tree.map(lambda big, c: big.at[:, :, :T].set(c), jm.init_cache(B, S), jpc)
    step = {"tokens": np.array(jnp.argmax(jlogits, -1), np.int32),
            "positions": np.full(B, T, np.int32)}
    jl, _ = jax.jit(jm.decode_step)(jp, jcache, {k: jnp.asarray(v) for k, v in step.items()})
    got, _ = m.decode_step(p, bridge.cache_from_jax(jcache),
                           {k: torch.from_numpy(v) for k, v in step.items()})
    _close(got, jl, "float32", "decode logits")
