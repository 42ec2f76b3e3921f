"""The port's MoE family (src/repro_torch/models/moe.py and the "moe" branches
of models/dense.py) against the JAX package on the phi3.5-moe and arctic
SMOKE configs, on the CPU.

Both sides run the same weights (JAX initialises them, `repro_torch.bridge`
hands them over) and the same tokens. On the CPU the port's expert products
run the plain version of the grouped-matmul kernel (`ref.moe_gmm_ref`); the
JAX model computes them with `jnp.einsum`. Tolerances, with their reasons:
  * fp32 logits, caches and FFN outputs: atol=rtol=1e-5 (float rounding,
    with sums in another order);
  * bf16: atol=rtol=2e-2 (bf16 rounding, as tests/test_kernels.py states);
  * the aux loss is fp32 on both sides at either param dtype: 1e-5 at fp32
    params, 2e-2 at bf16 params (the router sees bf16-rounded inputs);
  * greedy tokens and engine outputs at fp32: identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as JM
from repro.serve import engine as jax_engine
from repro.serve.router import Router
from repro_torch import bridge
from repro_torch.configs import MoEConfig, get_config
from repro_torch.models import build_model
from repro_torch.models import dense as D
from repro_torch.models import moe as M
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["phi3.5-moe-42b-a6.6b", "arctic-480b"]
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _setup(arch, dtype, seed=0):
    jcfg = jax_get_config(arch, smoke=True).replace(param_dtype=dtype)
    cfg = get_config(arch, smoke=True).replace(param_dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jcfg, jm, jp, cfg, build_model(cfg, device="cpu"), bridge.params_from_jax(jp)


def _tokens(cfg, B, T, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------------- the FFN alone

@pytest.mark.parametrize("n_tokens", [1, 8, 16, 20, 64, 1024, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_is_the_jax_integer(arch, n_tokens):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert M.capacity(cfg, n_tokens) == JM.capacity(jcfg, n_tokens)


def test_capacity_on_the_main_path():
    """phi3.5-moe: 8 decode slots give C=4; a 1024-token prompt C=160."""
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    assert [M.capacity(cfg, n) for n in (8, 16, 1024)] == [4, 4, 160]


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_and_aux_match_jax(arch, dtype, n_groups):
    jcfg, _, jp, cfg, _, p = _setup(arch, dtype)
    x = np.random.default_rng(2).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jlayer = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    jy, jaux = jax.jit(lambda p, x: JM.moe_ffn(p, x, jcfg, n_groups))(jlayer, jx)
    y, aux = M.moe_ffn(p["layers"][0]["moe"], torch.from_numpy(x).to(D.param_dtype(cfg)),
                       cfg, n_groups)
    assert y.dtype == D.param_dtype(cfg) and tuple(y.shape) == jy.shape
    np.testing.assert_allclose(_f32(y), _f32(jy), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), **TOL[dtype])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("e", [2, 4, 8])
def test_dispatch_conservation_matches_jax(seed, e):
    """The port of test_coverage_extras.py::test_moe_dispatch_conservation:
    every kept slot carries exactly one token row, dropped tokens contribute
    zero, combine weights per token sum to <= 1; and the slots, the slot of
    every (token, k) and the gates equal JAX's."""
    n, d, k, cap = 32, 16, 2, 4
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    logits = rng.standard_normal((n, e)).astype(np.float32)
    slots, inv, top_g, gates = M._dispatch_one_group(torch.from_numpy(x),
                                                     torch.from_numpy(logits), k, cap)
    assert slots.shape == (e * cap, d)
    matched = 0
    for r in slots.numpy():
        if np.allclose(r, 0.0):
            continue
        assert any(np.allclose(r, xr) for xr in x)
        matched += 1
    assert matched <= n * k
    g = top_g.numpy()
    assert np.all(g >= 0) and np.all(g.sum(-1) <= 1.0 + 1e-5)
    js, jinv, jg, jgates = jax.jit(JM._dispatch_one_group, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(logits), k, cap)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(js))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_allclose(g, np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), atol=1e-6)


def test_capacity_drop_is_graceful_and_matches_jax():
    """The port of test_coverage_extras.py::test_moe_capacity_drop_is_graceful:
    with capacity factor 0.1 most (token, k) choices drop, the output stays
    finite, and it equals JAX's."""
    jcfg, _, jp, cfg, _, p = _setup("phi3.5-moe-42b-a6.6b", "float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=0.1))
    cfg = cfg.replace(moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=0.1))
    x = np.random.default_rng(3).standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    slots_used = M.capacity(cfg, 128) * cfg.moe.n_experts
    assert slots_used < 128 * cfg.moe.top_k          # choices do drop
    y, aux = M.moe_ffn(p["layers"][1]["moe"], torch.from_numpy(x), cfg)
    jy, jaux = jax.jit(lambda p, x: JM.moe_ffn(p, x, jcfg, 1))(
        jax.tree.map(lambda a: a[1], jp["layers"]["moe"]), jnp.asarray(x))
    assert bool(torch.isfinite(y).all()) and np.isfinite(float(aux))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL["float32"])


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch, dtype):
    _, jm, jp, cfg, m, p = _setup(arch, dtype)
    toks = _tokens(cfg, 2, 12)
    jlogits, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    logits, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    assert tuple(logits.shape) == jlogits.shape and logits.dtype == D.param_dtype(cfg)
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), **TOL[dtype])
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        np.testing.assert_allclose(_f32(cache[name]), _f32(jcache[name]),
                                   err_msg=name, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, dtype):
    """One decode step of 3 slots over a cache filled by prefill: the 3
    tokens compete for the decode capacity of 4 slots per expert. At bf16
    the rows this step writes in layer 1 carry the rounding of layer 0; on
    these tokens the largest gap is 0.68 of the tolerance for arctic and
    0.38 for phi (the dense llama3 SMOKE path shows 0.4-1.0 on other
    draws), so the bf16 bound is rounding, not a routing difference."""
    _, jm, jp, cfg, m, p = _setup(arch, dtype)
    B, T, S = 3, 10, 16
    toks = _tokens(cfg, B, T, seed=2)
    jlogits, jpc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    jcache = {k: v.at[:, :, :T].set(jpc[k]) for k, v in jm.init_cache(B, S).items()}
    cache = bridge.cache_from_jax(jcache)
    batch = {"tokens": np.array(jnp.argmax(jlogits, -1), np.int32),
             "positions": np.array([T, T - 3, S], np.int32)}
    jl, jc = jax.jit(jm.decode_step)(jp, jcache, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, out = m.decode_step(p, cache, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out is cache
    np.testing.assert_allclose(_f32(logits), _f32(jl), **TOL[dtype])
    for name in cache:
        np.testing.assert_allclose(_f32(cache[name]), _f32(jc[name]), err_msg=name,
                                   **TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_and_aux_match_jax(arch):
    from repro.models import dense as JD
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    jcfg, _, jp, cfg, _, p = _setup(arch, "float32", seed=1)
    B, T = 2, 8
    toks = _tokens(cfg, B, T, seed=5)
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    x, aux = D.backbone_fwd(p, L.embed(p["embed"], torch.from_numpy(toks)), positions, cfg)
    jpos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    jx, jaux = jax.jit(lambda p, x: JD.backbone_fwd(p, x, jpos, jcfg, remat=False))(
        jp, JL.embed(jp["embed"], jnp.asarray(toks)))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL["float32"])
    np.testing.assert_allclose(float(aux), float(jaux), **TOL["float32"])
    assert float(aux) > 0


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_identical_to_jax_engine_at_fp32(arch):
    """Both engines decode every slot, free ones included, so the free
    slots' stale tokens compete for the experts' capacity on both sides."""
    jcfg, jm, jp, cfg, m, p = _setup(arch, "float32")
    jeng = jax_engine.ServeEngine(jm, jp, batch_slots=3, max_len=32)
    eng = ServeEngine(m, p, batch_slots=3, max_len=32, device="cpu")
    specs = [([1 + i, 2, 3 + i % 4], 4 + i % 3, -1) for i in range(7)]
    outs = []
    for engine, req_cls in ((jeng, jax_engine.Request), (eng, Request)):
        reqs = [req_cls(id=i, prompt=list(pr), max_new_tokens=n, eos_id=eos)
                for i, (pr, n, eos) in enumerate(specs)]
        for r in reqs:
            engine.add_request(r)
        engine.run_until_drained()
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
    assert eng.stats == jeng.stats


def test_router_drives_the_moe_engine_unchanged():
    """repro.serve.router.Router over two port engines serving phi3.5-moe
    SMOKE gives every request the tokens one JAX engine gives it. With 2
    slots and prompts of at most 3 tokens no (token, k) choice can exceed
    the capacity of 4, so the tokens do not depend on which requests share a
    batch."""
    jcfg, jm, jp, cfg, m, p = _setup("phi3.5-moe-42b-a6.6b", "float32", seed=2)
    specs = [([2 + i, 3 + i % 3, 5], 3 + i % 2) for i in range(6)]
    jeng = jax_engine.ServeEngine(jm, jp, batch_slots=2, max_len=24)
    want = [jax_engine.Request(id=i, prompt=list(pr), max_new_tokens=n)
            for i, (pr, n) in enumerate(specs)]
    for r in want:
        jeng.add_request(r)
    jeng.run_until_drained()
    router = Router(max_queue_per_replica=2)
    for rid in ("r0", "r1"):
        router.add_replica(rid, ServeEngine(m, p, batch_slots=2, max_len=24, device="cpu"))
    reqs = [Request(id=i, prompt=list(pr), max_new_tokens=n)
            for i, (pr, n) in enumerate(specs)]
    assert all(router.submit(r) for r in reqs)
    done = router.flush()
    assert sorted(r.id for r in done) == list(range(len(specs)))
    assert [r.output for r in reqs] == [r.output for r in want]


# ------------------------------------------------------------- init and bridge

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_match_jax_shapes(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    m, jm = build_model(cfg, device="cpu"), jax_build_model(jcfg)
    p = bridge.params_to_numpy(m.init_params(torch.Generator().manual_seed(0)))
    jp = jm.init_params(jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p)
    assert shapes == jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_is_exact(arch, dtype):
    """The nested moe leaves (and arctic's moe.dense) cross both ways exactly;
    the router stays fp32 at bf16 params."""
    _, _, jp, cfg, _, p = _setup(arch, dtype)
    assert p["layers"][0]["moe"]["router"].dtype == torch.float32
    assert ("dense" in p["layers"][1]["moe"]) == bool(cfg.moe.dense_residual_ff)
    back = bridge.params_to_numpy(p)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jp, back)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
