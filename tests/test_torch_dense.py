"""The port's dense LM (src/repro_torch/models/dense.py) against the JAX
package on the llama3, granite, qwen and stablelm SMOKE configs, on the CPU.

Both sides run the same weights: JAX initialises them and
`repro_torch.bridge` hands them over. Tolerances, with their reasons:
  * fp32 logits and caches: atol=rtol=1e-5 (float rounding, with sums in
    another order; the observed gap is below 2e-6);
  * bf16 logits and caches: atol=rtol=2e-2 (bf16 rounding, as
    tests/test_kernels.py states for bf16);
  * qwen's int8 cache: at fp32 the codes may differ by 1 where a value sits
    at a rounding boundary, the scales agree to 1e-5 and the dequantized
    values to one quantization step; at bf16 the dequantized values agree
    to the bf16 tolerance plus one step;
  * greedy tokens at fp32: identical.
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
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import dense as D
from repro_torch.models import layers as L

ARCHS = ["llama3-8b", "granite-8b", "qwen1.5-32b", "stablelm-12b"]
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _setup(arch, dtype, seed=0):
    jcfg = jax_get_config(arch, smoke=True).replace(param_dtype=dtype)
    cfg = get_config(arch, smoke=True).replace(param_dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jm, jp, cfg, build_model(cfg, device="cpu"), bridge.params_from_jax(jp)


def _tokens(cfg, B, T, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _assert_cache_close(cache, jcache, dtype):
    assert sorted(cache) == sorted(jcache)
    if "k_scale" not in cache:
        for name in cache:
            np.testing.assert_allclose(_f32(cache[name]), _f32(jcache[name]),
                                       err_msg=name, **TOL[dtype])
        return
    for kind in ("k", "v"):
        codes, scale = _f32(cache[kind]), _f32(cache[f"{kind}_scale"])
        jcodes, jscale = _f32(jcache[kind]), _f32(jcache[f"{kind}_scale"])
        step = np.maximum(scale, jscale)
        deq, jdeq = codes * scale, jcodes * jscale
        if dtype == "float32":
            assert np.abs(codes - jcodes).max() <= 1, kind
            np.testing.assert_allclose(scale, jscale, atol=1e-5, rtol=1e-5)
            assert np.all(np.abs(deq - jdeq) <= step + 1e-5), kind
        else:
            bound = 2e-2 + 2e-2 * np.abs(jdeq) + step
            assert np.all(np.abs(deq - jdeq) <= bound), kind


# ------------------------------------------------------------- prefill / decode

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch, dtype):
    jm, jp, cfg, m, p = _setup(arch, dtype)
    toks = _tokens(cfg, 2, 12)
    jlogits, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    logits, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    assert tuple(logits.shape) == jlogits.shape and logits.dtype == D.param_dtype(cfg)
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), **TOL[dtype])
    _assert_cache_close(cache, jcache, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, dtype):
    """One decode step over a max_len cache filled by prefill. Row 1 sits at
    the end of the cache, so its write is dropped on both sides."""
    jm, jp, cfg, m, p = _setup(arch, dtype)
    B, T, S = 2, 10, 16
    toks = _tokens(cfg, B, T)
    jlogits, jpc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    jcache = jm.init_cache(B, S)
    jcache = {k: v.at[:, :, :T].set(jpc[k]) for k, v in jcache.items()}
    cache = bridge.cache_from_jax(jcache)
    batch = {"tokens": np.array(jnp.argmax(jlogits, -1), np.int32),
             "positions": np.array([T, S], np.int32)}
    jl, jc = jax.jit(jm.decode_step)(jp, jcache, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, out = m.decode_step(p, cache, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out is cache   # updated in place
    np.testing.assert_allclose(_f32(logits), _f32(jl), **TOL[dtype])
    _assert_cache_close(cache, jc, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_identical_at_fp32(arch):
    jm, jp, cfg, m, p = _setup(arch, "float32", seed=3)
    B, T, S, steps = 2, 6, 16, 6
    toks = _tokens(cfg, B, T, seed=4)
    jlogits, jpc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    jcache = {k: v.at[:, :, :T].set(jpc[k]) for k, v in jm.init_cache(B, S).items()}
    logits, pc = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    cache = m.init_cache(B, S)
    for name in cache:
        cache[name][:, :, :T] = pc[name]
    jdecode = jax.jit(jm.decode_step)
    jout, out = [], []
    for step in range(steps):
        jt = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)
        t = torch.argmax(logits[:, -1], -1).to(torch.int32)
        jout.append(np.asarray(jt))
        out.append(t.numpy())
        pos = np.full((B,), T + step, np.int32)
        jlogits, jcache = jdecode(jp, jcache, {"tokens": jt[:, None],
                                               "positions": jnp.asarray(pos)})
        logits, cache = m.decode_step(p, cache, {"tokens": t[:, None],
                                                 "positions": torch.from_numpy(pos)})
    np.testing.assert_array_equal(np.stack(out), np.stack(jout))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The port of test_models_smoke.py::test_decode_matches_full_forward:
    greedy prefill equals the argmax of the full forward at the last
    position, the full forward matches JAX's, and a decode step after
    prefill is finite."""
    jcfg = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    if cfg.kv_cache_dtype == "int8":   # exactness for the test, as in JAX
        jcfg = jcfg.replace(kv_cache_dtype="bfloat16")
        cfg = cfg.replace(kv_cache_dtype="bfloat16")
    jp = jax_build_model(jcfg).init_params(jax.random.PRNGKey(1))
    m, p = build_model(cfg, device="cpu"), bridge.params_from_jax(jp)
    B, T = 2, 16
    toks = _tokens(cfg, B, T, seed=2)
    logits_pref, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)})

    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    x, aux = D.backbone_fwd(p, L.embed(p["embed"], torch.from_numpy(toks)), positions, cfg)
    assert float(aux) == 0.0   # a dense stack has no MoE aux loss
    full = L.unembed(p["embed"], x, cfg.vocab_size)
    assert torch.equal(full[:, -1].argmax(-1), logits_pref[:, -1].argmax(-1))

    jpos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    jx, _ = JD.backbone_fwd(jp, JL.embed(jp["embed"], jnp.asarray(toks)), jpos, jcfg,
                            remat=False)
    jfull = JL.unembed(jp["embed"], jx, jcfg.vocab_size)
    np.testing.assert_allclose(_f32(full), _f32(jfull), **TOL["bfloat16"])

    step = {"tokens": logits_pref[:, -1].argmax(-1).to(torch.int32)[:, None],
            "positions": torch.full((B,), T, dtype=torch.int32)}
    big = m.init_cache(B, T + 4)
    for name in big:
        big[name][:, :, :T] = cache[name]
    dec_logits, _ = m.decode_step(p, big, step)
    assert bool(torch.isfinite(dec_logits.float()).all())


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b"])
def test_store_kv_drops_rows_past_the_cache_like_jax(arch):
    """Rows at or past max_len are dropped, as JAX's scatter with
    mode="drop" drops them; the other rows are written."""
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32")
    jcfg = jax_get_config(arch, smoke=True).replace(param_dtype="float32")
    B, S, H, Dh = 4, 8, cfg.cache_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((B, 1, H, Dh)).astype(np.float32) for _ in range(2))
    pos = np.array([2, 7, 8, 11], np.int32)
    cache = D.init_cache(cfg, B, S, device="cpu")
    for name in cache:   # nonzero old contents, so a wrong write shows
        cache[name][1] = 0.5 if cache[name].is_floating_point() else 3
    jc = {name: jnp.asarray(cache[name].numpy()) for name in cache}
    D._store_kv(cfg, cache, 1, torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(pos))
    scales = (jc["k_scale"][1], jc["v_scale"][1]) if "k_scale" in jc else (None, None)
    got = JD._store_kv(jcfg, jc["k"][1], jc["v"][1], *scales, jnp.asarray(k),
                       jnp.asarray(v), jnp.asarray(pos))
    for name, want in zip(("k", "v", "k_scale", "v_scale"), got):
        if want is not None:
            np.testing.assert_allclose(_f32(cache[name][1]), _f32(want), atol=1e-6,
                                       err_msg=name)
            assert not cache[name][0].any()
    with pytest.raises(ValueError, match="one token"):
        D._store_kv(cfg, cache, 1, torch.zeros(B, 2, H, Dh), torch.zeros(B, 2, H, Dh),
                    torch.from_numpy(pos))


# ------------------------------------------------------------- init and bridge

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_match_jax_shapes(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    m, jm = build_model(cfg, device="cpu"), jax_build_model(jcfg)
    p = bridge.params_to_numpy(m.init_params(torch.Generator().manual_seed(0)))
    jp = jm.init_params(jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), p)
    assert shapes == jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    cache, jcache = m.init_cache(3, 20), jm.init_cache(3, 20)
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in cache.items()} == \
        {k: (a.shape, str(a.dtype)) for k, a in jcache.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    jm, jp, cfg, m, p = _setup("qwen1.5-32b", dtype)
    back = bridge.params_to_numpy(p)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jp, back)
    jcache = jm.init_cache(2, 4)
    jcache = {k: v + 1 for k, v in jcache.items()}
    back = bridge.cache_to_numpy(bridge.cache_from_jax(jcache))
    for k in jcache:
        assert back[k].dtype == jcache[k].dtype
        np.testing.assert_array_equal(back[k], np.asarray(jcache[k]))


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    """Without a card, the default device raises; only device="cpu" runs on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.init_params(torch.Generator(), cfg)
    assert build_model(cfg, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg.replace(family="no-such-family"), device="cpu")
