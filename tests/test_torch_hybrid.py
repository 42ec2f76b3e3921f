"""The port's hybrid family (src/repro_torch/models/{mamba2,hybrid}.py)
against the JAX package on the zamba2 SMOKE config, on the CPU.

Both sides run the same weights (JAX initialises them, `repro_torch.bridge`
hands them over, the mamba2 blocks doubly stacked (nb, attn_every) on the
JAX side) and the same tokens. On the CPU the port's SSD scan runs the plain
version of the kernel (`ref.ssd_scan_ref`), its prefill attention the plain
flash attention and its decode attention the plain decode attention; the
JAX model runs its jnp chunked scan and `flash_attention_ref`. Tolerances,
with their reasons:
  * fp32: atol=rtol=1e-5 (float rounding, with sums in another order);
  * one block at bf16 (mamba_fwd, mamba_decode): atol=rtol=2e-2 (bf16
    rounding, as tests/test_kernels.py states);
  * the whole bf16 model (prefill logits and cache, a decode step): given
    the same input, every block agrees with JAX's to the bit or to one bf16
    ulp in a few elements (the fp32 sums inside run in another order), but
    through 4 mamba2 blocks and 2 attention applications with random weights
    those flips grow past any fixed bf16 tolerance on both sides alike. So
    the port at bf16 must be no further from JAX's fp32 run of the same
    weights (relative L2) than NOISE_FACTOR times JAX's own bf16 run is:
    the gate chip_smoke.py applies on the card;
  * decode from scratch against the parallel prefill: 3e-2, as
    tests/test_models_smoke.py::test_zamba2_decode_consistency_with_prefill_path
    states for the JAX model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import hybrid as JH
from repro.models import layers as JL
from repro.models import mamba2 as JM2
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import hybrid as H
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2

ARCH = "zamba2-2.7b"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NOISE_FACTOR = 2.0


def _setup(dtype, seed=0):
    jcfg = jax_get_config(ARCH, smoke=True).replace(param_dtype=dtype)
    cfg = get_config(ARCH, smoke=True).replace(param_dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jcfg, jm, jp, cfg, build_model(cfg, device="cpu"), bridge.params_from_jax(jp)


def _tokens(cfg, B, T, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, dtype, name=""):
    np.testing.assert_allclose(_f32(got), _f32(want), err_msg=name, **TOL[dtype])


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _model_close(got, want, want32, dtype, name):
    """fp32: allclose to JAX. bf16: no further from JAX's fp32 run than
    NOISE_FACTOR times JAX's own bf16 run (see the module docstring)."""
    if dtype == "float32":
        return _close(got, want, dtype, name)
    assert np.isfinite(_f32(got)).all(), name
    e_port, e_jax = _rel(got, want32), _rel(want, want32)
    assert e_port <= NOISE_FACTOR * e_jax, (name, e_port, e_jax)


def _f32_params(jp):
    return jax.tree.map(lambda a: a.astype(jnp.float32), jp)


def _block(jp, p, a=1, j=0):
    """One mamba2 block's params on both sides: super-block a, block j."""
    return jax.tree.map(lambda t: t[a, j], jp["mamba"]), p["mamba"][a][j]


# ------------------------------------------------------------- the mamba2 block

@pytest.mark.parametrize("T", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_fwd_and_state_match_jax(dtype, T):
    """T=64 runs two SSD chunks of 32, so the state carries across chunks."""
    jcfg, _, jp, cfg, _, p = _setup(dtype)
    jmp, mp = _block(jp, p)
    x = np.random.default_rng(T).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    jout, (jconv, jssm) = jax.jit(lambda p, x: JM2.mamba_fwd(p, x, jcfg, return_state=True))(
        jmp, jnp.asarray(x).astype(jnp.dtype(dtype)))
    out, (conv, ssm) = M2.mamba_fwd(mp, torch.from_numpy(x).to(DT[dtype]), cfg,
                                    return_state=True)
    assert out.dtype == DT[dtype] and conv.dtype == DT[dtype] and ssm.dtype == torch.float32
    _close(out, jout, dtype, "out")
    _close(conv, jconv, dtype, "conv")
    _close(ssm, jssm, dtype, "ssm")


def test_mamba_fwd_refuses_a_ragged_chunk():
    """T must be a multiple of the SSD chunk, as the JAX model asserts."""
    _, _, _, cfg, _, p = _setup("float32")
    with pytest.raises(ValueError, match="chunk"):
        M2.mamba_fwd(p["mamba"][0][0], torch.zeros(1, 48, cfg.d_model), cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax(dtype):
    jcfg, _, jp, cfg, _, p = _setup(dtype)
    jmp, mp = _block(jp, p, 0, 1)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv, ssm = M2.init_mamba_state(cfg, 3, device="cpu")
    conv = torch.from_numpy(rng.standard_normal(tuple(conv.shape)).astype(np.float32))
    ssm = torch.from_numpy(rng.standard_normal(tuple(ssm.shape)).astype(np.float32) * 0.1)
    jout, (jconv, jssm) = jax.jit(lambda p, x, st: JM2.mamba_decode(p, x, st, jcfg))(
        jmp, jnp.asarray(x).astype(jnp.dtype(dtype)),
        (jnp.asarray(conv.numpy()).astype(jnp.dtype(dtype)), jnp.asarray(ssm.numpy())))
    out, (conv2, ssm2) = M2.mamba_decode(mp, torch.from_numpy(x).to(DT[dtype]),
                                         (conv.to(DT[dtype]), ssm), cfg)
    _close(out, jout, dtype, "out")
    _close(conv2, jconv, dtype, "conv")
    _close(ssm2, jssm, dtype, "ssm")


def test_ssd_scan_matches_the_models_chunked_form():
    """ops.ssd_scan on the (B,H,T,P) views of the model's tensors equals the
    model's own chunked scan, the port's `_ssd_chunked`, and JAX's."""
    rng = np.random.default_rng(11)
    B, T, Hh, P, G, N, chunk = 2, 64, 4, 16, 1, 8, 32
    x = rng.standard_normal((B, T, Hh, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, T, Hh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(Hh) * 0.3).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, G, N)).astype(np.float32) * 0.5 for _ in range(2))
    t = torch.from_numpy
    y, s = ops.ssd_scan(t(x).transpose(1, 2), t(dt).transpose(1, 2), t(A),
                        t(Bm).transpose(1, 2), t(Cm).transpose(1, 2), chunk=chunk)
    y2, s2 = M2._ssd_chunked(t(x), t(dt), t(A), t(Bm), t(Cm), chunk)
    jy, js = jax.jit(JM2._ssd_chunked, static_argnums=5)(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk)
    np.testing.assert_allclose(y.transpose(1, 2).numpy(), y2.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), s2.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_jax(dtype):
    jcfg, jm, jp, cfg, m, p = _setup(dtype)
    toks = {"tokens": jnp.asarray(_tokens(cfg, 2, 32))}
    jlogits, jcache = jax.jit(jm.prefill)(jp, toks)
    jm32 = jax_build_model(jcfg.replace(param_dtype="float32"))
    jl32, jc32 = jax.jit(jm32.prefill)(_f32_params(jp), toks)
    logits, cache = m.prefill(p, {"tokens": torch.from_numpy(np.array(toks["tokens"]))})
    assert tuple(logits.shape) == jlogits.shape and logits.dtype == DT[dtype]
    _model_close(logits, jlogits, jl32, dtype, "logits")
    assert sorted(cache) == ["conv", "k", "ssm", "v"] == sorted(jcache)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        assert cache[name].dtype == (torch.float32 if name == "ssm" else DT[dtype]), name
        _model_close(cache[name], jcache[name], jc32[name], dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    """One decode step from the same cache, with one slot past the rolling
    window's end (pos >= W wraps to slot pos % W)."""
    jcfg, jm, jp, cfg, m, p = _setup(dtype)
    B, T, W = 3, 16, 20
    toks = _tokens(cfg, B, T)
    jlogits, jpc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    jcache = jm.init_cache(B, W)
    jcache = {"k": jcache["k"].at[:, :, :T].set(jpc["k"]),
              "v": jcache["v"].at[:, :, :T].set(jpc["v"]),
              "conv": jpc["conv"], "ssm": jpc["ssm"]}
    cache = bridge.cache_from_jax(jcache)
    batch = {"tokens": np.array(jnp.argmax(jlogits, -1), np.int32),
             "positions": np.array([T, T + 2, W + 3], np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jc = jax.jit(jm.decode_step)(jp, jcache, jbatch)
    jm32 = jax_build_model(jcfg.replace(param_dtype="float32"))
    jl32, jc32 = jax.jit(jm32.decode_step)(
        _f32_params(jp), jax.tree.map(lambda a: a.astype(jnp.float32), jcache), jbatch)
    logits, out = m.decode_step(p, cache, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert out is cache   # updated in place
    _model_close(logits, jl, jl32, dtype, "logits")
    for name in cache:
        _model_close(cache[name], jc[name], jc32[name], dtype, name)


def test_decode_consistency_with_prefill_path():
    """The port of tests/test_models_smoke.py::
    test_zamba2_decode_consistency_with_prefill_path: stepwise decode from an
    empty cache equals the parallel (chunked-SSD) prefill at the last
    position."""
    _, jm, jp, cfg, m, p = _setup("bfloat16", seed=3)
    B, T = 2, 16
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(4), (B, T), 0, cfg.vocab_size, jnp.int32)))
    logits_par, _ = m.prefill(p, {"tokens": toks})
    cache = m.init_cache(B, T)
    pos = torch.zeros(B, dtype=torch.int32)
    for t in range(T):
        dec, cache = m.decode_step(p, cache, {"tokens": toks[:, t:t + 1], "positions": pos})
        pos = pos + 1
    np.testing.assert_allclose(_f32(dec[:, 0]), _f32(logits_par[:, -1]), atol=3e-2, rtol=3e-2)


def test_backbone_matches_jax():
    jcfg, _, jp, cfg, _, p = _setup("float32", seed=1)
    B, T = 2, 32
    toks = _tokens(cfg, B, T, seed=5)
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    x = H.backbone_fwd(p, L.embed(p["embed"], torch.from_numpy(toks)), positions, cfg)
    jpos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    jx, _ = jax.jit(lambda p, x: JH.backbone_fwd(p, x, jpos, jcfg, remat=False))(
        jp, JL.embed(jp["embed"], jnp.asarray(toks)))
    _close(x, jx, "float32")


# ------------------------------------------------------------- init and bridge

def test_init_params_and_cache_match_jax_shapes():
    cfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH, smoke=True)
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
    """The doubly stacked mamba2 blocks become nb lists of attn_every dicts
    and stack back exactly; the four cache leaves cross both ways."""
    _, jm, jp, cfg, _, p = _setup(dtype)
    assert len(p["mamba"]) == cfg.n_layers // cfg.hybrid.attn_every
    assert all(len(sb) == cfg.hybrid.attn_every for sb in p["mamba"])
    np.testing.assert_array_equal(_f32(p["mamba"][1][0]["w_zx"]),
                                  np.asarray(jp["mamba"]["w_zx"][1, 0], np.float32))
    back = bridge.params_to_numpy(p)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jp, back)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    jcache = {k: v + 1 for k, v in jm.init_cache(2, 4).items()}
    back = bridge.cache_to_numpy(bridge.cache_from_jax(jcache))
    for k in jcache:
        assert back[k].dtype == jcache[k].dtype
        np.testing.assert_array_equal(back[k], np.asarray(jcache[k]))
