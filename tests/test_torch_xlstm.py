"""The port's xLSTM family (src/repro_torch/models/xlstm.py,
kernels/ref.py::mlstm_ref) against the JAX package on the xlstm SMOKE
config, on the CPU.

Both sides run the same weights (JAX initialises them, `repro_torch.bridge`
hands them over: the mLSTM blocks doubly stacked (nb, slstm_every - 1) on
the JAX side, the sLSTM blocks stacked nb) and the same numpy-seeded
inputs. No kernel runs on either side: the reference's xLSTM is jnp.
Tolerances, with their reasons:
  * fp32 logits, states and block outputs: atol=rtol=1e-5 (float rounding,
    with sums in another order);
  * the chunked mLSTM against the sequential recurrence (`mlstm_ref`, on
    either side): atol=rtol=3e-4, as tests/test_kernels.py::
    test_mlstm_chunked_matches_sequential states for the JAX pair (another
    stabilizer at each step, exps of sums taken in another order);
  * one block at bf16: atol=rtol=2e-2 (bf16 rounding, as
    tests/test_kernels.py states);
  * the whole bf16 model: no further from JAX's fp32 run (relative L2) than
    NOISE_FACTOR times JAX's own bf16 run, as tests/test_torch_hybrid.py
    gates its bf16 model (rounding flips grow over depth on both sides);
  * decode replayed over the prompt against the chunked prefill, fp32:
    1e-5 relative L2, for the model's last logits (observed 1.0e-6 at
    T = 16 and 256) and for each block's output (chip_smoke.py's phase 9b
    holds each block of the full-width model to the same bound);
  * lm_loss 1e-5 relative, each gradient leaf 1e-4 relative L2, as
    tests/test_torch_train.py holds the dense family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as JR
from repro.models import build_model as jax_build_model
from repro.models import xlstm as JX
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import xlstm as X
from repro_torch.tree import flatten, leaves, unflatten_like

ARCH = "xlstm-350m"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NOISE_FACTOR = 2.0
SEQ_TOL = dict(atol=3e-4, rtol=3e-4)
CACHE_KEYS = ["m_C", "m_m", "m_n", "s_c", "s_h", "s_m", "s_n"]


def _setup(dtype, seed=0):
    jcfg = jax_get_config(ARCH, smoke=True).replace(param_dtype=dtype)
    cfg = get_config(ARCH, smoke=True).replace(param_dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jcfg, jm, jp, cfg, build_model(cfg, device="cpu"), bridge.params_from_jax(jp)


def _tokens(cfg, B, T, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, dtype, name=""):
    np.testing.assert_allclose(_f32(got), _f32(want), err_msg=name, **TOL[dtype])


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


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


def _mlstm_inputs(B, T, H, Dh, seed=3):
    """The distributions of tests/test_kernels.py: forget preacts near +3."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, Dh)).astype(np.float32) for _ in range(3))
    ig = rng.standard_normal((B, T, H)).astype(np.float32)
    fg = rng.standard_normal((B, T, H)).astype(np.float32) + 3.0
    lf = np.array(jax.nn.log_sigmoid(jnp.asarray(fg)))
    return q, k, v, ig, lf


# ------------------------------------------------------------- the chunked mLSTM

@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunked_matches_jax_and_the_sequential_ref(chunk):
    """_mlstm_chunked equals JAX's at every chunk length, and both equal the
    sequential recurrence (chunk invariance); the port's mlstm_ref equals
    JAX's."""
    arrays = _mlstm_inputs(2, 64, 2, 16)
    got = X._mlstm_chunked(*map(torch.from_numpy, arrays), chunk)
    want = jax.jit(JX._mlstm_chunked, static_argnums=5)(*map(jnp.asarray, arrays), chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), np.asarray(want), **TOL["float32"])
    seq = ref.mlstm_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(_f32(got), _f32(seq), **SEQ_TOL)
    np.testing.assert_allclose(_f32(seq), np.asarray(JR.mlstm_ref(*map(jnp.asarray, arrays))),
                               **TOL["float32"])


def test_mlstm_fwd_refuses_a_ragged_chunk():
    """T must be a multiple of min(256, T), as the JAX model asserts."""
    _, _, _, cfg, _, p = _setup("float32")
    with pytest.raises(ValueError, match="chunk"):
        X.mlstm_fwd(p["mlstm"][0][0], torch.zeros(1, 300, cfg.d_model), cfg)


# ------------------------------------------------------------- the blocks

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_block_matches_jax(dtype):
    """The block's forward (T=32: one chunk) and one decode step from a
    random state."""
    jcfg, _, jp, cfg, _, p = _setup(dtype)
    jmp, mp = jax.tree.map(lambda t: t[1, 0], jp["mlstm"]), p["mlstm"][1][0]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    jout = jax.jit(lambda p, x: JX.mlstm_fwd(p, x, jcfg))(jmp, jnp.asarray(x).astype(dtype))
    out = X.mlstm_fwd(mp, torch.from_numpy(x).to(DT[dtype]), cfg)
    assert out.dtype == DT[dtype]
    _close(out, jout, dtype, "fwd")

    _, H, Dh = X._mlstm_dims(cfg)
    state = (rng.standard_normal((2, H, Dh, Dh)).astype(np.float32) * 0.1,
             rng.standard_normal((2, H, Dh)).astype(np.float32) * 0.1,
             rng.standard_normal((2, H)).astype(np.float32))
    x1 = x[:, :1]
    jout, jstate = jax.jit(lambda p, x, s: JX.mlstm_decode(p, x, s, jcfg))(
        jmp, jnp.asarray(x1).astype(dtype), tuple(map(jnp.asarray, state)))
    out, st = X.mlstm_decode(mp, torch.from_numpy(x1).to(DT[dtype]),
                             tuple(map(torch.from_numpy, state)), cfg)
    _close(out, jout, dtype, "decode")
    for name, a, b in zip("Cnm", st, jstate):
        assert a.dtype == torch.float32
        _close(a, b, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_block_matches_jax(dtype):
    """The sequential forward over T=24 (the GeGLU FFN's tanh gelu too) and
    one decode step from a random state."""
    jcfg, _, jp, cfg, _, p = _setup(dtype)
    jsp, sp = jax.tree.map(lambda t: t[1], jp["slstm"]), p["slstm"][1]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jout = jax.jit(lambda p, x: JX.slstm_fwd(p, x, jcfg))(jsp, jnp.asarray(x).astype(dtype))
    out = X.slstm_fwd(sp, torch.from_numpy(x).to(DT[dtype]), cfg)
    _close(out, jout, dtype, "fwd")

    shape = (2, cfg.n_heads, cfg.d_model // cfg.n_heads)
    c, n, m, h = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    # n sums positive input-gate weights, so a reachable state has n > 0
    # (h divides by n)
    state = (c, np.abs(n) + 0.5, m, h)
    jout, jstate = jax.jit(lambda p, x, s: JX.slstm_decode(p, x, s, jcfg))(
        jsp, jnp.asarray(x[:, :1]).astype(dtype), tuple(map(jnp.asarray, state)))
    out, st = X.slstm_decode(sp, torch.from_numpy(x[:, :1]).to(DT[dtype]),
                             tuple(map(torch.from_numpy, state)), cfg)
    _close(out, jout, dtype, "decode")
    for name, a, b in zip(("c", "n", "m", "h"), st, jstate):
        _close(a, b, dtype, name)


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_jax_and_the_cache_is_empty_as_jax_s(dtype):
    """The JAX lm_prefill returns empty recurrent states (init_cache), not
    the prompt's; so does the port's, leaf for leaf."""
    jcfg, jm, jp, cfg, m, p = _setup(dtype)
    toks = _tokens(cfg, 2, 64)
    jlogits, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    jl32, _ = jax.jit(jax_build_model(jcfg.replace(param_dtype="float32")).prefill)(
        _f32_params(jp), {"tokens": jnp.asarray(toks)})
    logits, cache = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    assert tuple(logits.shape) == jlogits.shape and logits.dtype == DT[dtype]
    _model_close(logits, jlogits, jl32, dtype, "logits")
    assert sorted(cache) == CACHE_KEYS == sorted(jcache)
    empty = jm.init_cache(2)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
        assert cache[name].dtype == torch.float32
        np.testing.assert_array_equal(_f32(cache[name]), np.asarray(jcache[name]), name)
        np.testing.assert_array_equal(np.asarray(jcache[name]), np.asarray(empty[name]), name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """Four decode steps from the empty cache, fed the same tokens; the
    cache is updated in place."""
    jcfg, jm, jp, cfg, m, p = _setup(dtype)
    jm32 = jax_build_model(jcfg.replace(param_dtype="float32"))
    jp32 = _f32_params(jp)
    toks = _tokens(cfg, 3, 4, seed=2)
    jcache, jc32 = jm.init_cache(3), jm32.init_cache(3)
    cache = m.init_cache(3)
    for t in range(4):
        batch = {"tokens": toks[:, t:t + 1], "positions": np.full(3, t, np.int32)}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jl, jcache = jax.jit(jm.decode_step)(jp, jcache, jbatch)
        jl32, jc32 = jax.jit(jm32.decode_step)(jp32, jc32, jbatch)
        logits, out = m.decode_step(p, cache, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert out is cache
        _model_close(logits, jl, jl32, dtype, f"logits {t}")
        for name in cache:
            _model_close(cache[name], jcache[name], jc32[name], dtype, f"{name} {t}")


def test_decode_replay_equals_the_chunked_prefill():
    """The port of tests/test_models_smoke.py::test_decode_matches_full_forward
    for xlstm: decode from the empty cache over the prompt ends at the
    parallel (chunked) prefill's last logits. T=256 runs one full chunk."""
    _, _, _, cfg, m, p = _setup("float32", seed=2)
    for T in (16, 256):
        toks = torch.from_numpy(_tokens(cfg, 2, T, seed=T))
        logits, _ = m.prefill(p, {"tokens": toks})
        cache = m.init_cache(2)
        for t in range(T):
            dec, cache = m.decode_step(p, cache, {"tokens": toks[:, t:t + 1]})
        assert _rel(dec[:, 0, :cfg.vocab_size], logits[:, -1, :cfg.vocab_size]) <= 1e-5, T


def test_each_block_s_two_forms_agree():
    """Each block of the SMOKE model, fed the chunked forward's hidden
    state over 64 tokens (one mLSTM chunk): its parallel output equals its
    decode step replayed over the same input from the empty state, to 1e-5
    relative L2 (chip_smoke.py's XLSTM_BLOCK_L2 holds the full-width model's
    blocks to the same bound)."""
    _, _, _, cfg, m, p = _setup("float32", seed=4)
    toks = torch.from_numpy(_tokens(cfg, 2, 64, seed=9))
    empty = m.init_cache(2)
    x = L.embed(p["embed"], toks)

    def replay(step, block, state):
        ys = []
        for t in range(x.shape[1]):
            y, state = step(block, x[:, t:t + 1], state, cfg)
            ys.append(y)
        return torch.cat(ys, dim=1)
    for a, (blocks, sp) in enumerate(zip(p["mlstm"], p["slstm"])):
        for j, mp in enumerate(blocks):
            y = X.mlstm_fwd(mp, x, cfg)
            state = tuple(empty[k][a, j] for k in ("m_C", "m_n", "m_m"))
            assert _rel(replay(X.mlstm_decode, mp, state), y) <= 1e-5, ("mlstm", a, j)
            x = y
        y = X.slstm_fwd(sp, x, cfg)
        state = tuple(empty[k][a] for k in ("s_c", "s_n", "s_m", "s_h"))
        assert _rel(replay(X.slstm_decode, sp, state), y) <= 1e-5, ("slstm", a)
        x = y


def _jax_loss_and_grads(jm, jp, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, metrics, grads


def _loss_and_grads(m, p, batch, **kw):
    live = [t.requires_grad_() for t in leaves(p)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = X.lm_loss(p, tb, m.cfg, **kw) if kw else m.loss(p, tb)
    grads = torch.autograd.grad(loss, live)
    for t in live:
        t.requires_grad_(False)
    return loss, metrics, grads


def test_lm_loss_and_grads_match_jax():
    """T=32 (one chunk), with a loss mask: the loss and every gradient leaf,
    in the JAX layout."""
    _, jm, jp, cfg, m, p = _setup("float32")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy(),
             "loss_mask": (rng.random((2, 32)) > 0.2).astype(np.float32)}
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jm, jp, batch)
    loss, metrics, grads = _loss_and_grads(m, p, batch)
    np.testing.assert_allclose(_f32(loss), np.asarray(jloss), rtol=1e-5, atol=0)
    np.testing.assert_allclose(_f32(metrics["xent"]), np.asarray(jmetrics["xent"]),
                               rtol=1e-5, atol=0)
    want = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    got = dict(flatten(bridge.params_to_numpy(unflatten_like(p, [g.detach() for g in grads]))))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path in got:
        assert _rel(got[path], want[path]) <= 1e-4, (path, _rel(got[path], want[path]))


def test_remat_gives_bit_identical_gradients():
    _, _, _, cfg, m, p = _setup("float32")
    toks = _tokens(cfg, 2, 17, seed=7)
    batch = {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}
    l_on, _, g_on = _loss_and_grads(m, p, batch, remat=True)
    l_off, _, g_off = _loss_and_grads(m, p, batch, remat=False)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


# ------------------------------------------------------------- init and bridge

def test_init_params_and_cache_match_jax_shapes():
    cfg, jcfg = get_config(ARCH, smoke=True), jax_get_config(ARCH, smoke=True)
    m, jm = build_model(cfg, device="cpu"), jax_build_model(jcfg)
    p = bridge.params_to_numpy(m.init_params(torch.Generator().manual_seed(0)))
    jp = jm.init_params(jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), p) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    cache, jcache = m.init_cache(3), jm.init_cache(3)
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in cache.items()} == \
        {k: (a.shape, str(a.dtype)) for k, a in jcache.items()}
    for name in cache:
        np.testing.assert_array_equal(_f32(cache[name]), np.asarray(jcache[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    """The doubly stacked mLSTM blocks become nb lists of slstm_every - 1
    dicts, the sLSTM blocks a list of nb, and both stack back exactly; the
    seven state leaves cross both ways."""
    _, jm, jp, cfg, _, p = _setup(dtype)
    nb = cfg.n_layers // cfg.xlstm.slstm_every
    assert len(p["mlstm"]) == len(p["slstm"]) == nb
    assert all(len(sb) == cfg.xlstm.slstm_every - 1 for sb in p["mlstm"])
    np.testing.assert_array_equal(_f32(p["mlstm"][1][0]["w_up"]),
                                  np.asarray(jp["mlstm"]["w_up"][1, 0], np.float32))
    back = bridge.params_to_numpy(p)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jp, back)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    jcache = {k: v + 1 for k, v in jm.init_cache(2).items()}
    back = bridge.cache_to_numpy(bridge.cache_from_jax(jcache))
    assert sorted(back) == CACHE_KEYS
    for k in jcache:
        assert back[k].dtype == jcache[k].dtype
        np.testing.assert_array_equal(back[k], np.asarray(jcache[k]))
