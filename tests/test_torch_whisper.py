"""The port's whisper family (src/repro_torch/models/whisper.py, and
cross-attention in models/layers.py and models/flash_vjp.py) against the
JAX package on the whisper SMOKE config, on the CPU.

Both sides run the same weights (JAX initialises them, `repro_torch.bridge`
hands them over, the encoder and decoder layers stacked on the JAX side)
and the same numpy-seeded tokens and frame embeddings. On the CPU the
port's attention runs the plain versions of the kernels; the JAX model runs
`flash_attention_ref` (its flash VJP under autodiff). Tolerances, with their
reasons:
  * fp32 logits, caches, encoder output and attention: atol=rtol=1e-5
    (float rounding, with sums in another order);
  * the flash VJP at Tq != Tk: its output and (dq, dk, dv) to 1e-5 against
    JAX's and against autograd through `ref.attention_ref`, as
    tests/test_torch_train.py holds it at Tq == Tk;
  * one attention layer at bf16: atol=rtol=2e-2 (bf16 rounding);
  * the whole bf16 model: no further from JAX's fp32 run (relative L2) than
    NOISE_FACTOR times JAX's own bf16 run, as tests/test_torch_hybrid.py
    gates its bf16 model;
  * lm_loss 1e-5 relative, each gradient leaf 1e-4 relative L2, as
    tests/test_torch_train.py holds the dense family.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import flash_vjp as JF
from repro.models import layers as JL
from repro.models import whisper as JW
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.models import flash_vjp as F
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.tree import flatten, leaves, unflatten_like

ARCH = "whisper-tiny"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NOISE_FACTOR = 2.0
CACHE_KEYS = ["cross_k", "cross_v", "k", "v"]


def _setup(dtype, seed=0):
    jcfg = jax_get_config(ARCH, smoke=True).replace(param_dtype=dtype)
    cfg = get_config(ARCH, smoke=True).replace(param_dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jcfg, jm, jp, cfg, build_model(cfg, device="cpu"), bridge.params_from_jax(jp)


def _batch(cfg, B, T, Te, seed=1, targets=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(),
             "enc_embeds": rng.standard_normal((B, Te, cfg.d_model)).astype(np.float32)}
    if targets:
        batch["targets"] = toks[:, 1:].copy()
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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


def _jax32(jcfg, jp):
    return (jax_build_model(jcfg.replace(param_dtype="float32")),
            jax.tree.map(lambda a: a.astype(jnp.float32), jp))


# ------------------------------------------------------------- cross-attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(dtype):
    """attention(..., cross_kv=(k, v)): q projected and not roped, attention
    over 48 given keys from 16 queries, non-causal; no k/v returned."""
    jcfg, _, jp, cfg, _, p = _setup(dtype)
    jap, ap = jax.tree.map(lambda t: t[0], jp["dec_layers"]["cross"]), \
        p["dec_layers"][0]["cross"]
    rng = np.random.default_rng(2)
    hd = cfg.resolved_head_dim
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((2, 48, cfg.n_kv_heads, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    jd = jnp.dtype(dtype)
    jout, jkv = JL.attention(jap, jnp.asarray(x).astype(jd), jnp.asarray(pos), jcfg,
                             cross_kv=(jnp.asarray(k).astype(jd), jnp.asarray(v).astype(jd)),
                             block_q=8, block_k=16)
    out, kv = L.attention(ap, torch.from_numpy(x).to(DT[dtype]), torch.from_numpy(pos), cfg,
                          cross_kv=(torch.from_numpy(k).to(DT[dtype]),
                                    torch.from_numpy(v).to(DT[dtype])))
    assert kv is None and jkv is None
    _close(out, jout, dtype)


@pytest.mark.parametrize("Hq,Hkv,Tq,Tk", [(4, 4, 16, 48), (4, 2, 32, 64), (2, 2, 48, 16)])
def test_cross_flash_vjp_at_unequal_lengths_matches_autograd(Hq, Hkv, Tq, Tk):
    """flash_attention_vjp(..., causal=False) with Tq != Tk and blocks of 16:
    the output and lse equal JAX's and the plain attention's, and (dq, dk,
    dv) equal jax.vjp of JAX's flash VJP and autograd through
    ref.attention_ref (non-causal, so the two packages' causal conventions
    for Tq != Tk do not enter)."""
    rng = np.random.default_rng(Tq + Tk)
    D, blk = 16, 16
    q = rng.standard_normal((2, Tq, Hq, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, Tk, Hkv, D)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((2, Tq, Hq, D)).astype(np.float32)

    jout, jvjp = jax.vjp(lambda q, k, v: JF.flash_attention_vjp(q, k, v, False, None, 0,
                                                                blk, blk),
                         *map(jnp.asarray, (q, k, v)))
    jgrads = jvjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = F.flash_attention_vjp(tq, tk, tv, causal=False, block_q=blk, block_k=blk)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(_f32(out), np.asarray(jout), **TOL["float32"])
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(_f32(got), np.asarray(want), err_msg=f"d{name}",
                                   **TOL["float32"])

    rq, rk, rv = (torch.from_numpy(a).transpose(1, 2).requires_grad_() for a in (q, k, v))
    want = ref.attention_ref(rq, rk, rv, causal=False)
    rgrads = torch.autograd.grad(want, (rq, rk, rv), torch.from_numpy(do).transpose(1, 2))
    np.testing.assert_allclose(_f32(out), _f32(want.transpose(1, 2)), **TOL["float32"])
    for name, got, w in zip("qkv", grads, rgrads):
        np.testing.assert_allclose(_f32(got), _f32(w.transpose(1, 2)), err_msg=f"d{name}",
                                   **TOL["float32"])
    _, lse = ops.flash_attention(*(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
                                 causal=False, return_lse=True)
    _, jlse = JF._fwd_impl(*map(jnp.asarray, (q, k, v)), False, None, 0, blk, blk)
    want_lse = np.asarray(jlse).transpose(0, 2, 3, 1, 4).reshape(2, Hq, Tq)
    np.testing.assert_allclose(_f32(lse), want_lse, **TOL["float32"])


# ------------------------------------------------------------- the model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    """The encoder: non-causal roped self-attention over 64 frames."""
    jcfg, _, jp, cfg, _, p = _setup(dtype)
    emb = _batch(cfg, 2, 8, 64)["enc_embeds"]
    jout = jax.jit(lambda p, e: JW.encode(p, e, jcfg))(jp, jnp.asarray(emb))
    out = W.encode(p, torch.from_numpy(emb), cfg)
    assert out.dtype == DT[dtype]
    jm32, jp32 = _jax32(jcfg, jp)
    jout32 = jax.jit(lambda p, e: JW.encode(p, e, jcfg.replace(param_dtype="float32")))(
        jp32, jnp.asarray(emb))
    _model_close(out, jout, jout32, dtype, "enc_out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_jax(dtype):
    """Encoder and decoder prefill over 96 frames and 16 tokens: the
    last-token logits, the self k/v and the cross k/v."""
    jcfg, jm, jp, cfg, m, p = _setup(dtype)
    batch = _batch(cfg, 2, 16, 96)
    jlogits, jcache = jax.jit(jm.prefill)(jp, _jax(batch))
    jm32, jp32 = _jax32(jcfg, jp)
    jl32, jc32 = jax.jit(jm32.prefill)(jp32, _jax(batch))
    logits, cache = m.prefill(p, _torch(batch))
    assert tuple(logits.shape) == jlogits.shape and logits.dtype == DT[dtype]
    _model_close(logits, jlogits, jl32, dtype, "logits")
    assert sorted(cache) == CACHE_KEYS == sorted(jcache)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape and cache[name].dtype == DT[dtype]
        _model_close(cache[name], jcache[name], jc32[name], dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """Three decode steps over the full ENC_LEN-row cross cache, from a
    prefill of 16 tokens copied into a cache of 20 rows; one sequence runs
    past the cache's end, where the store is dropped."""
    jcfg, jm, jp, cfg, m, p = _setup(dtype)
    jm32, jp32 = _jax32(jcfg, jp)
    B, T, S = 2, 16, 20
    batch = _batch(cfg, B, T, W.ENC_LEN, seed=3)
    jlogits, jpc = jax.jit(jm.prefill)(jp, _jax(batch))
    jcache = jm.init_cache(B, S)
    jcache = {"k": jcache["k"].at[:, :, :T].set(jpc["k"]),
              "v": jcache["v"].at[:, :, :T].set(jpc["v"]),
              "cross_k": jpc["cross_k"], "cross_v": jpc["cross_v"]}
    jc32 = jax.tree.map(lambda a: a.astype(jnp.float32), jcache)
    cache = bridge.cache_from_jax(jcache)
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    for i, pos in enumerate(([T, T], [T + 1, S - 1], [T + 2, S + 3])):
        step = {"tokens": tok, "positions": np.array(pos, np.int32)}
        jl, jcache = jax.jit(jm.decode_step)(jp, jcache, _jax(step))
        jl32, jc32 = jax.jit(jm32.decode_step)(jp32, jc32, _jax(step))
        logits, out = m.decode_step(p, cache, _torch(step))
        assert out is cache
        _model_close(logits, jl, jl32, dtype, f"logits {i}")
        for name in cache:
            _model_close(cache[name], jcache[name], jc32[name], dtype, f"{name} {i}")
        tok = np.array(jnp.argmax(jl, -1), np.int32)


def _jax_loss_and_grads(jm, jp, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, _jax(batch))
    return loss, metrics, grads


def _loss_and_grads(m, p, batch, **kw):
    live = [t.requires_grad_() for t in leaves(p)]
    loss, metrics = W.lm_loss(p, _torch(batch), m.cfg, **kw) if kw \
        else m.loss(p, _torch(batch))
    grads = torch.autograd.grad(loss, live)
    for t in live:
        t.requires_grad_(False)
    return loss, metrics, grads


def test_lm_loss_and_grads_match_jax():
    """16 tokens over 64 frames: the loss and every gradient leaf (encoder,
    decoder, cross-attention), in the JAX layout."""
    _, jm, jp, cfg, m, p = _setup("float32")
    batch = _batch(cfg, 2, 16, 64, seed=4, targets=True)
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
    batch = _batch(cfg, 2, 16, 32, seed=5, targets=True)
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
    cache, jcache = m.init_cache(3, 20), jm.init_cache(3, 20)
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in cache.items()} == \
        {k: (a.shape, str(a.dtype)) for k, a in jcache.items()}
    assert cache["cross_k"].shape[2] == W.ENC_LEN == JW.ENC_LEN


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    """The stacked encoder and decoder layers become lists of per-layer
    dicts and stack back exactly; the four cache leaves cross both ways."""
    _, jm, jp, cfg, _, p = _setup(dtype)
    assert len(p["enc_layers"]) == cfg.encdec.n_enc_layers
    assert len(p["dec_layers"]) == cfg.n_layers
    np.testing.assert_array_equal(_f32(p["dec_layers"][1]["cross"]["wq"]),
                                  np.asarray(jp["dec_layers"]["cross"]["wq"][1], np.float32))
    back = bridge.params_to_numpy(p)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jp, back)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    jcache = {k: v + 1 for k, v in jm.init_cache(2, 4).items()}
    back = bridge.cache_to_numpy(bridge.cache_from_jax(jcache))
    assert sorted(back) == CACHE_KEYS
    for k in jcache:
        assert back[k].dtype == jcache[k].dtype
        np.testing.assert_array_equal(back[k], np.asarray(jcache[k]))
