"""The port's training path (src/repro_torch: layers.softmax_xent,
models/flash_vjp.py, dense.lm_loss, optim/optimizers.py, train/steps.py,
bridge's train state) against the JAX package, on the CPU at SMOKE size.

Both sides take the same inputs: numpy arrays from a seed, and JAX-initialised
weights handed over by `repro_torch.bridge`. The JAX package runs read-only.
Tolerances, with their reasons (all fp32):
  * softmax_xent, the flash VJP's output, lse and (dq, dk, dv): atol=rtol=1e-5
    (fp32 rounding with sums in another order);
  * lm_loss: 1e-5 relative; each gradient leaf: 1e-4 relative L2 (the
    gradients of a few layers sum more terms in another order; the observed
    gap is about 1e-6);
  * remat on and off: bit-identical gradients (the same ops again);
  * one optimizer update from the same (params, grads, state):
    atol=rtol=1e-6 (one update's rounding), on the dense, hybrid, xLSTM
    (also in a variant whose super-blocks hold more than one mLSTM block),
    whisper and VLM SMOKE configs;
  * one microbatched train step: loss, grad_norm and lr to 1e-5 relative;
    the new params to atol 1e-6, except where the JAX gradient is below
    1e-7 in magnitude: AdamW's first step moves an entry by lr * g / (|g| +
    1e-8), so near g = 0 the two sides' gradient rounding (about 1e-9 here)
    can flip that by up to 2 lr, and those entries are held to 2 lr + 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import flash_vjp as JF
from repro.models import layers as JL
from repro.optim import optimizers as JO
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import dense as D
from repro_torch.models import flash_vjp as F
from repro_torch.models import layers as L
from repro_torch.optim import optimizers as O
from repro_torch.train import steps as S
from repro_torch.tree import flatten, leaves, unflatten_like

DENSE = ["llama3-8b", "granite-8b", "qwen1.5-32b", "stablelm-12b"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_trees_close(got, want, **tol):
    """got: the port's tree; want: the same tree in the JAX layout (numpy)."""
    want = dict(flatten(want))
    got = dict(flatten(got))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path in got:
        np.testing.assert_allclose(_np(got[path]), _np(want[path]), err_msg=str(path), **tol)


# the frames whisper's stub frontend hands the encoder in a training batch
# (any length trains; serving's cross cache holds ENC_LEN)
ENC_FRAMES = 24


def _batch(cfg, B, T, seed=1):
    """Tokens and next-token targets, and the frontend's embeddings where the
    family takes them: whisper's ENC_FRAMES frames, the VLM's n_patches
    patches (the first positions)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}
    if cfg.family == "audio":
        batch["enc_embeds"] = rng.standard_normal((B, ENC_FRAMES, cfg.d_model)) \
            .astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((B, cfg.vlm.n_patches, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _slstm_every_3(cfg):
    return cfg.replace(n_layers=6, xlstm=dataclasses.replace(cfg.xlstm, slstm_every=3))


# SMOKE variants, each a change made alike to both packages' SMOKE config.
# xlstm SMOKE's super-blocks hold one mLSTM block (slstm_every=2), so its
# (nb, 1, d) mLSTM leaves are not factored; with slstm_every=3 they are
# (nb, 2, d), which the reference's Adafactor factors over the inner axis and
# maps over nb, as it does the full-size (3, 7, 1024) leaves.
VARIANTS = {"xlstm-350m:slstm_every=3": ("xlstm-350m", _slstm_every_3)}


def _configs(arch):
    """(JAX config, the port's config) of a SMOKE config or variant, fp32."""
    base, change = VARIANTS.get(arch, (arch, lambda c: c))
    return tuple(change(config(base, smoke=True)).replace(param_dtype="float32")
                 for config in (jax_get_config, get_config))


def _setup(arch, seed=0):
    jcfg, cfg = _configs(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jm, jp, cfg, build_model(cfg, device="cpu"), bridge.params_from_jax(jp)


# ---------------------------------------------------------------- softmax_xent

@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    got = L.softmax_xent(torch.from_numpy(logits), torch.from_numpy(targets),
                         None if mask is None else torch.from_numpy(mask))
    want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(targets),
                           None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_softmax_xent_empty_mask_divides_by_one():
    logits = torch.zeros(1, 2, 4)
    got = L.softmax_xent(logits, torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, 2))
    assert float(got) == 0.0


# ---------------------------------------------------------------- flash VJP

FLASH_CASES = [  # (Hq, Hkv, causal, window)
    (4, 2, True, None),
    (4, 2, True, 24),
    (4, 2, False, None),
    (2, 2, False, 24),
]


def _qkv(B, T, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, h, D)).astype(np.float32) for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("Hq,Hkv,causal,window", FLASH_CASES)
def test_flash_vjp_matches_jax(Hq, Hkv, causal, window):
    """T=64 with blocks of 16: the tile loop runs, and the causal and window
    footprints skip tiles."""
    B, T, Dh, blk = 2, 64, 16, 16
    q, k, v = _qkv(B, T, Hq, Hkv, Dh)
    do = np.random.default_rng(1).standard_normal((B, T, Hq, Dh)).astype(np.float32)

    def jf(q, k, v):
        return JF.flash_attention_vjp(q, k, v, causal, window, 0, blk, blk)
    jout, jvjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = jvjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = F.flash_attention_vjp(tq, tk, tv, causal=causal, window=window,
                                block_q=blk, block_k=blk)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("Hq,Hkv,causal,window", FLASH_CASES)
def test_flash_plain_lse_matches_jax_forward(Hq, Hkv, causal, window):
    B, T, Dh, blk = 2, 64, 16, 16
    q, k, v = _qkv(B, T, Hq, Hkv, Dh, seed=2)
    jout, jlse = JF._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                              window, 0, blk, blk)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    out, lse = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                   return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, T)
    # the reference's (B, nq, Hkv, R, bq) residual, as (B, Hq, T)
    want = np.asarray(jlse).transpose(0, 2, 3, 1, 4).reshape(B, Hq, T)
    np.testing.assert_allclose(_np(lse), want, **TOL)
    np.testing.assert_allclose(_np(out.transpose(1, 2)), np.asarray(jout), **TOL)


def test_flash_vjp_bf16_returns_input_dtypes():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
               for a in _qkv(1, 32, 4, 2, 16))
    F.flash_attention_vjp(q, k, v, block_q=16, block_k=16).float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


def test_flash_vjp_rejects_ragged_blocks():
    q = torch.zeros(1, 48, 2, 16)
    with pytest.raises(ValueError, match="multiples"):
        F.flash_attention_vjp(q, q, q, block_q=32, block_k=32)


def test_attention_takes_the_vjp_only_under_autograd(monkeypatch):
    """Serving (no grad) calls ops.flash_attention without lse; training
    goes through the Function."""
    cfg = get_config("llama3-8b", smoke=True).replace(param_dtype="float32")
    p = D.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")["layers"][0]
    x = torch.randn(1, 8, cfg.d_model)
    pos = torch.arange(8).expand(1, 8)
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("return_lse", False))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    with torch.no_grad():
        L.attention(p["attn"], x, pos, cfg)
    wq = p["attn"]["wq"].requires_grad_()
    out, _ = L.attention(p["attn"], x, pos, cfg)
    assert out.grad_fn is not None and wq.requires_grad
    assert calls == [False, True]


# ---------------------------------------------------------------- grad guard

@pytest.mark.parametrize("name", sorted(ops.NO_BACKWARD))
def test_grad_guard_raises_for_an_input_that_requires_grad(name):
    """The condition each CUDA wrapper checks before its launch (the launch
    itself is tested on the card, tests/test_torch_cuda.py)."""
    plain, live = torch.zeros(2), torch.zeros(2, requires_grad=True)
    ops.check_no_grad(name, plain, None)
    with torch.no_grad():
        ops.check_no_grad(name, plain, live)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.check_no_grad(name, plain, live)


# ---------------------------------------------------------------- lm_loss

def _jax_loss_and_grads(jm, jp, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, metrics, grads


def _torch_loss_and_grads(m, p, batch, **kw):
    live = [t.requires_grad_() for t in leaves(p)]
    loss, metrics = D.lm_loss(p, _torch_batch(batch), m.cfg, **kw) if kw \
        else m.loss(p, _torch_batch(batch))
    grads = torch.autograd.grad(loss, live)
    for t in live:
        t.requires_grad_(False)
    return loss, metrics, grads


@pytest.mark.parametrize("arch", DENSE + ["phi3.5-moe-42b-a6.6b"])
def test_lm_loss_and_grads_match_jax(arch):
    jm, jp, cfg, m, p = _setup(arch)
    batch = _batch(cfg, 2, 16)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jm, jp, batch)
    loss, metrics, grads = _torch_loss_and_grads(m, p, batch)
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(metrics["xent"]), np.asarray(jmetrics["xent"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(metrics["aux"]), np.asarray(jmetrics["aux"]),
                               rtol=1e-5, atol=1e-7)
    jflat = dict(flatten(bridge.params_to_numpy(p)))   # the port's paths, JAX layout
    want = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    got = dict(flatten(bridge.params_to_numpy(
        unflatten_like(p, [g.detach() for g in grads]))))
    assert sorted(got, key=str) == sorted(want, key=str) == sorted(jflat, key=str)
    for path in got:
        assert _rel_l2(got[path], want[path]) <= 1e-4, (path, _rel_l2(got[path], want[path]))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b"])
def test_remat_gives_bit_identical_gradients(arch):
    _, _, cfg, m, p = _setup(arch)
    batch = _batch(cfg, 2, 16)
    l_on, _, g_on = _torch_loss_and_grads(m, p, batch, remat=True)
    l_off, _, g_off = _torch_loss_and_grads(m, p, batch, remat=False)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


# ---------------------------------------------------------------- optimizers

def _grads_like(jp, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 1e-2), jp)


def _opt_pair(name):
    return JO.make_optimizer(name), O.make_optimizer(name)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b", "zamba2-2.7b", "xlstm-350m",
                                  "xlstm-350m:slstm_every=3", "whisper-tiny",
                                  "internvl2-76b"])
def test_optimizer_update_matches_jax(arch, name):
    """Two updates from the same (params, grads, state): the second starts
    from nonzero moments. llama's and qwen's per-layer norms (and qwen's
    qkv biases) are Adafactor's stacked-1-D leaves; zamba2's mamba2 leaves
    and xLSTM's mLSTM leaves are stacked on two axes, and Adafactor groups
    them by super-block; whisper stacks its encoder and decoder layers
    apart; the VLM's layers are the dense family's."""
    _, jp, cfg, _, _ = _setup(arch)
    jopt, opt = _opt_pair(name)
    jstate = jopt.init(jp)
    state = bridge.train_state_from_jax({"params": jp, "opt": jstate,
                                         "step": jnp.zeros((), jnp.int32)})
    p, ostate = state["params"], state["opt"]
    lr = 1e-3
    for it in range(2):
        jg = _grads_like(jp, seed=3 + it)
        g = bridge.params_from_jax(jg)
        jp, jstate, jstats = jopt.update(jp, jg, jstate, jnp.float32(lr))
        p, ostate, stats = opt.update(p, g, ostate, torch.tensor(lr, dtype=torch.float32))
        np.testing.assert_allclose(_np(stats["grad_norm"]), np.asarray(jstats["grad_norm"]),
                                   rtol=1e-6)
        got = bridge.train_state_to_numpy({"params": p, "opt": ostate,
                                           "step": torch.zeros((), dtype=torch.int32)})
        _assert_trees_close(got["params"], jax.tree.map(np.asarray, jp), atol=1e-6, rtol=1e-6)
        _assert_trees_close(got["opt"], jax.tree.map(np.asarray, jstate), atol=1e-6,
                            rtol=1e-6)


def test_adafactor_groups_layer_leaves_as_the_stacked_reference():
    """The trap: a per-layer (d,) leaf is one factored (L, d) leaf in the
    reference; a (d, f) leaf is updated per layer."""
    _, jp, _, _, p = _setup("qwen1.5-32b")
    s = O.adafactor().init(p)["s"]
    L_ = len(p["layers"])
    d = p["layers"][0]["ln1"].shape[0]
    assert s["layers_stacked"]["ln1"]["vr"].shape == (L_,)
    assert s["layers_stacked"]["ln1"]["vc"].shape == (d,)
    assert set(s["layers_stacked"]["attn"]) == {"bq", "bk", "bv"}
    wq = p["layers"][0]["attn"]["wq"]
    assert s["layers"][0]["attn"]["wq"]["vr"].shape == wq.shape[:1]
    assert s["layers"][0]["attn"]["wq"]["vc"].shape == wq.shape[1:]
    assert "ln1" not in s["layers"][0]
    assert s["final_norm"]["v"].shape == (d,)


def test_clip_by_global_norm_matches_jax():
    _, jp, _, _, _ = _setup("llama3-8b")
    jg = jax.tree.map(lambda a: a * 10.0, _grads_like(jp))
    for max_norm in (0.5, 1e6):
        want, jn = JO.clip_by_global_norm(jg, max_norm)
        got, n = O.clip_by_global_norm(bridge.params_from_jax(jg), max_norm)
        np.testing.assert_allclose(_np(n), np.asarray(jn), rtol=1e-6)
        _assert_trees_close(bridge.params_to_numpy(got), jax.tree.map(np.asarray, want),
                            atol=1e-7, rtol=1e-6)


def test_warmup_cosine_matches_jax():
    jlr, lr = JO.warmup_cosine(3e-4, 10, 100), O.warmup_cosine(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(jlr(jnp.int32(step))), rtol=1e-6,
                                   atol=0)


# ---------------------------------------------------------------- train step

def test_microbatched_train_step_matches_jax():
    jm, jp, cfg, m, _ = _setup("llama3-8b")
    batch = _batch(cfg, 4, 16, seed=5)
    jopt, opt = _opt_pair("adamw")
    jlr, lr = JO.warmup_cosine(1e-3, 10, 100), O.warmup_cosine(1e-3, 10, 100)
    # step 5: a nonzero learning rate
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.int32(5)}
    state = bridge.train_state_from_jax(jstate)
    jnew, jmetrics = jax.jit(JS.make_train_step(jm, jopt, jlr, n_microbatches=2))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, metrics = S.make_train_step(m, opt, lr, n_microbatches=2)(state, _torch_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(jmetrics[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    assert int(new["step"]) == 6 and int(new["opt"]["step"]) == 1

    _, _, jgrads = _jax_loss_and_grads(jm, jp, batch)
    near_zero = dict(flatten(jax.tree.map(lambda g: np.abs(np.asarray(g)) < 1e-7, jgrads)))
    got = dict(flatten(bridge.params_to_numpy(new["params"])))
    want = dict(flatten(jax.tree.map(np.asarray, jnew["params"])))
    step_lr = float(jmetrics["lr"])
    for path, w in want.items():
        err = np.abs(_np(got[path]) - w)
        bound = np.where(near_zero[path], 2 * step_lr + 1e-6, 1e-6)
        assert np.all(err <= bound), (path, float(err.max()))


def test_train_state_round_trip_is_exact():
    """JAX -> port -> numpy gives back the JAX train state exactly, for
    AdamW and for Adafactor (after one update, so no leaf is all zeros)."""
    for arch in ("llama3-8b", "qwen1.5-32b"):
        _, jp, _, _, _ = _setup(arch)
        for name in ("adamw", "adafactor"):
            jopt = JO.make_optimizer(name)
            jp1, jopt_state, _ = jopt.update(jp, _grads_like(jp), jopt.init(jp),
                                             jnp.float32(1e-3))
            jstate = {"params": jp1, "opt": jopt_state, "step": jnp.int32(7)}
            back = bridge.train_state_to_numpy(bridge.train_state_from_jax(jstate))
            want = dict(flatten(jax.tree.map(np.asarray, jstate)))
            got = dict(flatten(back))
            assert sorted(got, key=str) == sorted(want, key=str), name
            for path in want:
                assert got[path].dtype == want[path].dtype, path
                np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))
