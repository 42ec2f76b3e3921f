"""The port's hybrid training path (src/repro_torch/models/mamba2.py::SSDScan,
hybrid.backbone_fwd under remat, hybrid.lm_loss, the train step and the
train state of the list-of-lists layout) against the JAX package on the
zamba2 SMOKE config, on the CPU.

Both sides take the same inputs: numpy arrays from a seed, and
JAX-initialised weights handed over by `repro_torch.bridge`. On the CPU the
port's SSD scan forward is the plain version of the kernel and its backward
differentiates the model's `_ssd_chunked`, as the JAX model differentiates
its own. Tolerances, with their reasons (all fp32):
  * SSDScan's outputs: atol=rtol=1e-5 (another order of sums); its
    gradients: 1e-4 relative L2 on every input (the backward sums many
    terms in another order; `jnp.clip`'s gradient at the decay's bound 0 is
    0.5 and `torch.clamp`'s 1, but there the same log decay enters with +
    and -, so the two cancel);
  * lm_loss 1e-5 relative, each gradient leaf 1e-4 relative L2, as
    tests/test_torch_train.py holds the dense family;
  * remat on and off: bit-identical (the same ops again);
  * one microbatched train step, AdamW and Adafactor:
    test_torch_moe_train.py's check_train_step_matches_jax; Adafactor's
    update on its own: tests/test_torch_train.py's
    test_optimizer_update_matches_jax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JM2
from repro.optim import optimizers as JO
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.models import hybrid as H
from repro_torch.models import mamba2 as M2
from repro_torch.optim import optimizers as O
from repro_torch.tree import flatten, leaves, unflatten_like
from test_torch_moe_train import check_train_step_matches_jax
from test_torch_train import (_batch, _grads_like, _jax_loss_and_grads, _np, _rel_l2,
                              _setup, _torch_batch)

ARCH = "zamba2-2.7b"


def _ssd_inputs(B, T, Hh, P, G, N, seed=0):
    """The model's (B,T,H,P) layout; the distributions of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((B, T, Hh, P)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, Hh)))).astype(f32)
    A = (-np.exp(rng.standard_normal(Hh) * 0.3)).astype(f32)
    Bm, Cm = ((rng.standard_normal((B, T, G, N)) * 0.5).astype(f32) for _ in range(2))
    return x, dt, A, Bm, Cm


SSD_CASES = [  # (B, T, H, P, G, N, chunk)
    (2, 64, 4, 8, 2, 8, 16),     # four chunks, two heads a group
    (1, 32, 2, 16, 1, 8, 32),    # one chunk
    (2, 96, 4, 16, 1, 16, 32),   # zamba2 SMOKE's widths and chunk, three chunks
]


@pytest.mark.parametrize("with_state_grad", [False, True])
@pytest.mark.parametrize("B,T,Hh,P,G,N,chunk", SSD_CASES)
def test_ssd_scan_vjp_matches_jax(B, T, Hh, P, G, N, chunk, with_state_grad):
    """SSDScan on the (B,H,T,P) views `mamba_fwd` passes, against jax.vjp of
    the reference's `_ssd_chunked`: y, the final state and the gradient of
    every input. Training takes no final state, so its gradient is absent
    (None) there; given, it enters the backward too."""
    arrays = _ssd_inputs(B, T, Hh, P, G, N, seed=T + Hh)
    rng = np.random.default_rng(7)
    dy = rng.standard_normal((B, T, Hh, P)).astype(np.float32)
    dS = rng.standard_normal((B, Hh, P, N)).astype(np.float32)

    (jy, jS), jvjp = jax.vjp(lambda *a: JM2._ssd_chunked(*a, chunk),
                             *map(jnp.asarray, arrays))
    jgrads = jvjp((jnp.asarray(dy), jnp.asarray(dS if with_state_grad else np.zeros_like(dS))))

    live = [torch.from_numpy(a).requires_grad_() for a in arrays]
    x, dt, A, Bm, Cm = live
    y, S_fin = M2.SSDScan.apply(x.transpose(1, 2), dt.transpose(1, 2), A,
                                Bm.transpose(1, 2), Cm.transpose(1, 2), chunk)
    np.testing.assert_allclose(_np(y.transpose(1, 2)), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(S_fin), np.asarray(jS), atol=1e-5, rtol=1e-5)
    outs, cots = [y.transpose(1, 2)], [torch.from_numpy(dy)]
    if with_state_grad:
        outs.append(S_fin)
        cots.append(torch.from_numpy(dS))
    grads = torch.autograd.grad(outs, live, cots)
    for name, got, want in zip(("x", "dt", "A", "B", "C"), grads, jgrads):
        assert got.shape == tuple(want.shape), name
        assert _rel_l2(got, want) <= 1e-4, (name, _rel_l2(got, want))


def test_ssd_scan_takes_only_the_inputs_that_need_a_gradient():
    """With only x requiring grad, the backward differentiates x alone and
    hands None for the rest; under no_grad mamba's scan is the plain op."""
    arrays = [torch.from_numpy(a) for a in _ssd_inputs(1, 32, 2, 8, 1, 8)]
    x = arrays[0].clone().requires_grad_()
    views = [t.transpose(1, 2) if t.dim() > 1 else t for t in [x, *arrays[1:]]]
    y, _ = M2.ssd_scan(*views, chunk=16)
    assert y.grad_fn is not None and "SSDScan" in type(y.grad_fn).__name__
    (gx,) = torch.autograd.grad(y.sum(), [x])
    assert gx.shape == x.shape and bool(torch.isfinite(gx).all())
    with torch.no_grad():
        y0, _ = M2.ssd_scan(*views, chunk=16)
    torch.testing.assert_close(y0, y.detach(), atol=0, rtol=0)


def test_training_goes_through_the_functions_and_serving_does_not(monkeypatch):
    """lm_loss under autograd reaches the scan through SSDScan (forward and
    remat recompute of each mamba2 block) and attention through the flash
    VJP (with the lse); a prefill under no_grad calls the plain ops."""
    _, _, cfg, m, p = _setup(ARCH)
    calls = {"ssd": 0, "lse": 0, "flash": 0}
    real_ssd, real_flash = ops.ssd_scan, ops.flash_attention

    def ssd(*a, **kw):
        calls["ssd"] += 1
        return real_ssd(*a, **kw)

    def flash(*a, **kw):
        calls["lse" if kw.get("return_lse") else "flash"] += 1
        return real_flash(*a, **kw)
    monkeypatch.setattr(ops, "ssd_scan", ssd)
    monkeypatch.setattr(ops, "flash_attention", flash)
    batch = _torch_batch(_batch(cfg, 2, 32))
    live = [t.requires_grad_() for t in leaves(p)]
    loss, _ = m.loss(p, batch)
    torch.autograd.grad(loss, live)
    n_apps = cfg.n_layers // cfg.hybrid.attn_every
    assert calls == {"ssd": 2 * cfg.n_layers, "lse": 2 * n_apps, "flash": 0}
    for t in live:
        t.requires_grad_(False)
    with torch.no_grad():
        m.prefill(p, {"tokens": batch["tokens"]})
    assert calls == {"ssd": 3 * cfg.n_layers, "lse": 2 * n_apps, "flash": n_apps}


def _loss_and_grads(m, p, batch, **kw):
    live = [t.requires_grad_() for t in leaves(p)]
    loss, metrics = H.lm_loss(p, _torch_batch(batch), m.cfg, **kw) if kw \
        else m.loss(p, _torch_batch(batch))
    grads = torch.autograd.grad(loss, live)
    for t in live:
        t.requires_grad_(False)
    return loss, metrics, grads


@pytest.mark.parametrize("T", [32, 64])
def test_hybrid_lm_loss_and_grads_match_jax(T):
    """zamba2 SMOKE (4 mamba2 blocks, the shared block applied twice) at one
    chunk and at two: the loss, the xent metric and every gradient leaf,
    the shared block's summed over its applications."""
    jm, jp, cfg, m, p = _setup(ARCH)
    batch = _batch(cfg, 2, T)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jm, jp, batch)
    loss, metrics, grads = _loss_and_grads(m, p, batch)
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), rtol=1e-5, atol=0)
    assert set(metrics) == set(jmetrics) == {"xent"}
    np.testing.assert_allclose(_np(metrics["xent"]), np.asarray(jmetrics["xent"]),
                               rtol=1e-5, atol=0)
    want = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    got = dict(flatten(bridge.params_to_numpy(unflatten_like(p, [g.detach() for g in grads]))))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path in got:
        assert _rel_l2(got[path], want[path]) <= 1e-4, (path, _rel_l2(got[path], want[path]))


def test_hybrid_remat_gives_bit_identical_gradients():
    _, _, cfg, m, p = _setup(ARCH)
    batch = _batch(cfg, 2, 32)
    l_on, _, g_on = _loss_and_grads(m, p, batch, remat=True)
    l_off, _, g_off = _loss_and_grads(m, p, batch, remat=False)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def test_hybrid_adafactor_groups_blocks_by_super_block():
    """The reference's Adafactor sees each mamba2 leaf stacked (nb,
    attn_every, ...) and maps over nb: a super-block's attn_every blocks are
    one factored leaf, a 1-D leaf included ((attn_every, H): factored over
    the blocks). The port keeps one state per super-block, shaped so."""
    _, _, cfg, _, p = _setup(ARCH)
    s = O.adafactor().init(p)["s"]
    nb, k = len(p["mamba"]), len(p["mamba"][0])
    assert nb == 2 and k == cfg.hybrid.attn_every == 2
    blk = p["mamba"][0][0]
    assert isinstance(s["mamba"], list) and len(s["mamba"]) == nb
    for si in s["mamba"]:
        assert si["w_zx"]["vr"].shape == (k, blk["w_zx"].shape[0])
        assert si["w_zx"]["vc"].shape == (k, blk["w_zx"].shape[1])
        assert si["dt_bias"]["vr"].shape == (k,)
        assert si["dt_bias"]["vc"].shape == blk["dt_bias"].shape
    assert s["mamba_stacked"] == {}
    assert s["shared_attn"]["attn"]["wq"]["vr"].shape == p["shared_attn"]["attn"]["wq"].shape[:1]


def test_hybrid_microbatched_train_step_matches_jax():
    """With AdamW, as test_torch_moe_train.py's check_train_step_matches_jax
    holds it."""
    check_train_step_matches_jax(ARCH, "adamw", 32)


def test_hybrid_adafactor_train_step_matches_jax():
    """With Adafactor: the super-block grouping of the mamba2 leaves."""
    check_train_step_matches_jax(ARCH, "adafactor", 32)


def test_hybrid_train_state_round_trip_is_exact():
    """The (nb, attn_every)-stacked mamba2 leaves of params and optimizer
    state (AdamW's moments, Adafactor's per-super-block state) cross to the
    port's list of lists and back exactly (after one update, so no leaf is
    all zeros)."""
    _, jp, _, _, _ = _setup(ARCH)
    for name in ("adamw", "adafactor"):
        jopt = JO.make_optimizer(name)
        jp1, jopt_state, _ = jopt.update(jp, _grads_like(jp), jopt.init(jp), jnp.float32(1e-3))
        jstate = {"params": jp1, "opt": jopt_state, "step": jnp.int32(7)}
        state = bridge.train_state_from_jax(jstate)
        mamba = state["params"]["mamba"]
        assert isinstance(mamba, list) and all(isinstance(b, list) for b in mamba)
        back = bridge.train_state_to_numpy(state)
        want = dict(flatten(jax.tree.map(np.asarray, jstate)))
        got = dict(flatten(back))
        assert sorted(got, key=str) == sorted(want, key=str), name
        for path in want:
            assert got[path].dtype == want[path].dtype, path
            np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))
