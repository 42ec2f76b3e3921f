"""The port's MoE training path (kernels/ref.py's moe_gmm_dx_ref and
moe_gmm_dw_ref, models/moe.py::GroupedMatmul, dense.lm_loss for the moe
family, the train step with AdamW and Adafactor) against the JAX package,
on the CPU at SMOKE size.

Both sides take the same inputs: numpy arrays from a seed, and
JAX-initialised weights handed over by `repro_torch.bridge`. On the CPU the
grouped products are the plain versions, so this holds the functions the
kernels compute on the card (tests/test_torch_cuda.py holds the kernels to
them). The JAX model gets the expert products' gradients by autodiff of its
einsum. `jax.vjp` of the Pallas kernel itself does not run in this jax (its
pallas_call JVP rule asserts), so the backward products are also held to
the Pallas kernel (interpret mode) applied to the transposed operands, the
two products that VJP consists of. Tolerances, with their reasons (fp32):
  * the backward products and GroupedMatmul's gradients: atol=rtol=1e-5
    (fp32 rounding, with sums in another order);
  * lm_loss 1e-5 relative, each gradient leaf 1e-4 relative L2, and one
    microbatched train step, as tests/test_torch_train.py holds the dense
    family and phi3.5-moe;
  * remat on and off: bit-identical (the same ops again).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import moe_gmm as JG
from repro.optim import optimizers as JO
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch.kernels import moe_gmm as gk
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as MO
from repro_torch.optim import optimizers as O
from repro_torch.train import steps as S
from repro_torch.tree import flatten, leaves, unflatten_like
from test_torch_train import (_batch, _jax_loss_and_grads, _np, _rel_l2, _setup,
                              _torch_batch, _torch_loss_and_grads)

TOL = dict(atol=1e-5, rtol=1e-5)
PHI, ARCTIC = "phi3.5-moe-42b-a6.6b", "arctic-480b"
NEAR_ZERO = 1e-7   # see check_train_step_matches_jax

GMM_CASES = [  # (E, C, d, f): tails of C, d and f off every tile
    (2, 4, 24, 40),
    (3, 12, 20, 36),
    (2, 20, 72, 24),
    (4, 36, 16, 100),
]


def _gmm_inputs(E, C, d, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) * d ** -0.5).astype(np.float32)
    dy = rng.standard_normal((E, C, f)).astype(np.float32)
    return x, w, dy


def _jax_vjp(x, w, dy):
    """(dx, dw) by jax.vjp of the JAX model's expert einsum."""
    _, vjp = jax.vjp(lambda a, b: jnp.einsum("ecd,edf->ecf", a, b), jnp.asarray(x),
                     jnp.asarray(w))
    return vjp(jnp.asarray(dy))


@pytest.mark.parametrize("E,C,d,f", GMM_CASES)
def test_moe_gmm_backward_refs_match_jax(E, C, d, f):
    """dx = dy w^T and dw = x^T dy: against jax.vjp of the einsum, and
    against the Pallas kernel on the transposed operands."""
    x, w, dy = _gmm_inputs(E, C, d, f, seed=C + d)
    jdx, jdw = _jax_vjp(x, w, dy)
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    dx, dw = ref.moe_gmm_dx_ref(tdy, tw), ref.moe_gmm_dw_ref(tx, tdy)
    assert dx.shape == (E, C, d) and dw.shape == (E, d, f)
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(_np(dw), np.asarray(jdw), **TOL)
    pallas_dx = JG.moe_gmm(jnp.asarray(dy), jnp.asarray(w).transpose(0, 2, 1))
    pallas_dw = JG.moe_gmm(jnp.asarray(x).transpose(0, 2, 1), jnp.asarray(dy))
    np.testing.assert_allclose(_np(dx), np.asarray(pallas_dx), **TOL)
    np.testing.assert_allclose(_np(dw), np.asarray(pallas_dw), **TOL)


def test_moe_gmm_backward_ops_take_the_plain_versions_on_the_cpu():
    x, w, dy = (torch.from_numpy(a) for a in _gmm_inputs(2, 12, 20, 36))
    torch.testing.assert_close(ops.moe_gmm_dx(dy, w), ref.moe_gmm_dx_ref(dy, w), atol=0, rtol=0)
    torch.testing.assert_close(ops.moe_gmm_dw(x, dy), ref.moe_gmm_dw_ref(x, dy), atol=0, rtol=0)


def test_backward_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise; only ops sends a
    CPU tensor to the plain version."""
    x, w, dy = (torch.from_numpy(a) for a in _gmm_inputs(2, 12, 24, 40))
    with pytest.raises(ValueError, match="CUDA"):
        gk.moe_gmm_dx(dy, w)
    with pytest.raises(ValueError, match="CUDA"):
        gk.moe_gmm_dw(x, dy)


@pytest.mark.parametrize("kind,dtype,E,C,d,f,want", [
    # phi3.5-moe's training microbatch (C=320), both directions of its experts
    ("dx", torch.bfloat16, 16, 320, 4096, 6400, "wgmma"),
    ("dw", torch.bfloat16, 16, 320, 4096, 6400, "wgmma"),
    ("dx", torch.bfloat16, 16, 320, 6400, 4096, "wgmma"),
    ("dw", torch.bfloat16, 16, 320, 6400, 4096, "wgmma"),
    # fp32: the CUDA-core kernels by M (C for dx, d for dw)
    ("dx", torch.float32, 16, 320, 4096, 6400, "tiled"),
    ("dx", torch.float32, 16, 12, 4096, 6400, "rows"),
    ("dw", torch.float32, 16, 12, 4096, 6400, "tiled"),
    ("dw", torch.float32, 4, 40, 24, 64, "rows"),
    # bf16 rows TMA cannot stride: d (dx's output rows, x's rows) or f
    ("dx", torch.bfloat16, 3, 12, 300, 264, "rows"),
    ("dw", torch.bfloat16, 3, 12, 300, 264, "tiled"),
    ("dw", torch.bfloat16, 2, 40, 24, 36, "rows"),
])
def test_moe_gmm_backward_route_picks_the_kernel_from_shapes(kind, dtype, E, C, d, f, want):
    """`route_for` of dx (dy, w) and dw (x, dy) decides from dtype, shapes,
    strides and alignment alone, as the forward's does (the CPU tensors
    only stand in for the card's: nothing launches)."""
    w = torch.empty((E, d, f), dtype=dtype)
    if kind == "dx":
        a, b, out = torch.empty((E, C, f), dtype=dtype), w, torch.empty((E, C, d), dtype=dtype)
    else:
        a, b, out = (torch.empty((E, C, d), dtype=dtype), torch.empty((E, C, f), dtype=dtype),
                     torch.empty((E, d, f), dtype=dtype))
    assert gk.route_for(a, b, out, kind) == want


@pytest.mark.parametrize("needs", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("E,C,d,f", GMM_CASES[:2])
def test_grouped_matmul_gradients_match_jax(E, C, d, f, needs):
    """GroupedMatmul's output and gradients against jax.vjp of the einsum,
    each gradient computed only where autograd asks for it."""
    x, w, dy = _gmm_inputs(E, C, d, f, seed=E * f)
    jdx, jdw = _jax_vjp(x, w, dy)
    tx, tw = (torch.from_numpy(a).requires_grad_(n) for a, n in zip((x, w), needs))
    out = MO.GroupedMatmul.apply(tx, tw)
    np.testing.assert_allclose(_np(out), np.einsum("ecd,edf->ecf", x, w), **TOL)
    out.backward(torch.from_numpy(dy))
    for t, n, want in zip((tx, tw), needs, (jdx, jdw)):
        if n:
            np.testing.assert_allclose(_np(t.grad), np.asarray(want), **TOL)
        else:
            assert t.grad is None


def test_grouped_matmul_bf16_returns_input_dtypes():
    x, w, _ = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
               for a in _gmm_inputs(2, 8, 16, 24))
    MO.GroupedMatmul.apply(x, w).float().sum().backward()
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16


def test_moe_training_goes_through_grouped_matmul_and_serving_does_not(monkeypatch):
    """Under autograd each MoE layer's three expert products go through
    GroupedMatmul (forward and remat recompute), whose backward calls dx and
    dw three times each; a prefill under no_grad calls moe_gmm alone."""
    _, _, cfg, m, p = _setup(PHI)
    calls = {"fwd": 0, "dx": 0, "dw": 0}
    for name, key in (("moe_gmm", "fwd"), ("moe_gmm_dx", "dx"), ("moe_gmm_dw", "dw")):
        real = getattr(ops, name)

        def spy(*a, _real=real, _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(ops, name, spy)
    batch = _torch_batch(_batch(cfg, 2, 16))
    live = [t.requires_grad_() for t in leaves(p)]
    loss, _ = m.loss(p, batch)
    torch.autograd.grad(loss, live)
    L_ = cfg.n_layers
    assert calls == {"fwd": 2 * 3 * L_, "dx": 3 * L_, "dw": 3 * L_}
    for t in live:
        t.requires_grad_(False)
    with torch.no_grad():
        m.prefill(p, {"tokens": batch["tokens"]})
    assert calls == {"fwd": 3 * 3 * L_, "dx": 3 * L_, "dw": 3 * L_}


@pytest.mark.parametrize("B,T", [(2, 16), (1, 32)])
def test_arctic_lm_loss_and_grads_match_jax(B, T):
    """arctic SMOKE (8 experts top-2 beside a dense residual FFN): the loss,
    its xent and aux terms and every gradient leaf."""
    jm, jp, cfg, m, p = _setup(ARCTIC)
    batch = _batch(cfg, B, T)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jm, jp, batch)
    loss, metrics, grads = _torch_loss_and_grads(m, p, batch)
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(metrics["xent"]), np.asarray(jmetrics["xent"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(_np(metrics["aux"]), np.asarray(jmetrics["aux"]),
                               rtol=1e-5, atol=1e-7)
    want = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    got = dict(flatten(bridge.params_to_numpy(unflatten_like(p, [g.detach() for g in grads]))))
    assert sorted(got, key=str) == sorted(want, key=str)
    assert any("dense" in path for path in got)
    for path in got:
        assert _rel_l2(got[path], want[path]) <= 1e-4, (path, _rel_l2(got[path], want[path]))


@pytest.mark.parametrize("arch", [PHI, ARCTIC])
def test_moe_remat_gives_bit_identical_gradients(arch):
    _, _, cfg, m, p = _setup(arch)
    batch = _batch(cfg, 2, 16)
    l_on, _, g_on = _torch_loss_and_grads(m, p, batch, remat=True)
    l_off, _, g_off = _torch_loss_and_grads(m, p, batch, remat=False)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(g_on, g_off))


def check_train_step_matches_jax(arch, opt_name, T):
    """One step of 2 microbatches of 2 x T tokens from step 5 (a nonzero
    learning rate), the port's against JAX's `make_train_step`: loss, grad
    norm and lr to 1e-5 relative; the new params to 1e-6, or, under AdamW,
    2 lr + 1e-6 where the step's clipped gradient is below NEAR_ZERO
    (AdamW's sign-like first step; tests/test_torch_train.py). That gradient
    is read from JAX's first moment: a MoE microbatch has its own expert
    capacity, so the step's gradient is not the full batch's."""
    jm, jp, cfg, m, _ = _setup(arch)
    batch = _batch(cfg, 4, T, seed=5)
    jopt, opt = JO.make_optimizer(opt_name), O.make_optimizer(opt_name)
    jlr, lr = JO.warmup_cosine(1e-3, 10, 100), O.warmup_cosine(1e-3, 10, 100)
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.int32(5)}
    state = bridge.train_state_from_jax(jstate)
    jnew, jmetrics = jax.jit(JS.make_train_step(jm, jopt, jlr, n_microbatches=2))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, metrics = S.make_train_step(m, opt, lr, n_microbatches=2)(state, _torch_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(jmetrics[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    assert int(new["step"]) == 6 and int(new["opt"]["step"]) == 1

    # the step's clipped gradient, from AdamW's first moment (0.1 g after one
    # step from zero moments); Adafactor's update is not sign-like
    moment = jnew["opt"]["m"] if opt_name == "adamw" else jax.tree.map(jnp.ones_like, jp)
    near_zero = dict(flatten(jax.tree.map(lambda m: np.abs(np.asarray(m)) / 0.1 < NEAR_ZERO,
                                          moment)))
    got = dict(flatten(bridge.params_to_numpy(new["params"])))
    want = dict(flatten(jax.tree.map(np.asarray, jnew["params"])))
    step_lr = float(jmetrics["lr"])
    for path, w in want.items():
        err = np.abs(_np(got[path]) - w)
        bound = np.where(near_zero[path], 2 * step_lr + 1e-6, 1e-6)
        assert np.all(err <= bound), (path, float(err.max()))


@pytest.mark.parametrize("arch,opt_name", [(PHI, "adamw"), (ARCTIC, "adafactor")])
def test_moe_microbatched_train_step_matches_jax(arch, opt_name):
    """With the optimizer each config trains with (check_train_step_matches_jax)."""
    check_train_step_matches_jax(arch, opt_name, 16)
