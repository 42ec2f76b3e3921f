"""Training of the xLSTM, whisper and VLM families in the port (the
optimizers' grouping of their stacked layers, the microbatched train step
with the frontends' batch fields, the train state through the bridge and
the checkpointer) against the JAX package, on the CPU at SMOKE size.

Both sides take the same inputs: numpy arrays from a seed, and
JAX-initialised weights handed over by `repro_torch.bridge`. Tolerances,
with their reasons (all fp32):
  * one microbatched train step, AdamW and Adafactor, of whisper and the
    VLM: test_torch_moe_train.py's check_train_step_matches_jax (loss, grad
    norm and lr to 1e-5 relative; the new params to 1e-6, or 2 lr + 1e-6
    where AdamW's sign-like first step meets a gradient near 0);
  * the same step of the xLSTM (check_xlstm_train_step): loss, grad norm
    and lr to 1e-5 relative; the step's gradient (the microbatches' mean,
    clipped) to 1e-4 relative L2 per leaf, as the loss tests hold
    gradients; the new params to 1e-6 of JAX's optimizer applied to the
    port's own step gradient. The new params are not held to JAX's step
    directly: the sequential sLSTM's gradients differ from JAX's by ~1e-5
    relative, and the first update normalises each entry (AdamW: g / (|g| +
    1e-8)) or each row (Adafactor: g over the row's RMS), so where a
    gradient or a row of it is near 0 that rounding moves the new value by
    up to 2 lr (observed 3e-6 to 1.1e-4, beyond the 1e-7 near-zero band
    the other families need);
  * two optimizer updates on their own: tests/test_torch_train.py's
    test_optimizer_update_matches_jax (1e-6), which covers these families;
  * the train state's round trips: exact, leaf for leaf and dtype for dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as JO
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.optim import optimizers as O
from repro_torch.train import steps as S
from repro_torch.tree import flatten, leaves, tree_map, unflatten_like
from test_torch_moe_train import check_train_step_matches_jax
from test_torch_train import (_assert_trees_close, _batch, _grads_like, _np, _rel_l2, _setup,
                              _torch_batch)

FAMILIES = ["xlstm-350m", "xlstm-350m:slstm_every=3", "whisper-tiny", "internvl2-76b"]
OPTIMIZERS = ["adamw", "adafactor"]


def _step_grads(loss_and_grads, batch, n_micro, clip_norm):
    """The step's gradient as both train steps form it: the microbatches'
    mean (fp32), clipped by the global norm. loss_and_grads(mb) -> the
    gradient leaves of one microbatch."""
    b = len(batch["tokens"]) // n_micro
    acc = None
    for i in range(n_micro):
        g = loss_and_grads({k: v[i * b:(i + 1) * b] for k, v in batch.items()})
        acc = g if acc is None else [a + x for a, x in zip(acc, g)]
    return [a / n_micro for a in acc]


def check_xlstm_train_step(arch, opt_name, T, n_micro=2, clip_norm=1.0):
    """One step of n_micro microbatches of 2 x T tokens from step 5 (see the
    module docstring for the bounds)."""
    jm, jp, cfg, m, p = _setup(arch)
    batch = _batch(cfg, 2 * n_micro, T, seed=5)
    jopt, opt = JO.make_optimizer(opt_name), O.make_optimizer(opt_name)
    jlr, lr = JO.warmup_cosine(1e-3, 10, 100), O.warmup_cosine(1e-3, 10, 100)
    jstate = {"params": jp, "opt": jopt.init(jp), "step": jnp.int32(5)}
    _, jmetrics = jax.jit(JS.make_train_step(jm, jopt, jlr, n_microbatches=n_micro))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    def port_grads(mb):
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = m.loss(live, _torch_batch(mb))
        return list(torch.autograd.grad(loss, leaves(live)))

    grads, _ = O.clip_by_global_norm(
        unflatten_like(p, _step_grads(port_grads, batch, n_micro, clip_norm)), clip_norm)
    grads = bridge.params_to_numpy(grads)
    jgrad_fn = jax.jit(jax.grad(lambda q, mb: jm.loss(q, mb)[0]))
    jgrads, _ = JO.clip_by_global_norm(jax.tree.unflatten(
        jax.tree.structure(jp),
        _step_grads(lambda mb: jax.tree.leaves(jgrad_fn(jp, {k: jnp.asarray(v)
                                                             for k, v in mb.items()})),
                    batch, n_micro, clip_norm)), clip_norm)
    want = dict(flatten(jax.tree.map(np.asarray, jgrads)))
    for path, g in flatten(grads):
        assert _rel_l2(g, want[path]) <= 1e-4, (path, _rel_l2(g, want[path]))

    new, metrics = S.make_train_step(m, opt, lr, n_microbatches=n_micro)(
        bridge.train_state_from_jax(jstate), _torch_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(jmetrics[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    assert int(new["step"]) == 6 and int(new["opt"]["step"]) == 1
    # JAX's optimizer on the port's step gradient, from the same state and lr
    jp_own, _, _ = jopt.update(jp, jax.tree.map(jnp.asarray, grads), jopt.init(jp),
                               jnp.float32(jmetrics["lr"]))
    _assert_trees_close(bridge.params_to_numpy(new["params"]),
                        jax.tree.map(np.asarray, jp_own), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_microbatched_train_step_matches_jax(arch, name):
    """Two microbatches of 2 x 32 tokens: every batch leaf (whisper's
    enc_embeds, the VLM's patch_embeds too) split on the batch axis, as the
    reference splits them."""
    if arch.startswith("xlstm"):
        check_xlstm_train_step(arch, name, 32)
    else:
        check_train_step_matches_jax(arch, name, 32)


def _jax_train_state(arch, name):
    """JAX's train state after one update (so no leaf is all zeros)."""
    _, jp, _, _, _ = _setup(arch)
    jopt = JO.make_optimizer(name)
    jp1, jopt_state, _ = jopt.update(jp, _grads_like(jp), jopt.init(jp), jnp.float32(1e-3))
    return {"params": jp1, "opt": jopt_state, "step": jnp.int32(7)}


def _assert_equal_trees(got, want):
    got, want = dict(flatten(got)), dict(flatten(want))
    assert sorted(got, key=str) == sorted(want, key=str)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        if isinstance(want[path], torch.Tensor):
            assert torch.equal(got[path], want[path]), path
        else:
            np.testing.assert_array_equal(got[path], want[path], err_msg=str(path))


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_state_round_trip_is_exact(arch, name):
    """JAX -> port -> numpy gives back JAX's train state exactly: AdamW's
    moments unstacked as the params are, Adafactor's state per super-block
    (`s["mlstm"]`) or per layer (`s["slstm"]`, `s["enc_layers"]`,
    `s["dec_layers"]`, `s["layers"]`), the rest stacked in `s[key +
    "_stacked"]`, as `optimizers.per_layer` groups the leaves."""
    jstate = _jax_train_state(arch, name)
    state = bridge.train_state_from_jax(jstate)
    if name == "adafactor":
        s = state["opt"]["s"]
        for key, p in state["params"].items():
            if isinstance(p, list):
                assert isinstance(s[key], list) and len(s[key]) == len(p), key
                assert isinstance(s[key + "_stacked"], dict), key
        # the port's own init lays the state out as the bridge does
        fresh = O.adafactor().init(state["params"])["s"]
        assert [(path, t.shape) for path, t in flatten(fresh)] == \
            [(path, t.shape) for path, t in flatten(s)]
    _assert_equal_trees(bridge.train_state_to_numpy(state), jax.tree.map(np.asarray, jstate))


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_state_checkpoint_round_trip_is_exact(arch, name, tmp_path):
    """The port's train state (nested lists of layers, Adafactor's lists of
    per-layer state) saved by the checkpointer and restored into a zeroed
    copy of itself, in fp32 and with the params in bf16."""
    state = bridge.train_state_from_jax(_jax_train_state(arch, name))
    for dtype in (torch.float32, torch.bfloat16):
        state["params"] = tree_map(lambda t: t.to(dtype), state["params"])
        ck = Checkpointer(str(tmp_path / str(dtype)))
        ck.save(7, state, blocking=True)
        like = tree_map(torch.zeros_like, state)
        out = ck.restore(like)
        assert out is like
        assert len(leaves(out)) == len(leaves(state))
        _assert_equal_trees(out, state)
