"""The port's checkpointer and fault-tolerant trainer
(src/repro_torch/checkpoint/checkpointer.py, src/repro_torch/train/trainer.py)
on the CPU: the ports of tests/test_substrate.py's checkpoint and trainer
tests, held to the port's own runs (bit-exact), and the on-disk layout held
to the JAX checkpointer's, which reads what the port writes.
"""
import json
import os
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.trainer import Preempted, Trainer, TrainerConfig
from repro_torch.tree import flatten, get, leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- checkpointer

def _toy_state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.tensor([1.0, -2.5, 3.0, 0.1]).to(torch.bfloat16)},
            "opt": {"m": {"w": torch.zeros(3, 4), "b": torch.zeros(4)},
                    "step": torch.zeros((), dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(state):
    return tree_map(torch.zeros_like, state)


def test_checkpoint_roundtrip_exact(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = _toy_state()
    ck.save(7, state, blocking=True)
    like = _zeros_like(state)
    out = ck.restore(like)
    assert out is like
    for a, b in zip(leaves(state), leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """The train step updates tensors in place right after an async save:
    the checkpoint holds the values at the save."""
    ck = Checkpointer(str(tmp_path))
    state = _toy_state()
    ck.save(1, state)
    state["params"]["w"].add_(100.0)
    ck.wait()
    out = ck.restore(_zeros_like(state))
    assert torch.equal(out["params"]["w"], torch.arange(12.0).reshape(3, 4))


def test_checkpoint_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2)
    for s in (10, 20, 30, 40):
        ck.save(s, _toy_state())
    ck.wait()
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 2 and kept[-1].endswith(f"{40:010d}")
    assert ck.latest_step() == 40


def test_checkpoint_atomic_no_partial(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _toy_state(), blocking=True)
    # a stale tmp dir from a crashed writer must not be visible as a ckpt
    os.makedirs(tmp_path / ".tmp-99", exist_ok=True)
    assert ck.latest_step() == 5


def test_checkpoint_writer_error_is_raised_by_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    (tmp_path / ".tmp-4").write_text("a file where the writer wants its directory")
    ck.save(4, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()   # the error is raised once
    assert ck.latest_step() is None


def test_checkpoint_layout_matches_the_jax_checkpointer(tmp_path):
    """Same manifest schema and bf16 bit patterns: the JAX checkpointer
    restores what the port wrote, value for value."""
    state = _toy_state()
    Checkpointer(str(tmp_path)).save(7, state, blocking=True)
    with open(tmp_path / f"step_{7:010d}" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 7
    assert manifest["leaves"]["params/b"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["step"]["dtype"] == "int32"
    like = tree_map(lambda t: jax.ShapeDtypeStruct(
        t.shape, jax.numpy.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype), state)
    out = JaxCheckpointer(str(tmp_path)).restore(like, step=7)
    for path, t in flatten(state):
        got = np.asarray(get(out, path)).astype(np.float32)
        np.testing.assert_array_equal(got, t.float().numpy(), err_msg=str(path))


# ---------------------------------------------------------------- trainer fault tolerance

def _mk_trainer(tmp_path, num_steps=12, fail_at=None):
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg, device="cpu")
    opt = make_optimizer("adamw")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=4, seed=3))
    tcfg = TrainerConfig(num_steps=num_steps, ckpt_every=4, log_every=4,
                         n_microbatches=2)
    crash = {"armed": fail_at is not None}

    def failure_hook(step):
        if crash["armed"] and step == fail_at:
            crash["armed"] = False
            raise KeyboardInterrupt("injected node failure")

    return Trainer(model, opt, pipe, Checkpointer(str(tmp_path)), tcfg,
                   failure_hook=failure_hook)


def test_trainer_crash_restart_bit_exact(tmp_path):
    """Kill training mid-run; a fresh Trainer must resume from the last
    checkpoint and end bit-identical to an uninterrupted run."""
    t_ref = _mk_trainer(tmp_path / "ref")
    final_ref = t_ref.run(t_ref.init_or_restore(seed=0))

    t1 = _mk_trainer(tmp_path / "ft", fail_at=9)
    with pytest.raises(KeyboardInterrupt):
        t1.run(t1.init_or_restore(seed=0))
    t1.ckpt.wait()
    # restart: picks up the step-8 checkpoint, replays deterministically
    t2 = _mk_trainer(tmp_path / "ft")
    final_ft = t2.run()
    assert int(t2.ckpt.latest_step()) == 12
    assert int(final_ft["step"]) == 12
    ref, ft = flatten(final_ref), flatten(final_ft)
    assert [p for p, _ in ref] == [p for p, _ in ft]
    for (path, a), (_, b) in zip(ref, ft):
        assert torch.equal(a, b), path


def test_trainer_preemption_checkpoints(tmp_path):
    t = _mk_trainer(tmp_path, num_steps=50)
    state = t.init_or_restore(seed=0)
    t.request_preemption()
    with pytest.raises(Preempted):
        t.run(state)
    assert t.ckpt.latest_step() is not None


def test_trainer_loss_decreases(tmp_path):
    t = _mk_trainer(tmp_path, num_steps=30)
    t.run(t.init_or_restore(seed=0))
    losses = [h["loss"] for h in t.history]
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite([h["grad_norm"] for h in t.history]))


# ---------------------------------------------------------------- the example

def test_train_torch_example_runs_inline_on_the_cpu(tmp_path, monkeypatch, capsys):
    ex = runpy.run_path(str(ROOT / "examples" / "train_torch.py"))
    out = ex["train_job"]("demo", 3, str(tmp_path / "job"), device="cpu")
    assert out["params"] > 0
    assert [h["step"] for h in out["history"]] == [0, 2]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    monkeypatch.setattr(sys, "argv", ["train_torch.py", "--steps", "3", "--device", "cpu",
                                      "--no-cluster", "--ckpt-dir", str(tmp_path / "main")])
    runpy.run_path(str(ROOT / "examples" / "train_torch.py"), run_name="__main__")
    assert "loss:" in capsys.readouterr().out
