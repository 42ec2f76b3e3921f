"""Training loop with fault tolerance, the port of the JAX package's
`train/trainer.py`: checkpoint and restart, preemption handling, failure
injection (tests kill the loop at a chosen step and check that the resumed
run ends bit-identical), a metrics history.

Batches come from `pipeline.batch_at(step)`, a pure function of the step,
and checkpoints commit atomically, so a restart replays exactly. Metrics
are read on the host only at log steps, so the loop does not wait for the
card in between; the final save blocks.

Across ranks every rank runs the loop on the mesh its model was built
under (`train/steps.py`), on any mesh and with either optimizer: data
parallelism, with ZeRO-2 over the data axes wherever the mesh has them
(the step's grad shardings, `sharding/rules.py::shardings_for(...,
zero1=True)`, as the reference's dry-run puts ZeRO-1 on every optimizer
leaf), tensor parallelism over "model", FSDP and the experts over the data
axes. The train state's shardings (`sharding/rules.py::state_shardings`:
each rank's block of every param, moment and Adafactor statistic, as the
step holds and updates them) go to the checkpointer, which gathers the
blocks to rank 0 and restores each rank's blocks, on this mesh or another.

Preemption is agreed across ranks. A resource manager signals every task,
but not at the same instant, and a rank that stops alone would enter the
checkpointer's gather while another enters its next step's collectives.
So under a mesh of more than one rank each step boundary takes the MAX of
the ranks' flags, over a group of host tensors that never waits on the
card (`distributed.host_group`), before testing it: every rank saves the
same step and raises `Preempted` together. One process tests its own flag,
with no collective.
"""
from __future__ import annotations

import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.mesh import dp_degree
from repro_torch.models.registry import Model, build_model
from repro_torch.optim.optimizers import Optimizer, warmup_cosine
from repro_torch.sharding.axes import rules_for
from repro_torch.sharding.rules import shardings_for, state_shardings
from repro_torch.train.steps import make_init_state, make_train_step, train_state


class Preempted(Exception):
    """The loop stopped at `step` on a preemption request, its checkpoint saved."""

    def __init__(self, step: int):
        super().__init__(f"preempted at step {step} (checkpoint saved)")
        self.step = step


@dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    n_microbatches: int = 1
    clip_norm: float = 1.0
    base_lr: float = 3e-4
    warmup: int = 10


class Trainer:
    def __init__(self, model: Model, opt: Optimizer, pipeline: TokenPipeline,
                 checkpointer: Checkpointer, cfg: TrainerConfig,
                 lr_fn: Optional[Callable] = None,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.grad_shardings = self.shardings = None
        if model.mesh is not None:
            mcfg, rules = model.cfg, rules_for(model.mesh)
            whole = build_model(mcfg, device="meta").init_params(torch.Generator())
            if dp_degree(model.mesh) > 1:
                self.grad_shardings = shardings_for(whole, mcfg, model.mesh, rules, zero1=True)
            self.shardings = state_shardings(train_state(whole, opt), mcfg, model.mesh, rules,
                                             self.grad_shardings)
        self.model = model
        self.opt = opt
        self.pipe = pipeline
        self.ckpt = checkpointer
        self.cfg = cfg
        self.lr_fn = lr_fn or warmup_cosine(cfg.base_lr, cfg.warmup, cfg.num_steps)
        self.failure_hook = failure_hook or (lambda step: None)
        self._preempt = threading.Event()
        # across ranks: the group they agree on preemption over, made at the
        # first step boundary (every rank reaches it; a Trainer built under
        # the dry-run's fake group never does)
        self._agree = model.mesh is not None and model.mesh.size > 1
        self._flag_group = None
        self.history: List[Dict[str, float]] = []
        self._step_fn = make_train_step(model, opt, self.lr_fn,
                                        n_microbatches=cfg.n_microbatches,
                                        clip_norm=cfg.clip_norm,
                                        grad_shardings=self.grad_shardings)

    def request_preemption(self, *_args):
        """SIGTERM handler on real clusters (Slurm sends it before the kill)."""
        self._preempt.set()

    def install_signal_handler(self):
        signal.signal(signal.SIGTERM, self.request_preemption)

    def _preempted(self) -> bool:
        """Whether to stop at this step boundary: this process's flag, or
        across ranks whether any rank's is set."""
        if not self._agree:
            return self._preempt.is_set()
        if self._flag_group is None:
            self._flag_group = D.host_group()
        flag = torch.tensor([int(self._preempt.is_set())])
        dist.all_reduce(flag, dist.ReduceOp.MAX, group=self._flag_group)
        return bool(flag.item())

    # -- state -------------------------------------------------------------------

    def init_or_restore(self, seed: int = 0) -> Dict[str, Any]:
        """A fresh state drawn from a generator on the model's device seeded
        with `seed`, or, where a checkpoint exists, the latest one copied
        into it."""
        gen = torch.Generator(device=self.model.device).manual_seed(seed)
        state = make_init_state(self.model, self.opt, self.grad_shardings)(gen)
        if self.ckpt.latest_step() is None:
            return state
        return self.ckpt.restore(state, shardings=self.shardings)

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.model.device)
                for k, v in self.pipe.batch_at(step).items()}

    # -- loop --------------------------------------------------------------------

    def run(self, state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        state = state if state is not None else self.init_or_restore()
        start = int(state["step"])
        t0 = time.time()
        for step in range(start, self.cfg.num_steps):
            if self._preempted():
                self.ckpt.save(step, state, blocking=True, shardings=self.shardings)
                raise Preempted(step)
            self.failure_hook(step)   # tests inject crashes here
            state, metrics = self._step_fn(state, self._batch(step))
            if step % self.cfg.log_every == 0 or step == self.cfg.num_steps - 1:
                rec = {k: float(v) for k, v in metrics.items()}
                rec["step"] = step
                rec["wall_s"] = time.time() - t0
                self.history.append(rec)
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save(step + 1, state, shardings=self.shardings)
        self.ckpt.save(self.cfg.num_steps, state, blocking=True, shardings=self.shardings)
        return state
