"""The train step, the port of the JAX package's `train/steps.py`.

train_step: microbatched gradient accumulation (a loop over microbatches
split on the batch axis, fp32 accumulators), gradient clipping by the
global norm, the optimizer update. The loss and its gradients come from
`model.loss` under autograd, with the model's remat (`dense.backbone_fwd`).

The reference's `grad_shardings` (a sharded accumulator across devices)
waits for the multi-device item (ROADMAP.md, Queue 1). The step updates
the state's tensors in place and returns the same containers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.tree import leaves, tree_map, unflatten_like

F32 = torch.float32


def make_train_step(model: Model, opt: Optimizer, lr_fn: Callable[[Any], Any],
                    n_microbatches: int = 1, clip_norm: float = 1.0):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt", "step"}; batch leaves lead with the global
    batch. metrics = {"loss", "grad_norm", "lr"}, 0-d tensors on the
    device (reading one waits for the step). Gradients are accumulated in
    fp32 (the reference's default `accum_dtype`)."""

    def grads_of(params, mb):
        # leaves that share the parameters' storage and require grad, so the
        # optimizer's in-place update reaches the state's own tensors
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = model.loss(live, mb)
        grads = torch.autograd.grad(loss, leaves(live))
        return loss.detach(), grads

    def train_step(state, batch):
        params = state["params"]
        if n_microbatches == 1:
            loss, grads = grads_of(params, batch)
            acc = [g.to(F32) for g in grads]
        else:
            def split_mb(x):
                b = x.shape[0]
                if b % n_microbatches:
                    raise ValueError(f"batch {b} is not a multiple of {n_microbatches} "
                                     "microbatches")
                return x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])

            mbs = {k: split_mb(v) for k, v in batch.items()}
            acc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                   for p in leaves(params)]
            loss_sum = torch.zeros((), dtype=F32, device=state["step"].device)
            for i in range(n_microbatches):
                loss, grads = grads_of(params, {k: v[i] for k, v in mbs.items()})
                for a, g in zip(acc, grads):
                    a.add_(g.to(F32))
                del grads
                loss_sum = loss_sum + loss
            for a in acc:
                a.div_(n_microbatches)
            loss = loss_sum / n_microbatches

        grads, gnorm = clip_by_global_norm(unflatten_like(params, acc), clip_norm)
        lr = lr_fn(state["step"])
        new_params, new_opt, _ = opt.update(params, grads, state["opt"], lr)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_init_state(model: Model, opt: Optimizer):
    def init_state(generator: torch.Generator) -> Dict[str, Any]:
        params = model.init_params(generator)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    return init_state
