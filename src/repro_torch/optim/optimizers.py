"""Optimizers in PyTorch: AdamW (fp32 moments) and Adafactor (factored second
moment), the port of the JAX package's `optim/optimizers.py`.

Interface (as the reference's):
  opt = make_optimizer(name)
  state = opt.init(params)
  params, state, stats = opt.update(params, grads, state, lr)

The formulas and their order of operations are the reference's, in fp32:
moments in fp32, the new parameter `(p.float() - lr * delta).to(p.dtype)`,
the step's scalars (bias corrections, Adafactor's beta, the schedule) as
fp32 tensors, as JAX computes them. `torch.optim.AdamW` applies its weight
decay and bias correction in another order, so it is not used. Unlike the
reference, `update` writes the new parameters and state into the given
tensors (under no_grad) and returns the same containers: at full width a
second copy of the parameters and moments would not fit beside the first.

The reference stacks a model's layers on leading axes, so its Adafactor
sees one stacked leaf per layer parameter: (L, ...) for `params["layers"]`,
(nb, attn_every, ...) for the hybrid's `params["mamba"]`. The port keeps
such a stack as nested lists (a params entry that is a list of lists of
dicts stacks two axes), and reproduces that grouping (`per_layer`): a leaf
whose stacked shape the reference updates item by item along the first
axis (`lax.map`) is updated here per item of the outer list, the inner
lists stacked into one tensor (a hybrid super-block's attn_every blocks:
one factored update, one RMS clip), with its state in `s[key][i]`; any
other (a per-layer 1-D norm or bias: factored over the stack, one RMS clip
over the stack) is stacked whole for its update, with its state stacked in
`s[key + "_stacked"]`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.tree import flatten, get, leaves, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def _device(params):
    return leaves(params)[0].device


def _step0(params):
    return torch.zeros((), dtype=torch.int32, device=_device(params))


# ----------------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state, lr):
        step = state["step"] + 1
        t = step.to(F32)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                              leaves(state["v"])):
            g = g.to(F32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            # delta = (m / bc1) / (sqrt(v / bc2) + eps) + weight_decay * p, and
            # p - lr * delta: the reference's ops in its order, in place where
            # that makes no new buffer, so a leaf's update holds at most two
            # fp32 temporaries of its size (internvl2's 1.05 B-entry
            # embeddings: 8.4 GB, not 21)
            delta = m / bc1
            delta.div_(torch.div(v, bc2).sqrt_().add_(eps))
            delta.add_(p.to(F32, copy=True).mul_(weight_decay))
            p.copy_(p.to(F32, copy=True).sub_(delta.mul_(lr)))
        state["step"] = step
        return params, state, {"grad_norm": global_norm(grads)}

    return Optimizer("adamw", init, update)


# ----------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored second moments, no first moment
# ----------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def per_layer(stacked_shape) -> bool:
    """Whether the reference updates a stacked (n, ...) leaf item by item
    along its first axis (`lax.map`), or as one tensor."""
    return len(stacked_shape) >= 3 and _factored(stacked_shape) and stacked_shape[0] <= 1024


def _stack_depth(tree) -> int:
    """How many list axes a params entry stacks its leaves on: 0 for a
    plain subtree, 1 for a list of layer dicts, 2 for a list of lists."""
    depth = 0
    while isinstance(tree, list) and tree:
        tree, depth = tree[0], depth + 1
    return depth


def _stacked_paths(stack, depth: int):
    """(path, stacked shape) of each leaf of a stack of `depth` list axes."""
    lead = []
    for _ in range(depth):
        lead.append(len(stack))
        stack = stack[0]
    return [(path, tuple(lead) + tuple(p.shape)) for path, p in flatten(stack)]


def _stacked_leaf(stack, path, depth: int):
    """The leaf at `path` of every item of the stack, as one tensor."""
    if depth == 0:
        return get(stack, path)
    return torch.stack([_stacked_leaf(item, path, depth - 1) for item in stack])


def _write_leaf(stack, path, depth: int, new) -> None:
    """The inverse of _stacked_leaf: each item's leaf takes its row of `new`."""
    if depth == 0:
        get(stack, path).copy_(new)
        return
    for item, row in zip(stack, new):
        _write_leaf(item, path, depth - 1, row)


def adafactor(eps1: float = 1e-30, eps2: float = 1e-3, clip: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    def per(shape, device):
        if _factored(shape):
            return {"vr": torch.zeros(shape[:-1], dtype=F32, device=device),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32, device=device)}
        return {"v": torch.zeros(shape, dtype=F32, device=device)}

    def init(params):
        dev = _device(params)
        s = {}
        for k, v in params.items():
            depth = _stack_depth(v)
            if not depth:
                s[k] = tree_map(lambda p: per(tuple(p.shape), dev), v)
                continue
            paths = _stacked_paths(v, depth)
            s[k] = [unflatten((path, per(shape[1:], dev))
                              for path, shape in paths if per_layer(shape)) for _ in v]
            s[k + "_stacked"] = unflatten((path, per(shape, dev)) for path, shape in paths
                                          if not per_layer(shape))
        return {"s": s, "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state, lr):
        step = state["step"] + 1
        t = step.to(F32)
        beta = 1.0 - t ** (-decay_pow)

        def upd_core(p, g, s):
            """The new value of p; s is updated in place."""
            g = g.to(F32)
            g2 = torch.square(g) + eps1
            if _factored(p.shape):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2))
                vr, vc = s["vr"], s["vc"]
                denom = torch.mean(vr, dim=-1, keepdim=True)
                u = g * torch.rsqrt(vr / torch.clamp_min(denom, eps1))[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g * torch.rsqrt(s["v"])
            # RMS clipping
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps1)
            u = u / torch.clamp_min(rms_u / clip, 1.0)
            scale = torch.clamp_min(torch.sqrt(torch.mean(torch.square(p.to(F32)))), eps2)
            delta = lr * scale * u
            if weight_decay:
                delta = delta + lr * weight_decay * p.to(F32)
            return (p.to(F32) - delta).to(p.dtype)

        s = state["s"]
        for k, sub in params.items():
            depth = _stack_depth(sub)
            if not depth:
                for path, p in flatten(sub):
                    p.copy_(upd_core(p, get(grads[k], path), get(s[k], path)))
                continue
            for path, shape in _stacked_paths(sub, depth):
                if per_layer(shape):   # item by item along the stack's first axis
                    for item, g, si in zip(sub, grads[k], s[k]):
                        _write_leaf(item, path, depth - 1, upd_core(
                            _stacked_leaf(item, path, depth - 1),
                            _stacked_leaf(g, path, depth - 1), get(si, path)))
                else:
                    _write_leaf(sub, path, depth, upd_core(
                        _stacked_leaf(sub, path, depth), _stacked_leaf(grads[k], path, depth),
                        get(s[k + "_stacked"], path)))
        state["step"] = step
        return params, state, {"grad_norm": global_norm(grads)}

    return Optimizer("adafactor", init, update)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32))) for leaf in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / norm), in place (each leaf as
    `(leaf.float() * scale).to(leaf.dtype)`). Returns (tree, norm)."""
    n = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(n, 1e-9), 1.0)
    for leaf in leaves(tree):
        leaf.copy_((leaf.to(F32) * scale).to(leaf.dtype))
    return tree, n


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)


# ----------------------------------------------------------------------------
# LR schedules
# ----------------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """lr(step) -> fp32 0-d tensor (on the step's device): linear warmup,
    then cosine decay to min_frac of base_lr at `total`."""
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        w = torch.clamp_max(step / max(warmup, 1), 1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * w * cos
    return lr
