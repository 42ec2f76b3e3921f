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

Under tensor parallelism a rank holds a block of some leaves (`Split`: the
dim each such leaf is cut along over the "model" group), and under FSDP
and expert parallelism a block over the data axes too. AdamW is
elementwise and reads nothing else; the train step's global norm counts
each block once over the (data, model) group (`train/steps.py`). Adafactor's statistics read the whole
leaf: whether it factors, its row and column means, the update's RMS and
the parameter scale are the whole leaf's, through sums over the group;
its state is the rank's block of the whole leaf's (`vr` cut where the
rows are, `vc` where the columns are). A leaf cut over the data axes is
refused (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import distributed as D
from repro_torch.tree import flatten, get, leaves, map_with_path, tree_map, unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[..., Any]      # init(params, split=None)
    update: Callable[..., Any]    # update(params, grads, state, lr, split=None)


@dataclasses.dataclass(frozen=True)
class Split:
    """The leaves of a params tree of which a rank holds a block: the path
    of each (its dict keys, the stacked view's path) -> its
    `sharding.rules.Cut`: the dim, of the port's leaf, cut evenly over the
    `size` ranks of the "model" axis's `group`, and the dims cut over the
    data-parallel axes (FSDP, the experts)."""
    group: Any
    size: int
    dims: Dict[Tuple[str, ...], Any]

    def _cut(self, path):
        return self.dims.get(tuple(k for k in path if isinstance(k, str)))

    def dim(self, path) -> Optional[int]:
        """The dim of the leaf at `path` cut over "model", or None."""
        cut = self._cut(path)
        return None if cut is None else cut.model

    def data_cut(self, path) -> bool:
        """Whether the rank holds a block of the leaf at `path` over the
        data-parallel axes: its gradient comes out of the model's backward
        already summed over them (`models/data_parallel.py`), and its blocks
        are distinct across them."""
        cut = self._cut(path)
        return cut is not None and bool(cut.data)

    def refuse_data_cuts(self, what: str) -> None:
        """Raise where a leaf is cut over the data axes: `what` reads whole
        rows and columns of each leaf."""
        cut = sorted(p for p, c in self.dims.items() if c.data)
        if cut:
            raise NotImplementedError(
                f"{what} reads whole rows and columns of each leaf, and "
                f"{'/'.join(cut[0])} (and {len(cut) - 1} more) are cut over the data axes: its "
                "statistics of such a leaf belong with ZeRO-1 for Adafactor (ROADMAP Queue 1, "
                "item 7)")

    def whole(self, shape, dim: Optional[int]) -> Tuple[int, ...]:
        """The whole leaf's shape of a block of `shape` cut along `dim`."""
        shape = tuple(shape)
        if dim is None:
            return shape
        return shape[:dim] + (shape[dim] * self.size,) + shape[dim + 1:]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks, in place."""
        return D.all_reduce_(x, group=self.group)


WHOLE = Split(group=None, size=1, dims={})   # every leaf whole: no rank splits one


def _device(params):
    return leaves(params)[0].device


def _step0(params):
    return torch.zeros((), dtype=torch.int32, device=_device(params))


# ----------------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params, split=None):
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state, lr, split=None):
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


def _stacked_paths(stack, depth: int, key: str, split: Split):
    """(path, stacked shape, the whole leaf's stacked shape, the cut dim of
    the stacked leaf or None) of each leaf of params[key], a stack of
    `depth` list axes."""
    lead = []
    for _ in range(depth):
        lead.append(len(stack))
        stack = stack[0]
    out = []
    for path, p in flatten(stack):
        dim = split.dim((key,) + path)
        out.append((path, tuple(lead) + tuple(p.shape), tuple(lead) + split.whole(p.shape, dim),
                    None if dim is None else dim + depth))
    return out


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
    def per(shape, device, whole=None):
        """The state of a leaf of `shape`, a block of one of shape `whole`."""
        if _factored(whole or shape):
            return {"vr": torch.zeros(shape[:-1], dtype=F32, device=device),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32, device=device)}
        return {"v": torch.zeros(shape, dtype=F32, device=device)}

    def init(params, split=None):
        split = split or WHOLE
        split.refuse_data_cuts("Adafactor")
        dev = _device(params)
        s = {}
        for k, v in params.items():
            depth = _stack_depth(v)
            if not depth:
                s[k] = map_with_path(lambda path, p: per(
                    tuple(p.shape), dev, split.whole(p.shape, split.dim((k,) + path))), v)
                continue
            paths = _stacked_paths(v, depth, k, split)
            s[k] = [unflatten((path, per(shape[1:], dev, whole[1:]))
                              for path, shape, whole, _ in paths if per_layer(whole)) for _ in v]
            s[k + "_stacked"] = unflatten((path, per(shape, dev, whole))
                                          for path, shape, whole, _ in paths
                                          if not per_layer(whole))
        return {"s": s, "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state, lr, split=None):
        split = split or WHOLE
        split.refuse_data_cuts("Adafactor")
        step = state["step"] + 1
        t = step.to(F32)
        beta = 1.0 - t ** (-decay_pow)

        def mean(x, dim, cut, n, keepdim=False):
            """The mean over `dim` of x, a block cut along `dim` (`cut`) of a
            whole leaf whose dim has n entries: summed over the ranks."""
            if not cut:
                return torch.mean(x, dim=dim, keepdim=keepdim)
            return split.sum(torch.sum(x, dim=dim, keepdim=keepdim)) / n

        def upd_core(p, g, s, dim=None):
            """The new value of p (a block cut along `dim` under `split`, or
            whole); s is updated in place."""
            nd = p.ndim
            whole = split.whole(p.shape, dim)
            g = g.to(F32)
            g2 = torch.square(g) + eps1
            if _factored(whole):
                rows_cut, cols_cut = dim == nd - 2, dim == nd - 1
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * mean(g2, -1, cols_cut, whole[-1]))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * mean(g2, -2, rows_cut, whole[-2]))
                vr, vc = s["vr"], s["vc"]
                denom = mean(vr, -1, rows_cut, whole[-2], keepdim=True)
                u = g * torch.rsqrt(vr / torch.clamp_min(denom, eps1))[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g * torch.rsqrt(s["v"])
            # RMS clipping, and the parameter's scale: the whole leaf's
            if dim is None:
                ms_u = torch.mean(torch.square(u))
                ms_p = torch.mean(torch.square(p.to(F32)))
            else:
                numel = math.prod(whole)
                ms_u, ms_p = (split.sum(torch.stack([torch.sum(torch.square(u)),
                                                      torch.sum(torch.square(p.to(F32)))]))
                              / numel).unbind(0)
            rms_u = torch.sqrt(ms_u + eps1)
            u = u / torch.clamp_min(rms_u / clip, 1.0)
            scale = torch.clamp_min(torch.sqrt(ms_p), eps2)
            delta = lr * scale * u
            if weight_decay:
                delta = delta + lr * weight_decay * p.to(F32)
            return (p.to(F32) - delta).to(p.dtype)

        s = state["s"]
        for k, sub in params.items():
            depth = _stack_depth(sub)
            if not depth:
                for path, p in flatten(sub):
                    p.copy_(upd_core(p, get(grads[k], path), get(s[k], path),
                                     split.dim((k,) + path)))
                continue
            for path, _, shape, dim in _stacked_paths(sub, depth, k, split):
                if per_layer(shape):   # item by item along the stack's first axis
                    for item, g, si in zip(sub, grads[k], s[k]):
                        _write_leaf(item, path, depth - 1, upd_core(
                            _stacked_leaf(item, path, depth - 1),
                            _stacked_leaf(g, path, depth - 1), get(si, path),
                            None if dim is None else dim - 1))
                else:
                    _write_leaf(sub, path, depth, upd_core(
                        _stacked_leaf(sub, path, depth), _stacked_leaf(grads[k], path, depth),
                        get(s[k + "_stacked"], path), dim))
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
