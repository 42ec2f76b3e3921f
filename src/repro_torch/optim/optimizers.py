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

Across ranks a rank holds a block of some leaves and updates a block of
each (`Split`): its "model" block under tensor parallelism, its block over
the data axes under FSDP and expert parallelism, and with ZeRO-1 its ZeRO
block of those, or whole layers of a stack, or nothing of a layer another
rank owns. AdamW is elementwise and reads nothing else; the train step's
global norm counts each block once over the (data, model) group
(`train/steps.py`). Adafactor's statistics read the whole leaf (the unit
the reference updates: a leaf, a layer of a stack, or a stack of norms):
whether it factors is decided by the whole unit's shape; each mean sums
over the ranks that cut the dim it averages, and the update's RMS and the
parameter scale over the ranks that cut any dim, so each comes out as the
whole unit's. Its state is the rank's block of the whole unit's statistics
(`vr` cut where the rows and leading dims are, `vc` where the columns and
leading dims are; `sharding/rules.py::stat_spec`), and empty tensors for a
layer another rank owns.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch.launch.mesh import group_over
from repro_torch.sharding.axes import _axes, axis_sizes
from repro_torch.sharding.rules import block, coordinate
from repro_torch.tree import flatten, get, leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[..., Any]      # init(params, split=None)
    update: Callable[..., Any]    # update(params, grads, state, lr, split=None)


@dataclasses.dataclass(frozen=True)
class Split:
    """What a rank holds of a params tree and which block of each leaf its
    optimizer updates. `dims`: the stacked path of each leaf the rank holds
    a block of -> its `sharding.rules.Cut` (the dim cut over the "model"
    axis, and the dims cut over the data-parallel axes: FSDP, the experts).
    `blocks`: a `sharding.rules.Shardings` of the whole params whose specs
    are the blocks the optimizer updates (the held ones, `model_shardings`;
    with ZeRO-1, `zero`, the step's grad shardings), None where every leaf
    is whole. `groups` caches the process groups of its cuts."""
    dims: Dict[Tuple[str, ...], Any]
    blocks: Any = None
    groups: Dict[Any, Any] = dataclasses.field(default_factory=dict, compare=False,
                                               repr=False)

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

    def zero(self, shardings) -> "Split":
        """This split with the optimizer updating the blocks of `shardings`
        (ZeRO-1: the rank's block of each leaf in its data group)."""
        return dataclasses.replace(self, blocks=shardings, groups={})

    def group_over(self, axes: Tuple[str, ...]):
        """The process group of the ranks that differ only along `axes`."""
        if axes not in self.groups:
            self.groups[axes] = group_over(self.blocks.mesh, axes)
        return self.groups[axes]


WHOLE = Split(dims={})   # every leaf whole: no rank splits one


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


@dataclasses.dataclass(frozen=True)
class _Unit:
    """One tensor the reference's Adafactor updates (a leaf, a layer of a
    stacked leaf, or a stack of per-layer norms) and the rank's block of it:
    the list indices of the items it holds of params[key] (row-major; each
    item's leaf at `path` is the rank's block of it), how many it holds
    along each of the unit's own list axes (`lead`), the whole unit's shape,
    per dim of the unit the process group whose ranks cut it (None: whole),
    and where its statistics are in the state's "s"."""
    key: str
    path: Tuple[str, ...]
    items: Tuple[Tuple[int, ...], ...]
    lead: Tuple[int, ...]
    whole: Tuple[int, ...]
    cuts: Tuple[Any, ...]
    state: Tuple[Any, ...]


def _units(params, split: Split):
    """The units of a params tree of which the rank holds the blocks `split`
    updates (`split.blocks`' specs; every leaf whole without them), in one
    order on every rank; the units of a layer another rank owns have no
    items. A stacked leaf the reference maps over its first axis
    (`per_layer`) is a unit per item of its outer list, the inner lists
    stacked; any other stacked leaf is one unit of every item."""
    sh = split.blocks
    coord = None if sh is None else coordinate(sh.mesh, dist.get_rank())
    sizes = {} if sh is None else axis_sizes(sh.mesh)
    out = []
    for key in sorted(params):
        depth = _stack_depth(params[key])
        lengths, first = [], params[key]
        for _ in range(depth):
            lengths.append(len(first))
            first = first[0]
        for path, leaf in flatten(first):
            if sh is None:
                whole, cuts = tuple(lengths) + tuple(leaf.shape), (None,) * (depth + leaf.ndim)
                b = tuple(slice(0, n) for n in whole)
            else:
                whole, spec = sh.shapes[(key,) + path], sh.specs[(key,) + path]
                b = block(whole, spec, sh.mesh, coord)
                spec = tuple(spec) + (None,) * (len(whole) - len(spec))
                cuts = tuple(None if not live else split.group_over(live) for live in
                             (tuple(a for a in _axes(e) if sizes[a] > 1) for e in spec))
            ranges = [range(s.start, s.stop) for s in b[:depth]]
            if depth and per_layer(whole):
                for i in range(whole[0]):
                    items = tuple((i,) + rest for rest in itertools.product(*ranges[1:])) \
                        if i in ranges[0] else ()
                    out.append(_Unit(key, path, items, tuple(map(len, ranges[1:])), whole[1:],
                                     cuts[1:], (key, i) + path))
            else:
                out.append(_Unit(key, path, tuple(itertools.product(*ranges)),
                                 tuple(map(len, ranges)), whole, cuts,
                                 ((key + "_stacked",) if depth else (key,)) + path))
    return out


def _items(params, u: _Unit):
    return [get(params[u.key], item + u.path) for item in u.items]


def _put(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {}) if isinstance(tree, dict) else tree[k]
    tree[path[-1]] = value


def adafactor(eps1: float = 1e-30, eps2: float = 1e-3, clip: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    def per(shape, device, whole):
        """The state of a block of `shape` of a unit of shape `whole`: empty
        tensors where the rank holds none of it."""
        held = shape is not None
        if _factored(whole):
            return {"vr": torch.zeros(shape[:-1] if held else (0,), dtype=F32, device=device),
                    "vc": torch.zeros(shape[:-2] + shape[-1:] if held else (0,), dtype=F32,
                                      device=device)}
        return {"v": torch.zeros(shape if held else (0,), dtype=F32, device=device)}

    def init(params, split=None):
        split = split or WHOLE
        dev = _device(params)
        s = {}
        for key, sub in params.items():
            if _stack_depth(sub):
                s[key], s[key + "_stacked"] = [{} for _ in sub], {}
        for u in _units(params, split):
            shape = u.lead + tuple(_items(params, u)[0].shape) if u.items else None
            _put(s, u.state, per(shape, dev, u.whole))
        return {"s": s, "step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state, lr, split=None):
        split = split or WHOLE
        step = state["step"] + 1
        t = step.to(F32)
        beta = 1.0 - t ** (-decay_pow)

        def upd_core(p, g, s, whole, cuts):
            """The new value of p, the rank's block of a unit of shape
            `whole` whose dims the ranks of `cuts` cut; s is updated in
            place."""
            rows, cols = p.ndim - 2, p.ndim - 1

            def mean(x, dim, over, n, keepdim=False):
                """The mean over `dim` of x, whose entries along it are the
                unit's dim `over` of n: summed over the ranks that cut it."""
                group = cuts[over]
                if group is None:
                    return torch.mean(x, dim=dim, keepdim=keepdim)
                return D.all_reduce_(torch.sum(x, dim=dim, keepdim=keepdim), group=group) / n

            g = g.to(F32)
            g2 = torch.square(g) + eps1
            if _factored(whole):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * mean(g2, -1, cols, whole[-1]))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * mean(g2, -2, rows, whole[-2]))
                vr, vc = s["vr"], s["vc"]
                denom = mean(vr, -1, rows, whole[-2], keepdim=True)
                u = g * torch.rsqrt(vr / torch.clamp_min(denom, eps1))[..., None] \
                    * torch.rsqrt(vc)[..., None, :]
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g * torch.rsqrt(s["v"])
            # RMS clipping, and the parameter's scale: the whole unit's
            groups = []
            for c in cuts:
                if c is not None and all(c is not h for h in groups):
                    groups.append(c)
            if not groups:
                ms_u = torch.mean(torch.square(u))
                ms_p = torch.mean(torch.square(p.to(F32)))
            else:
                sums = torch.stack([torch.sum(torch.square(u)),
                                    torch.sum(torch.square(p.to(F32)))])
                for group in groups:
                    D.all_reduce_(sums, group=group)
                ms_u, ms_p = (sums / math.prod(whole)).unbind(0)
            rms_u = torch.sqrt(ms_u + eps1)
            u = u / torch.clamp_min(rms_u / clip, 1.0)
            scale = torch.clamp_min(torch.sqrt(ms_p), eps2)
            delta = lr * scale * u
            if weight_decay:
                delta = delta + lr * weight_decay * p.to(F32)
            return (p.to(F32) - delta).to(p.dtype)

        for u in _units(params, split):
            if not u.items:   # a layer another rank owns
                continue
            ps, gs = _items(params, u), _items(grads, u)
            if len(ps) == 1 and not u.lead:
                p, g = ps[0], gs[0]
            else:   # the stack of the items, as the reference's leaf
                p = torch.stack(ps).reshape(u.lead + tuple(ps[0].shape))
                g = torch.stack(gs).reshape(u.lead + tuple(gs[0].shape))
            new = upd_core(p, g, get(state["s"], u.state), u.whole, u.cuts)
            for t_, row in zip(ps, new.reshape((len(ps),) + tuple(ps[0].shape))):
                t_.copy_(row)
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
