"""The train step, the port of the JAX package's `train/steps.py`.

train_step: microbatched gradient accumulation (a loop over microbatches
split on the batch axis, fp32 accumulators), gradient clipping by the
global norm, the optimizer update. The loss and its gradients come from
`model.loss` under autograd, with the model's remat (`dense.backbone_fwd`,
`hybrid.backbone_fwd`). The step updates the state's tensors in place and
returns the same containers.

Under a data-parallel `mesh` (`launch/mesh.py`) every rank runs the
step on the global batch, of which it takes its rows: the reference cuts the global
batch into microbatches first and splits each over the data axis, so rank r
of n takes rows [r B/(M n), (r+1) B/(M n)) of each microbatch of B/M rows.
The model must be built under the same mesh (its loss takes the MoE aux
loss's means over the group). The result is the single-device step on the
global batch, to rounding, as the reference's SPMD step is.
  * Without `grad_shardings` (plain data parallelism) each rank accumulates
    its own fp32 gradient over the microbatches and the sum is all-reduced
    once, in one flat buffer; the optimizer state is replicated.
  * With `grad_shardings` (`sharding/rules.py::shardings_for(..., zero1=True)`,
    the reference dry-run's ZeRO-2 grad shardings) each rank keeps only its
    block of every fp32 accumulator (1/n of it), and each microbatch's
    gradient is reduced into the blocks: a reduce-scatter for a leaf split
    along a dim, a reduce to the owner for a layer a rank owns whole, an
    all-reduce for a leaf every rank holds. The optimizer state is the
    rank's ZeRO-1 share (`make_init_state` with the same shardings; AdamW,
    whose update is elementwise); after the update each rank's blocks of the
    params are all-gathered (or broadcast from their owner), so the params
    stay whole on every rank.
The clip's global norm sums the squares of each block once (on its first
holder) and all-reduces the sum.

Under a "model" axis (tensor parallelism: a (1, n) or a (dp, tp) mesh, the
model built under it, `registry.build_model(cfg, mesh=)`) each rank holds
its "model" block of every weight (`sharding/rules.py::model_shardings`)
and its state's blocks. The ranks of one data coordinate take the same
rows, so n and the rank above are those of the data group, and a TP rank's
gradient of its blocks is exact (`models/tensor_parallel.py`). The global
norm counts a split leaf's blocks once each, summed over "model", and a
replicated leaf once. ZeRO-2 (`grad_shardings`, on a mesh with a data
axis) cuts each rank's blocks further over its data group: its ZeRO block
of a leaf is stated inside its "model" block (`Shardings.local_index`), and
the collectives above run over the data group. Adafactor reads whole
leaves through the model's `Split` (`optim/optimizers.py`), its sums over
the "model" group, and with ZeRO-1 over the data group too.

Under FSDP and expert parallelism (a leaf the model's `Split` marks as cut
over the data axes: `models/data_parallel.py`) the rank holds its block of
the leaf over the data axes too, and the model's backward hands back that
block's gradient already summed over the data group (the FSDP gather's
reduce-scatter, the experts' all-to-all). So neither the all-reduce nor
ZeRO-2 reduces it again: it is accumulated as it comes, divided by M n
with the rest, updated in place and never gathered; ZeRO-1 cuts its
optimizer state no further (`zero1_extend` leaves a spec that names the
data axes as it is). The global norm counts each of its blocks once over
the (data, model) group. Adafactor's statistics of such a block are its
block's, its means summed over the data group where that cuts the dim
they average.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch.launch.mesh import DP_AXES, dp_group, tp_degree
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import WHOLE, Optimizer, clip_by_global_norm
from repro_torch.tree import flatten, leaves, tree_map, unflatten_like

F32 = torch.float32
ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _full(block, shape) -> bool:
    return block is not None and all(s.start == 0 and s.stop == n for s, n in zip(block, shape))


class _Layout:
    """How each leaf of the params is spread over the ranks under the
    shardings, and the collectives that reduce into it and gather from it."""

    def __init__(self, params, shardings, n: int, rank: int, group=None, own=None):
        """`own` marks (by leaf) the blocks cut over the data axes, whose
        gradients come summed over the group already."""
        self.rank = rank
        # the group's global ranks, by group rank: each one's blocks in the
        # coordinates of what it holds (the whole leaf, or its "model" block)
        self.ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
        self.blocks = [shardings.local_index(params, g) for g in self.ranks]
        self.mine = self.blocks[rank]
        self.modes = []
        for j, p in enumerate(leaves(params)):
            bs = [b[j] for b in self.blocks]
            holders = [q for q, b in enumerate(bs) if b is not None]
            if own is not None and own[j]:   # every rank its own block, counted by each
                self.modes.append((("own",), True))
                continue
            if all(_full(b, p.shape) for b in bs):
                mode = ("all",)
            elif len(holders) == 1 and _full(bs[holders[0]], p.shape):
                mode = ("owner", holders[0])
            else:
                mode = ("general",)
                split = [d for d in range(p.ndim)
                         if all(b is not None and b[d].stop - b[d].start == p.shape[d] // n
                                and b[d].start == q * (p.shape[d] // n) for q, b in enumerate(bs))]
                if n > 1 and len(split) == 1 and all(
                        _full(tuple(s for d, s in enumerate(b) if d != split[0]),
                              [m for d, m in enumerate(p.shape) if d != split[0]]) for b in bs):
                    mode = ("split", split[0])
            # the first rank holding this rank's block counts it in the norm
            first = min(q for q, b in enumerate(bs) if b == self.mine[j]) \
                if self.mine[j] is not None else None
            self.modes.append((mode, first == rank))

    def reduce_into(self, acc, grads, acc_dtype, group):
        """Add the group's sum of `grads` (a list, emptied as it goes, so
        each gradient is freed once reduced) into this rank's blocks."""
        for j, ((mode, _), a, b) in enumerate(zip(self.modes, acc, self.mine)):
            g, grads[j] = grads[j], None
            if mode[0] == "split":   # one fp32 copy, laid out split dim first
                d = mode[1]
                inp = a.new_empty(g.movedim(d, 0).shape).copy_(g.movedim(d, 0))
                out = a.new_empty(a.movedim(d, 0).shape)
                a.add_(D.reduce_scatter_(out, inp, group).movedim(0, d))
                continue
            g = g.to(acc_dtype)
            if mode[0] == "own":
                a.add_(g)
            elif mode[0] == "all":
                a.add_(D.all_reduce_(g, group=group))
            elif mode[0] == "owner":
                D.reduce_(g, self.ranks[mode[1]], group=group)
                if mode[1] == self.rank:
                    a.add_(g)
            else:
                D.all_reduce_(g, group=group)
                if b is not None:
                    a.add_(g[b])

    def gather(self, params, group):
        """Every rank's updated blocks of the params, onto every rank."""
        for j, ((mode, _), p) in enumerate(zip(self.modes, leaves(params))):
            if mode[0] == "owner":
                D.broadcast_(p, self.ranks[mode[1]], group=group)
            elif mode[0] == "split":
                d, own = mode[1], p[self.mine[j]].movedim(mode[1], 0).contiguous()
                out = p.new_empty(p.movedim(d, 0).shape)
                p.copy_(D.all_gather_(out, own, group).movedim(0, d))
            elif mode[0] == "general":   # "all" and "own" leave each rank's as it is
                done = []
                for q, blocks in enumerate(self.blocks):
                    b = blocks[j]
                    if b is None or b in done:
                        continue
                    done.append(b)
                    part = p[b].contiguous()
                    p[b].copy_(D.broadcast_(part, self.ranks[q], group=group))


def _local(tree, index):
    """The rank's blocks of the leaves of `tree`: views where it holds one,
    empty tensors where another rank owns the leaf."""
    return unflatten_like(tree, [t[b] if b is not None else t.new_empty((0,))
                                 for t, b in zip(leaves(tree), index)])


def make_train_step(model: Model, opt: Optimizer, lr_fn: Callable[[Any], Any],
                    n_microbatches: int = 1, clip_norm: float = 1.0,
                    grad_shardings=None, accum_dtype: str = "float32", mesh=None):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt", "step"}; batch leaves lead with the global
    batch. metrics = {"loss", "grad_norm", "lr"}, 0-d tensors on the
    device (reading one waits for the step), the loss the global batch's.
    Gradients are accumulated in `accum_dtype`. The step runs on the mesh
    the model was built under (`mesh`, where given, must be that one; so
    must `grad_shardings`'), see the module's docstring."""
    acc_dtype = ACC_DTYPES[accum_dtype]
    if mesh is not None and mesh is not model.mesh:
        raise ValueError("build the model under the step's mesh: its loss takes the "
                         "group's means")
    mesh = model.mesh
    if grad_shardings is not None and grad_shardings.mesh is not mesh:
        raise ValueError("grad_shardings were made for another mesh than the model's")
    tp = model.tp if mesh is not None and tp_degree(mesh) > 1 else None
    group = dp_group(mesh) if mesh is not None else None
    if grad_shardings is not None and group is None:
        raise ValueError(f"ZeRO shards over the data axes: a {mesh.shape} mesh has none")
    n = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    split = model.split
    # the blocks the optimizer updates: ZeRO-1's, or what the rank holds
    zero = None if grad_shardings is None else (split or WHOLE).zero(grad_shardings)
    if split is not None and group is not None:
        live = {a for a, k in zip(mesh.axis_names, mesh.shape) if a in DP_AXES and k > 1}
        for path, cut in split.dims.items():
            axes = {a for _, ax in cut.data for a in ax}
            if axes and axes != live:
                raise NotImplementedError(
                    f"{'/'.join(path)} is cut over {sorted(axes)} of the data axes "
                    f"{sorted(live)}: its gradient would need a sum over the others")
    layouts: Dict[int, _Layout] = {}

    def grads_of(params, mb):
        # leaves that share the parameters' storage and require grad, so the
        # optimizer's in-place update reaches the state's own tensors
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = model.loss(live, mb)
        grads = torch.autograd.grad(loss, leaves(live))
        return loss.detach(), grads

    def train_step(state, batch):
        params = state["params"]
        plist = leaves(params)
        paths = [path for path, _ in flatten(params)]
        # the blocks cut over the data axes: their gradients come summed
        own = [split is not None and split.data_cut(path) for path in paths]
        M = n_microbatches
        rows = next(iter(batch.values())).shape[0]
        if rows % (M * n):
            raise ValueError(f"batch {rows} does not split into {M} microbatches of {n} "
                             "equal shares")

        def share(x, i):   # microbatch i's rows of this rank
            return x.reshape(M, n, rows // (M * n), *x.shape[1:])[i, rank]

        if grad_shardings is None:   # one flat buffer of what the all-reduce sums
            flat = torch.zeros(sum(p.numel() for p, o in zip(plist, own) if not o),
                               dtype=acc_dtype, device=plist[0].device)
            acc, at = [], 0
            for p, o in zip(plist, own):
                if o:
                    acc.append(torch.zeros(p.shape, dtype=acc_dtype, device=p.device))
                    continue
                acc.append(flat[at:at + p.numel()].view(p.shape))
                at += p.numel()
        else:
            layout = layouts.get(id(params))
            if layout is None:
                layout = layouts[id(params)] = _Layout(params, grad_shardings, n, rank, group,
                                                       own)
            acc = [torch.zeros(p[b].shape if b is not None else (0,), dtype=acc_dtype,
                               device=p.device) for p, b in zip(plist, layout.mine)]
        loss_sum = torch.zeros((), dtype=F32, device=state["step"].device)
        for i in range(M):
            loss, grads = grads_of(params, {k: share(v, i) for k, v in batch.items()})
            grads = list(grads)
            if grad_shardings is None:
                for a, g in zip(acc, grads):
                    a.add_(g.to(acc_dtype))
            else:
                layout.reduce_into(acc, grads, acc_dtype, group)
            del grads
            loss_sum = loss_sum + loss
        if grad_shardings is None and group is not None and flat.numel():
            D.all_reduce_(flat, group=group)
        for a in acc:
            a.div_(M * n)
        loss = loss_sum / M
        if group is not None:
            loss = D.all_reduce_(loss, group=group) / n

        if grad_shardings is None and tp is None and not any(own):
            grads, gnorm = clip_by_global_norm(unflatten_like(params, acc), clip_norm)
        else:
            # which leaves are the rank's blocks of a leaf split over "model"
            cut = [tp is not None and split.dim(path) is not None for path in paths]
            if grad_shardings is None:   # the all-reduced leaves are whole on every rank
                counted, summed = [True] * len(acc), own
            else:
                counted, summed = [c for _, c in layout.modes], [True] * len(acc)
            gnorm = _global_norm(acc, counted, summed, cut, group, tp, loss.device)
            scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
            for a in acc:
                a.copy_((a.to(F32) * scale).to(a.dtype))
            grads = unflatten_like(params, acc)
        lr = lr_fn(state["step"])
        if grad_shardings is None:
            opt.update(params, grads, state["opt"], lr, model.split)
        else:
            opt.update(_local(params, layout.mine), grads, state["opt"], lr, zero)
            layout.gather(params, group)
        new_state = {"params": params, "opt": state["opt"], "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def _global_norm(acc, counted, summed, cut, group, tp, device) -> torch.Tensor:
    """The global norm of the accumulated gradients, by leaf: the sum of
    squares of each `counted` block (a ZeRO block on its first holder),
    summed over the data `group` where the ranks' blocks differ (`summed`:
    ZeRO-2's blocks, FSDP's and the experts'), and over the "model" group
    where the leaf is split over it (`cut`, under `tp`); a leaf whole on
    every rank counted once."""
    def part(s, c):
        return sum((torch.sum(torch.square(a.to(F32))) for a, k, ss, cc in
                    zip(acc, counted, summed, cut) if k and ss == s and cc == c),
                   torch.zeros((), dtype=F32, device=device))
    reduce = group is not None and any(summed)
    if tp is None:   # no leaf is split over "model"
        over_data = part(True, False)
        if reduce:
            D.all_reduce_(over_data, group=group)
        return torch.sqrt(over_data + part(False, False))
    over_data = torch.stack([part(True, True), part(True, False)])
    if reduce:
        D.all_reduce_(over_data, group=group)
    split, whole = (over_data + torch.stack([part(False, True), part(False, False)])).unbind(0)
    return torch.sqrt(tp.all_reduce(split) + whole)


def train_state(params, opt: Optimizer, shardings=None, split=None) -> Dict[str, Any]:
    """{"params", "opt", "step"} at step 0 for `params`: whole, or the
    rank's blocks of which `split` (the model's) says which. With
    `shardings` (the step's `grad_shardings`), the optimizer state is this
    rank's ZeRO-1 share: its block of each moment or statistic (inside what
    it holds), empty tensors where another rank owns the layer."""
    if shardings is None:
        opt_state = opt.init(params, split)
    else:
        opt_state = opt.init(_local(params, shardings.local_index(params, dist.get_rank())),
                             (split or WHOLE).zero(shardings))
    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return {"params": params, "opt": opt_state, "step": step}


def make_init_state(model: Model, opt: Optimizer, shardings=None):
    """init_state(generator) -> `train_state` of the model's params drawn
    from `generator` (under `shardings`, the same seed gives every rank the
    same draw, so the params are whole and alike on every rank; under a
    "model" axis each rank's blocks of that draw)."""
    def init_state(generator: torch.Generator) -> Dict[str, Any]:
        return train_state(model.init_params(generator), opt, shardings, model.split)
    return init_state
