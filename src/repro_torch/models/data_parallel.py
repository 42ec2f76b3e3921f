"""FSDP and expert parallelism over the mesh's data-parallel axes: what a
rank of the dense, MoE and VLM models holds of the weights the reference's
specs put on "data", and the collectives that make its blocks compute what
the whole weights compute.

The reference binds three logical axes to the data-parallel mesh axes
(`sharding/axes.py`): "fsdp" (the d_model dim of every column- and
row-parallel weight and of the embeddings, for the archs with cfg.fsdp),
"expert" (the MoE experts) and "pod_fsdp" (the experts' d_model across
pods). XLA then gathers the weights before each use and moves the tokens
to their experts with an all-to-all. The port runs eagerly, so each rank
holds its block of those weights (`sharding/rules.py::model_shardings`)
and the models call the collectives themselves, through a `DataParallel`
plan made from the guarded specs:

  * FSDP (`FSDPGather`): a layer gathers its FSDP leaves once before use
    (`gather`), over the group of the axes that cut them, and drops them
    after; the embeddings gather their d_model before the lookup and the
    logits. Backward is the reduce-scatter of the gathered weight's
    gradient, summed over the group in the gradient's dtype (for two
    ranks, their sum rounded once, as an fp32 sum cast back rounds it):
    the rank's block comes out holding the group's sum, which the train
    step divides by M n once, as it divides the all-reduced gradients.
    Under remat the replay of a layer gathers again.
  * EP (`ExpertAllToAll`): the rank holds E/n of the experts (n = the
    "data" axis's size, where it divides E; the guard replicates them
    otherwise, and then no all-to-all runs). The dispatched slots go from
    group-major (G, E, C, d), the rank's G groups, to expert-major
    (E/n, n G, C, d), its experts' slots of every rank's groups, over the
    "data" group, and back after the expert products. Each direction's
    backward is the other. The gradient of the rank's experts is therefore
    the sum over the data group's tokens already.

Each collective runs under a `record_function` ("dp_all_gather",
"dp_reduce_scatter", "ep_all_to_all"), which a profile of the step reads,
and is counted by that name in `calls` (read by chip_smoke.py, as the
kernels' launch counters are).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import group_over
from repro_torch.sharding.rules import Path, logical_spec, model_dims, split_path, stacked_view
from repro_torch.tree import map_with_path

# the collectives run in this process, by span name
calls = {"dp_all_gather": 0, "dp_reduce_scatter": 0, "ep_all_to_all": 0}


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's x, concatenated in rank order along `dim`, contiguous
    (the kernels read their operands through TMA)."""
    calls["dp_all_gather"] += 1
    with torch.profiler.record_function("dp_all_gather"):
        n = dist.get_world_size(group)
        part = x.movedim(dim, 0).contiguous()
        out = part.new_empty((n * part.shape[0], *part.shape[1:]))
        return D.all_gather_(out, part, group).movedim(0, dim).contiguous()


def _reduce_scatter_dim(dy: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The rank's part along `dim` of the sum over the ranks of dy, in dy's
    dtype."""
    calls["dp_reduce_scatter"] += 1
    with torch.profiler.record_function("dp_reduce_scatter"):
        n = dist.get_world_size(group)
        inp = dy.movedim(dim, 0).contiguous()
        out = inp.new_empty((inp.shape[0] // n, *inp.shape[1:]))
        return D.reduce_scatter_(out, inp, group).movedim(0, dim)


class FSDPGather(torch.autograd.Function):
    """The all-gather of a leaf's `dim` over `group` forward; backward the
    reduce-scatter of the gradient, summed over the group."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter_dim(dy, ctx.dim, ctx.group), None, None


def _to_experts(x: torch.Tensor, group) -> torch.Tensor:
    """(G, E, C, d) slots of the rank's groups -> (E/n, n G, C, d): its
    experts' slots of every rank's groups, rank by rank."""
    calls["ep_all_to_all"] += 1
    with torch.profiler.record_function("ep_all_to_all"):
        n = dist.get_world_size(group)
        G, E, C, d = x.shape
        inp = x.transpose(0, 1).reshape(n, E // n, G, C, d).contiguous()
        out = D.all_to_all_(torch.empty_like(inp), inp, group)
        return out.transpose(0, 1).reshape(E // n, n * G, C, d)


def _to_groups(y: torch.Tensor, group) -> torch.Tensor:
    """The inverse of `_to_experts`: (E/n, n G, C, d) -> (G, E, C, d)."""
    calls["ep_all_to_all"] += 1
    with torch.profiler.record_function("ep_all_to_all"):
        n = dist.get_world_size(group)
        El, nG, C, d = y.shape
        inp = y.reshape(El, n, nG // n, C, d).transpose(0, 1).contiguous()
        out = D.all_to_all_(torch.empty_like(inp), inp, group)
        return out.reshape(n * El, nG // n, C, d).transpose(0, 1)


class ExpertAllToAll(torch.autograd.Function):
    """Group-major to expert-major over the "data" group (`to_experts`), or
    back; the backward of each is the other."""

    @staticmethod
    def forward(ctx, x, group, to_experts):
        ctx.group, ctx.to_experts = group, to_experts
        return (_to_experts if to_experts else _to_groups)(x, group)

    @staticmethod
    def backward(ctx, dy):
        back = _to_groups if ctx.to_experts else _to_experts
        return back(dy.contiguous(), ctx.group), None, None


def _is_expert(path: Path) -> bool:
    return "moe" in path and "dense" not in path and path[-1] in ("w1", "w3", "w2")


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """What a rank holds over the data axes, by stacked path: the dims of
    each leaf gathered before use, each with the group that gathers it
    (`gathers`), and the group the experts are split over (`ep_group`,
    None where every rank holds every expert)."""
    gathers: Dict[Path, Tuple[Tuple[int, Any], ...]]
    ep_group: Any = None

    @classmethod
    def plan(cls, cfg: ModelConfig, whole, mesh, rules) -> Optional["DataParallel"]:
        """The plan of `whole` (a params tree, meta tensors will do) on
        `mesh` under `rules`, or None where no leaf is cut over a data axis."""
        view = stacked_view(whole)
        gathers: Dict[Path, list] = {}
        ep_axes = None
        for path, cut in model_dims(whole, cfg, mesh, rules).items():
            depth = view[path].depth
            logical = logical_spec(path, view[path].shape, cfg)
            for dim, axes in cut.data:
                if _is_expert(path) and logical[dim + depth] == "expert":
                    if ep_axes not in (None, axes):
                        raise ValueError(f"the experts split over {ep_axes} and {axes}")
                    ep_axes = axes
                    continue
                gathers.setdefault(path, []).append((dim, group_over(mesh, axes)))
        if not gathers and ep_axes is None:
            return None
        return cls({p: tuple(g) for p, g in gathers.items()},
                   None if ep_axes is None else group_over(mesh, ep_axes))

    def gather_leaf(self, t: torch.Tensor, path) -> torch.Tensor:
        """The leaf at `path` (a port path) gathered over the data axes that
        cut it: what the rank holds of it with those axes whole."""
        for dim, group in self.gathers.get(split_path(path)[0], ()):
            t = FSDPGather.apply(t, dim, group)
        return t

    def gather(self, tree, prefix=()):
        """`tree` (at `prefix` in the params) with its FSDP leaves gathered;
        the experts stay the rank's."""
        return map_with_path(lambda path, t: self.gather_leaf(t, tuple(prefix) + path), tree)

    def to_experts(self, x: torch.Tensor) -> torch.Tensor:
        return ExpertAllToAll.apply(x, self.ep_group, True)

    def to_groups(self, y: torch.Tensor) -> torch.Tensor:
        return ExpertAllToAll.apply(y, self.ep_group, False)


def gather(dp: Optional[DataParallel], tree, prefix=()):
    """`dp.gather(tree, prefix)`, or `tree` itself without a plan."""
    return tree if dp is None else dp.gather(tree, prefix)
