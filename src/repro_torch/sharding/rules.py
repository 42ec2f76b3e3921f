"""Parameter -> spec rules for every architecture family, the port of the JAX
package's `sharding/rules.py`, and what the port makes of a spec: the block
of a leaf that each rank holds.

Name-based dispatch over the param tree paths that `models/` produce.
Conventions (logical axes; bound to physical axes by `axes.py`):
  * column-parallel (d -> wide):   (..., "fsdp", "model")
  * row-parallel   (wide -> d):    (..., "model", "fsdp")
  * experts: ("expert" = data axis) leading, d_ff over "model" (expert-TP)
  * embeddings: vocab over "model", d over "fsdp"
  * norms / small vectors / convs: replicated
"fsdp" resolves to the DP axes only for archs with cfg.fsdp=True (arctic,
internvl2, qwen1.5-32b); otherwise to () = no sharding.

The stacked view. The reference stacks a model's layers on leading axes;
the port keeps them as lists (`bridge.py`): `params["layers"][i]`, or
`params["mamba"][i][j]` for the hybrid's (nb, attn_every) stack. Every rule
here runs on the stacked view (`stacked_view`): a leaf's path without its
list indices, and its shape with the lists' lengths prepended, which is the
reference's leaf. Adafactor's state keeps the stacked statistics of a stack
under `key + "_stacked"` (`optim/optimizers.py::per_layer`); the view files
them under `key`, where the reference keeps them. A spec entry on a stacked
axis becomes ownership of whole items of the list: with L layers and the
data axis of size n on the layer axis, rank r holds layers [r L/n, (r+1)
L/n). An entry on an inner dim is a `Shard(dim)` placement of each item.
`Shardings.index` gives, for each leaf of a port tree, the rank's block of
it: a tuple of slices, or None where another rank owns the item.

What a rank holds of the params is the reference's block of every leaf
(`model_shardings`): its "model" block, and where the guarded specs put
"fsdp", "expert" or "pod_fsdp" on a dim, its block of that dim over the
data-parallel axes too. `model_dims` says, per leaf, which dim of the port's
leaf each axis cuts (`Cut`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import DP_AXES
from repro_torch.sharding.axes import Spec, _axes, axis_sizes, guard_divisibility
from repro_torch.sharding.axes import placements  # noqa: F401  (re-exported)
from repro_torch.tree import flatten, map_with_path

Path = Tuple[str, ...]

# suffix -> logical spec for the trailing (non-stacked) dims
_COL = ("fsdp", "model")      # (d_in, d_out_wide)
_ROW = ("model", "fsdp")      # (d_in_wide, d_out)
_RULES: Dict[str, Tuple] = {
    # dense attention / mlp
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    "w1": _COL, "w3": _COL, "w2": _ROW,
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    # embeddings
    "tok": ("model", "fsdp"), "out": ("model", "fsdp"),
    # mamba2
    "w_zx": _COL, "w_bc": (None, None), "w_dt": (None, None),
    "w_out": _ROW, "conv_w": (None, None), "conv_b": (None,),
    "A_log": (None,), "D": (None,), "dt_bias": (None,), "norm_w": (None,),
    # xlstm
    "w_up": _COL, "w_down": _ROW,
    "w_q": (None, "model"), "w_k": (None, "model"), "w_v": (None, "model"),
    "w_if": (None, None), "b_if": (None,), "r_gates": (None, None, None),
    "w_gates": _COL, "b_gates": (None,), "w_ff1": _COL, "w_ff2": _ROW,
    # moe
    "router": (None, None),
}
_MOE_RULES = {
    # experts over the in-pod DP axis (EP), d_ff over model (expert-TP),
    # d_model over the pod axis on multi-pod meshes (expert FSDP across
    # pods: "pod_fsdp" resolves to () on a single pod)
    "w1": ("expert", "pod_fsdp", "model"),
    "w3": ("expert", "pod_fsdp", "model"),
    "w2": ("expert", "model", "pod_fsdp"),
}

_STACKED_SUFFIX = "_stacked"


# ----------------------------------------------------------------------------
# The stacked view
# ----------------------------------------------------------------------------

def split_path(path) -> Tuple[Path, Tuple[int, ...]]:
    """A port path -> (its stacked-view path, its indices into the lists)."""
    keys = tuple(k[:-len(_STACKED_SUFFIX)] if k.endswith(_STACKED_SUFFIX) else k
                 for k in path if isinstance(k, str))
    return keys, tuple(k for k in path if isinstance(k, int))


@dataclasses.dataclass(frozen=True)
class Stacked:
    shape: Tuple[int, ...]   # the reference's leaf shape
    depth: int               # how many leading axes are list axes in the port


def stacked_view(tree) -> Dict[Path, Stacked]:
    """Stacked path -> the reference's leaf, for every leaf of a port tree
    (params, optimizer or train state; tensors of any device, meta too)."""
    lengths: Dict[Path, List[int]] = {}
    inner: Dict[Path, Tuple[int, ...]] = {}
    for path, leaf in flatten(tree):
        spath, idx = split_path(path)
        inner[spath] = tuple(leaf.shape)
        seen = lengths.setdefault(spath, [0] * len(idx))
        for axis, i in enumerate(idx):
            seen[axis] = max(seen[axis], i + 1)
    return {p: Stacked(tuple(lengths[p]) + inner[p], len(lengths[p])) for p in inner}


# ----------------------------------------------------------------------------
# Specs
# ----------------------------------------------------------------------------

def logical_spec(path: Path, shape, cfg: ModelConfig) -> Tuple:
    """The logical spec of the (stacked) leaf at `path`: the rule of its
    last name, padded with None over its leading (stacked) dims."""
    names = [k for k in path if isinstance(k, str)]
    name = names[-1] if names else ""
    if "moe" in names and name in _MOE_RULES and "dense" not in names:
        rule = _MOE_RULES[name]
    else:
        rule = _RULES.get(name, ())   # norms, scalars -> replicated
    lead = len(shape) - len(rule)
    if lead < 0:
        raise ValueError(f"{path}: rule {rule} has more dims than the leaf {tuple(shape)}")
    return (None,) * lead + tuple(rule)


def _effective_rules(cfg: ModelConfig, rules) -> Dict[str, Tuple[str, ...]]:
    eff = dict(rules)
    if not cfg.fsdp:
        eff["fsdp"] = ()
    return eff


def _physical(spec, rules) -> Spec:
    out = []
    for ax in spec:
        if ax is None:
            out.append(None)
        else:
            phys = rules.get(ax, ())
            out.append(phys if phys else None)
    return tuple(out)


def param_specs(view: Dict[Path, Stacked], cfg: ModelConfig,
                rules: Dict[str, Tuple[str, ...]]) -> Dict[Path, Spec]:
    """Stacked path -> physical spec (the reference's `param_pspecs`).
    `rules` maps logical names to physical axes (axes.single_pod_rules);
    for non-FSDP archs "fsdp" is stripped here."""
    eff = _effective_rules(cfg, rules)
    return {p: _physical(logical_spec(p, s.shape, cfg), eff) for p, s in view.items()}


def zero1_extend(spec: Spec, shape, mesh, dp_axes: Tuple[str, ...]) -> Spec:
    """ZeRO-1: shard optimizer state over the DP axes by assigning them to
    the first unsharded dim they divide (no-op if none divides)."""
    sizes = axis_sizes(mesh)
    dp = [a for a in dp_axes if a in sizes]
    if not dp:
        return spec
    used = set()
    for e in spec:
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            used.add(a)
    dp = [a for a in dp if a not in used]
    if not dp:
        return spec
    dp_size = math.prod(sizes[a] for a in dp)
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % dp_size == 0 and dim >= dp_size:
            entries[i] = tuple(dp)
            return tuple(entries)
    return spec


def leaf_spec(path: Path, leaf: Stacked, cfg: ModelConfig, mesh, rules,
              dp_axes: Tuple[str, ...], zero1: bool, zero1_stack: bool = True) -> Spec:
    """The spec of one stacked leaf on `mesh`: its rule, guarded; with
    `zero1`, extended over the DP axes and guarded again (the reference
    dry-run's `_leaf_sharding`). `zero1_stack=False` keeps the DP axes off
    the stacked axes: each item of the list is split instead of owned."""
    spec = guard_divisibility(mesh, leaf.shape,
                              _physical(logical_spec(path, leaf.shape, cfg),
                                        _effective_rules(cfg, rules)))
    if zero1:
        lead = 0 if zero1_stack else leaf.depth
        spec = spec[:lead] + zero1_extend(spec[lead:], leaf.shape[lead:], mesh, dp_axes)
        spec = guard_divisibility(mesh, leaf.shape, spec)
    return spec


# ----------------------------------------------------------------------------
# Where a leaf lives
# ----------------------------------------------------------------------------

def coordinate(mesh, rank: int) -> Tuple[int, ...]:
    """Rank -> its coordinates on the mesh (row-major, as
    `init_device_mesh` lays the ranks out)."""
    out = []
    for n in reversed(mesh.shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def block(shape, spec: Spec, mesh, coord) -> Tuple[slice, ...]:
    """The block of a `shape` array under `spec` held at mesh coordinates
    `coord`: a dim sharded over axes (a, b) is cut into size(a) * size(b)
    equal parts, taken row-major over the axes."""
    sizes, pos = axis_sizes(mesh), dict(zip(mesh.axis_names, coord))
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n, k = 1, 0
        for a in _axes(entry):
            n, k = n * sizes[a], k * sizes[a] + pos[a]
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split {n} ways ({spec})")
        out.append(slice(k * (dim // n), (k + 1) * (dim // n)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Shardings:
    """The port's counterpart of a tree of `NamedSharding`: a mesh and, per
    stacked path of a tree, the reference's leaf shape and its spec; and
    `held`, the specs of the blocks a rank holds of a params-like tree (the
    guarded param specs, of which ZeRO-1's specs are the extension)."""
    mesh: Any
    shapes: Dict[Path, Tuple[int, ...]]
    specs: Dict[Path, Spec]
    held: Optional[Dict[Path, Spec]] = None

    def full_shape(self, path) -> Tuple[int, ...]:
        """The whole shape of the port leaf at `path`."""
        spath, idx = split_path(path)
        return self.shapes[spath][len(idx):]

    def block_of(self, path, rank: int) -> Optional[Tuple[slice, ...]]:
        """The block of the whole port leaf at `path` that `rank` holds, or
        None where another rank owns its item of the stack."""
        spath, idx = split_path(path)
        b = block(self.shapes[spath], self.specs[spath], self.mesh,
                  coordinate(self.mesh, rank))
        owned = all(s.start <= i < s.stop for s, i in zip(b, idx))
        return b[len(idx):] if owned else None

    def take(self, tree, rank: int, prefix: Path = ()):
        """`tree` (whole leaves, at `prefix` in the tree these shardings
        describe) with each leaf cut to `rank`'s block: a contiguous copy
        where the block is not the whole leaf. Raises where another rank
        owns a leaf's item of the stack."""
        def cut(path, t):
            b = self.block_of(prefix + path, rank)
            if b is None:
                raise ValueError(f"rank {rank} holds no block of {prefix + path}")
            if all(s.start == 0 and s.stop == n for s, n in zip(b, t.shape)):
                return t
            return t[b].clone()
        return map_with_path(cut, tree)

    def index(self, tree, rank: int) -> List[Optional[Tuple[slice, ...]]]:
        """For each leaf of `tree` (in `tree.leaves` order), `block_of` its
        path. Only the paths of `tree` are read, so it may hold whole leaves
        or the rank's blocks."""
        return [self.block_of(path, rank) for path, _ in flatten(tree)]

    def without(self, axes: Tuple[str, ...]) -> "Shardings":
        """These shardings with the mesh axes `axes` dropped from every spec:
        what a rank holds alike at every coordinate of those axes."""
        def keep(entry):
            kept = tuple(a for a in _axes(entry) if a not in axes)
            if not kept:
                return None
            return kept if isinstance(entry, tuple) else kept[0]
        return dataclasses.replace(self, specs={p: tuple(keep(e) for e in spec)
                                                for p, spec in self.specs.items()})

    def holding(self) -> "Shardings":
        """What a rank holds: the shardings of `held`, or without `held`
        these with the data-parallel axes dropped."""
        if self.held is None:
            return self.without(DP_AXES)
        return dataclasses.replace(self, specs=self.held)

    def local_block_of(self, path, rank: int,
                       held: Optional["Shardings"] = None) -> Optional[Tuple[slice, ...]]:
        """`block_of(path, rank)` in the coordinates of the block that `rank`
        holds (`held`, by default `holding()`): on a (dp, tp) mesh, a rank's
        ZeRO block of a leaf inside its "model" block of it, and the whole
        of a block cut over the data axes too (an FSDP or expert leaf, which
        ZeRO-1 cuts no further). Raises where the block does not lie inside
        the held one."""
        b = self.block_of(path, rank)
        if b is None:
            return None
        h = (held or self.holding()).block_of(path, rank)
        if any(s.start < o.start or s.stop > o.stop for s, o in zip(b, h)):
            raise ValueError(f"{path}: rank {rank}'s block {b} is not inside its block {h} "
                             "of the mesh's other axes")
        return tuple(slice(s.start - o.start, s.stop - o.start) for s, o in zip(b, h))

    def local_index(self, tree, rank: int) -> List[Optional[Tuple[slice, ...]]]:
        """For each leaf of `tree`, `local_block_of` its path."""
        held = self.holding()
        return [self.local_block_of(path, rank, held) for path, _ in flatten(tree)]


def shardings_for(tree, cfg: ModelConfig, mesh, rules, *, zero1: bool = False,
                  zero1_stack: bool = True) -> Shardings:
    """Shardings of a params-like tree (params, AdamW's m or v, a gradient
    accumulator) on `mesh`: guarded param specs (the reference's
    `named_shardings`), or with `zero1` its ZeRO-1 extension over the
    rules' batch axes (the dry-run's `grad_shardings`). `tree` holds whole
    leaves; meta tensors will do."""
    view = stacked_view(tree)
    dp_axes = tuple(rules.get("batch", ()))
    held = {p: leaf_spec(p, s, cfg, mesh, rules, dp_axes, False) for p, s in view.items()}
    return Shardings(mesh, {p: s.shape for p, s in view.items()},
                     {p: leaf_spec(p, s, cfg, mesh, rules, dp_axes, zero1, zero1_stack)
                      for p, s in view.items()} if zero1 else held, held)


def model_shardings(tree, cfg: ModelConfig, mesh, rules) -> Shardings:
    """What a rank holds of a params-like tree on `mesh`: the reference's
    block of every leaf under its guarded param specs (`named_shardings`):
    the "model" block, and where a spec puts the data-parallel axes on a dim
    ("fsdp" for the FSDP archs, cfg.fsdp; "expert" and "pod_fsdp" for the
    MoE experts), the block of that dim over them too. A leaf whose spec
    names no data axis is held alike at every data coordinate."""
    return shardings_for(tree, cfg, mesh, rules)


@dataclasses.dataclass(frozen=True)
class Cut:
    """How a rank's block of a leaf is cut, in the dims of the port's leaf
    (its list axes not counted): the dim cut over the "model" axis, or
    None; and each dim cut over data-parallel axes, with those axes."""
    model: Optional[int] = None
    data: Tuple[Tuple[int, Tuple[str, ...]], ...] = ()


def model_dims(tree, cfg: ModelConfig, mesh, rules) -> Dict[Path, Cut]:
    """Stacked path -> the `Cut` of each leaf that `model_shardings` cuts
    over an axis of size > 1 (the optimizers' `Split`, the train step, the
    FSDP gathers and the experts' all-to-all)."""
    sh, view = model_shardings(tree, cfg, mesh, rules), stacked_view(tree)
    sizes = axis_sizes(mesh)
    out = {}
    for p, spec in sh.specs.items():
        model, data = None, []
        for i, entry in enumerate(spec):
            live = tuple(a for a in _axes(entry) if sizes[a] > 1)
            if "model" in live:
                model = i - view[p].depth
            dp = tuple(a for a in live if a in DP_AXES)
            if dp:
                data.append((i - view[p].depth, dp))
        if model is not None or data:
            out[p] = Cut(model, tuple(data))
    return out


_STATS = {"vr": -1, "vc": -2, "v": None}   # Adafactor's statistic -> the dim it drops


def stat_spec(spec: Spec, ndim: int, stat: Optional[str]) -> Spec:
    """The block of a statistic (or a moment, `stat` None) of a leaf of
    `ndim` dims whose block is `spec`: `vr`, the mean over the last dim, is
    cut where the leaf's other dims are; `vc` where all but its second last
    are; `v` and the moments as the leaf is."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    drop = _STATS.get(stat)
    if drop is None:
        return spec
    return spec[:ndim + drop] + spec[ndim + drop + 1:]


def state_shardings(state, cfg: ModelConfig, mesh, rules,
                    updates: Optional[Shardings] = None) -> Shardings:
    """Shardings of a train state {"params", "opt", "step"} that state what
    a rank holds: the params' guarded specs (`model_shardings`), and each
    optimizer leaf its block of the whole leaf, which follows the block of
    its parameter that the step updates: under `updates`, the step's ZeRO-2
    grad shardings (`shardings_for(..., zero1=True)`), its ZeRO-1 block;
    without, the params' block. AdamW's moments are that block, Adafactor's
    statistics that block without the dim each averages away (`stat_spec`;
    a sum over the ranks that cut that dim makes the rest whole,
    `optim/optimizers.py`). `held` states the same leaves' blocks under the
    params' specs (the coordinates of `local_block_of`). `state` holds whole
    leaves; meta tensors will do.

    With `updates`, AdamW's blocks are the reference dry-run's ZeRO-1
    specs; its Adafactor statistics take the specs their names give (none:
    replicated) extended by ZeRO-1 on their own shapes, which the port's
    blocks are not (ROADMAP Queue 3)."""
    view = stacked_view(state)
    dp_axes = tuple(rules.get("batch", ()))
    params = {p[1:]: s for p, s in view.items() if p[0] == "params"}
    held = {p: leaf_spec(p, s, cfg, mesh, rules, dp_axes, False) for p, s in params.items()}
    upd = held if updates is None else updates.specs
    specs: Dict[Path, Spec] = {}
    held_specs: Dict[Path, Spec] = {}
    for p, s in view.items():
        if p[0] == "params":
            specs[p] = held_specs[p] = held[p[1:]]
        elif p[0] == "opt" and len(p) > 1 and p[1] != "step":
            # AdamW's ("opt", "m" or "v", *param), Adafactor's ("opt", "s", *param, stat)
            param, stat = (p[2:-1], p[-1]) if p[1] == "s" else (p[2:], None)
            ndim = len(params[param].shape)
            specs[p] = stat_spec(upd[param], ndim, stat)
            held_specs[p] = stat_spec(held[param], ndim, stat)
        else:   # the step counters
            specs[p] = held_specs[p] = (None,) * len(s.shape)
    return Shardings(mesh, {p: s.shape for p, s in view.items()}, specs, held_specs)


def cache_shardings(cache, cfg: ModelConfig, mesh, rules, global_batch: int) -> Shardings:
    """Shardings of a decode cache (a flat dict of stacked leaves, whole;
    meta tensors will do), the reference dry-run's `cache_shardings`: the
    batch dim (the first of `global_batch` rows past a leading layer dim)
    over the rules' batch axes, and after it a dim of the cache's or the
    config's kv-head count among the last two over "model", guarded. So a
    KV cache (L, B, S, Hc, D) splits its heads where they divide, and a
    recurrent state its batch only."""
    batch_axes, model_axes = rules.get("batch", ()), rules.get("model", ())
    head_dims = {cfg.cache_kv_heads, cfg.eff_kv_heads}
    shapes, specs = {}, {}
    for path, leaf in flatten(cache):
        shape = tuple(leaf.shape)
        spec: List[Any] = [None] * len(shape)
        used_batch = used_model = False
        for i, dim in enumerate(shape):
            if i == 0 and len(shape) >= 4:
                continue   # the stacked layer dim stays whole
            if not used_batch and dim == global_batch:
                spec[i], used_batch = batch_axes, True
            elif (not used_model and used_batch and dim in head_dims
                  and i >= len(shape) - 2):
                spec[i], used_model = model_axes, True
        shapes[path] = shape
        specs[path] = guard_divisibility(mesh, shape, tuple(e if e else None for e in spec))
    return Shardings(mesh, shapes, specs)
