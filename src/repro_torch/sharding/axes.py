"""Logical-axis sharding, the port of the JAX package's `sharding/axes.py`:
model code names *logical* axes; a binding maps them to the mesh's
physical axes.

A spec is the port's own plain tuple, one entry per tensor dim: None, one
mesh axis name, or a tuple of names. That is the shape of a
`jax.sharding.PartitionSpec`, which the port does not import. A mesh is
anything with `axis_names` and `shape` (`launch/mesh.py::Mesh`).

`constrain` and `named_sharding` are the reference's activation
annotations. There XLA reads a constraint and inserts the collectives it
needs; the port's models run eagerly and call their collectives
themselves (`models/tensor_parallel.py`), so `constrain` checks instead: it
raises unless the tensor is the rank's block of the tensor the spec
describes. Outside a binding both are no-ops, as the reference's are.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

Logical = Union[str, None, Tuple[str, ...]]
Entry = Union[str, None, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

_state = threading.local()


def _current():
    return getattr(_state, "binding", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, Tuple[str, ...]]):
    """Bind logical axis names to physical mesh axes for the enclosed scope
    (per thread)."""
    prev = _current()
    _state.binding = (mesh, rules)
    try:
        yield
    finally:
        _state.binding = prev


def resolve(spec: Sequence[Logical]) -> Optional[Spec]:
    """Logical spec -> physical spec under the current binding (None if
    unbound)."""
    bound = _current()
    if bound is None:
        return None
    _, rules = bound
    out = []
    for ax in spec:
        if ax is None:
            out.append(None)
        elif isinstance(ax, tuple):
            phys: Tuple[str, ...] = ()
            for a in ax:
                phys = phys + rules.get(a, ())
            out.append(phys if phys else None)
        else:
            phys = rules.get(ax, ())
            out.append(phys if phys else None)
    return tuple(out)


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def guard_divisibility(mesh, shape, spec: Spec) -> Spec:
    """Drop mesh axes from dims they don't divide (8 KV heads on a 16-way
    model axis fall back to replication), so every spec is legal for any
    arch and mesh. A bare axis stays bare, a tuple stays a tuple."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        total = 1
        kept = []
        for a in axes:
            if dim % (total * sizes[a]) == 0:
                kept.append(a)
                total *= sizes[a]
        if not kept:
            out.append(None)
        elif isinstance(entry, tuple):
            out.append(tuple(kept))
        else:
            out.append(kept[0])
    return tuple(out)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> tuple:
    """DeviceMesh placements of a tensor under `spec`: per mesh axis,
    `Shard(dim)` where the spec names the axis on dim, else `Replicate()`
    (the counterpart of the reference's `NamedSharding`)."""
    dims = {a: d for d, e in enumerate(spec) for a in _axes(e)}
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in mesh.axis_names)


def constrain(x, *spec: Logical, full: Optional[Sequence[int]] = None):
    """The reference's sharding constraint, as a check: under a binding, `x`
    must be a rank's block of a tensor of shape `full` (default: x's own
    shape, a tensor no rank splits) laid out by the logical `spec`,
    resolved and guarded as the reference guards it. Raises if it is not;
    returns x. A no-op when unbound."""
    bound = _current()
    if bound is None:
        return x
    mesh, _ = bound
    full = tuple(x.shape) if full is None else tuple(full)
    sizes = axis_sizes(mesh)
    phys = guard_divisibility(mesh, full, resolve(spec))
    want = []
    for dim, entry in zip(full, phys + (None,) * (len(full) - len(phys))):
        n = 1
        for a in _axes(entry):
            n *= sizes[a]
        want.append(dim // n)
    if tuple(x.shape) != tuple(want):
        raise ValueError(f"a tensor of shape {tuple(x.shape)} is not a rank's block of "
                         f"{full} under {spec} -> {phys}: want {tuple(want)}")
    return x


def named_sharding(*spec: Logical) -> Optional[tuple]:
    """The DeviceMesh placements of the logical `spec` under the binding
    (unguarded, as the reference's), or None when unbound."""
    bound = _current()
    if bound is None:
        return None
    mesh, _ = bound
    return placements(resolve(spec), mesh)


# Default bindings ------------------------------------------------------------

def single_pod_rules() -> Dict[str, Tuple[str, ...]]:
    return {
        "batch": ("data",),
        "model": ("model",),
        "expert": ("data",),   # EP over the DP axis (all-to-all dispatch)
        "ep_batch": (),        # group axis in expert-major layout
        "fsdp": ("data",),     # weight sharding for the largest models
        "pod_fsdp": (),        # expert-weight sharding across pods
        "seq": (),             # sequence parallelism: off by default
    }


def multi_pod_rules() -> Dict[str, Tuple[str, ...]]:
    return {
        "batch": ("pod", "data"),
        "model": ("model",),
        "expert": ("data",),   # EP within a pod; experts replicated across pods
        "ep_batch": ("pod",),  # expert-major keeps pod-locality (a2a stays in-pod)
        "fsdp": ("pod", "data"),
        "pod_fsdp": ("pod",),  # expert weights gather across pods per layer
        "seq": (),
    }


def rules_for(mesh) -> Dict[str, Tuple[str, ...]]:
    """The default bindings of a mesh: the multi-pod rules on a mesh with a
    "pod" axis, else the single-pod rules."""
    return multi_pod_rules() if "pod" in mesh.axis_names else single_pod_rules()
