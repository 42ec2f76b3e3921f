"""Logical-axis sharding, the port of the JAX package's `sharding/axes.py`:
model code names *logical* axes; a binding maps them to the mesh's
physical axes.

A spec is the port's own plain tuple, one entry per tensor dim: None, one
mesh axis name, or a tuple of names. That is the shape of a
`jax.sharding.PartitionSpec`, which the port does not import. A mesh is
anything with `axis_names` and `shape` (`launch/mesh.py::Mesh`).

The reference's `constrain` and `named_sharding` (activation constraints
inside the model) come with the dry-run slice: only XLA's lowering reads
them, and the port's models do not annotate their activations yet.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

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
