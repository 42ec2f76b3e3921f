"""Nested dicts and lists of tensors: the port's pytrees.

Params, optimizer state and train state are plain containers (the JAX
pytrees' keys, with `params["layers"]` a list of per-layer dicts); these
helpers walk them in one fixed order, JAX's: dict keys sorted, list items
by index. So two trees with the same keys give their leaves in the same
order, however each was built.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[Any, ...]


def tree_map(fn: Callable, tree, *rest):
    """fn applied to each leaf of `tree` (and the same leaf of each of
    `rest`, which share its structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, prefix: Path = ()):
    """fn(path, leaf) applied to each leaf of `tree`, in its structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], prefix + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def flatten(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) of every leaf; a path holds dict keys and list indices."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(pairs) -> Dict[Any, Any]:
    """Nested dicts from (path, leaf) pairs whose paths hold dict keys only."""
    out: Dict[Any, Any] = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def unflatten_like(tree, flat):
    """`flat`, a list in `leaves(tree)` order, in the structure of `tree`."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree
