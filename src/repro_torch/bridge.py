"""Conversion between the JAX package's params/cache and the port's tensors.

The JAX side hands over pytrees (nested dicts) of arrays; the port takes
nested dicts of tensors with the same keys, except that the stacked layer
parameters (a leading L axis on every leaf of `params["layers"]`) become a
list of per-layer dicts. Weights keep their (d_in, d_out) orientation on
both sides. bf16 arrays cross through float32, which is exact in both
directions (`torch.from_numpy` does not take ml_dtypes' bfloat16). Every
array is copied, since numpy views of JAX arrays are read-only.

This module imports neither JAX nor the JAX package: it works on anything
`numpy.asarray` accepts, and returns numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tensor_from_array(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def array_from_tensor(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # the dtype JAX uses for bfloat16 arrays
        return t.to(torch.float32).numpy().astype(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_from_jax(params: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX dense params (stacked layers) -> the port's params (layer list)."""
    out = {k: _tree_map(lambda a: tensor_from_array(a, device), v)
           for k, v in params.items() if k != "layers"}
    stacked = _tree_map(lambda a: tensor_from_array(a, device), params["layers"])
    n_layers = next(_leaves(stacked)).shape[0]
    out["layers"] = [_tree_map(lambda t: t[i], stacked) for i in range(n_layers)]
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params -> numpy arrays with the layers stacked again."""
    out = {k: _tree_map(array_from_tensor, v)
           for k, v in params.items() if k != "layers"}
    layers: List[Dict[str, Any]] = [_tree_map(array_from_tensor, lp)
                                    for lp in params["layers"]]

    def zip_trees(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: zip_trees([t[k] for t in trees]) for k in first}
        return np.stack(trees)

    out["layers"] = zip_trees(layers)
    return out


def cache_from_jax(cache: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """A JAX cache ({"k", "v"[, "k_scale", "v_scale"]}, (L,B,S,H,D)) ->
    tensors of the same layout."""
    return {k: tensor_from_array(v, device) for k, v in cache.items()}


def cache_to_numpy(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: array_from_tensor(v) for k, v in cache.items()}
