"""Conversion between the JAX package's params/cache and the port's tensors.

The JAX side hands over pytrees (nested dicts) of arrays; the port takes
nested dicts of tensors with the same keys, except that stacked layer
parameters become lists: the leading L axis on every leaf of
`params["layers"]` (dense, MoE, VLM), of whisper's `params["enc_layers"]`
and `params["dec_layers"]` and of xLSTM's `params["slstm"]` a list of
per-layer dicts, and the leading two axes of the hybrid's `params["mamba"]`
(nb, attn_every) and of xLSTM's `params["mlstm"]` (nb, slstm_every - 1) a
list of nb lists of per-block dicts. Caches keep their stacked layout on
both sides (dense k/v (L,B,S,H,D); hybrid k/v (nb,B,W,H,hd), conv
(nb,k,B,K-1,C), ssm (nb,k,B,H,P,N); whisper k/v (L,B,S,H,hd) and
cross_k/cross_v (L,B,T_enc,H,hd); xLSTM m_C (nb,n_m,B,H,Dh,Dh), m_n, m_m
and s_c, s_n, s_m, s_h (nb,B,H,Dhs)). Weights keep their (d_in, d_out)
orientation on both sides. bf16 arrays cross through float32, which is exact in both
directions (`torch.from_numpy` does not take ml_dtypes' bfloat16). Every
array is copied, since numpy views of JAX arrays are read-only.

A train state ({"params", "opt", "step"}) crosses whole: AdamW's m and v
are unstacked as the params are; Adafactor's per-leaf state follows the
port's grouping (`optim/optimizers.py::per_layer`): the state of a stacked
leaf that the reference updates item by item along the stack's first axis
is split along that axis only, into `s["layers"]` (one per layer) or
`s["mamba"]` (one per super-block, each still stacked over attn_every);
the state of the others (the per-layer norms and biases, factored over
the stack) stays stacked in `s["layers_stacked"]` or `s["mamba_stacked"]`.

`shard_params` cuts the port's whole params to a rank's blocks (over
"model", and over the data axes where FSDP and the experts cut them), and
`shard_train_state` a whole train state: the params' blocks, each AdamW
moment's and each Adafactor statistic's block of the whole leaf's (`vr` cut
where the leaf's rows are, `vc` where its columns are; with ZeRO, the
rank's ZeRO-1 block), so both packages can start from the same step-k
state. `assemble` puts every rank's blocks
of a tree back together into the whole tree, for the comparison.
`shard_cache` cuts a whole decode cache to what a rank's model holds: its
block under the reference dry-run's cache specs, and its heads of the
recurrent states that those specs leave whole (the hybrid's `ssm`, the
xLSTM's `m_C`).

The RL rollout's policy weights ({"w1", "w2", "w3"}) and a surrogate
environment's matrices (W, Pobs, Pact) cross as they are
(`policy_from_jax`, `surrogate_matrices_from_numpy`).

This module imports neither JAX nor the JAX package: it works on anything
`numpy.asarray` accepts, and returns numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.optim.optimizers import per_layer
from repro_torch.sharding.axes import rules_for
from repro_torch.sharding.rules import (cache_shardings, coordinate, model_shardings,
                                        state_shardings)
from repro_torch.tree import (flatten, get, leaves, map_with_path, tree_map, unflatten,
                              unflatten_like)


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


# params keys whose leaves are stacked, with the number of stacked axes
_STACKED = {"layers": 1, "mamba": 2, "mlstm": 2, "slstm": 1, "enc_layers": 1,
            "dec_layers": 1}


def _unstack(tree, depth: int):
    """A tree whose leaves share `depth` leading axes -> nested lists of
    trees, one per index."""
    if depth == 0:
        return tree
    n = leaves(tree)[0].shape[0]
    return [_unstack(tree_map(lambda t: t[i], tree), depth - 1) for i in range(n)]


def _stack(items, depth: int):
    """The inverse of _unstack, on numpy leaves."""
    if depth == 0:
        return items
    trees = [_stack(it, depth - 1) for it in items]

    def zip_trees(ts):
        if isinstance(ts[0], dict):
            return {k: zip_trees([t[k] for t in ts]) for k in ts[0]}
        return np.stack(ts)
    return zip_trees(trees)


def params_from_jax(params: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX params (stacked layers) -> the port's params (lists of layers)."""
    out = {}
    for k, v in params.items():
        tree = tree_map(lambda a: tensor_from_array(a, device), v)
        out[k] = _unstack(tree, _STACKED.get(k, 0))
    return out


def shard_params(params: Dict[str, Any], cfg, mesh, rank: int) -> Dict[str, Any]:
    """Rank `rank`'s block of every leaf of the port's whole `params` on
    `mesh` (`sharding/rules.py::model_shardings`, the reference's
    `named_shardings`), as `init_params(..., mesh=, rank=)` draws them: a
    contiguous copy where the block is not the whole leaf."""
    return model_shardings(params, cfg, mesh, rules_for(mesh)).take(params, rank)


def assemble(parts, shardings) -> Dict[str, Any]:
    """The whole tree of which `parts[r]` holds rank r's blocks under
    `shardings` (every rank's, in rank order; tensors or numpy arrays; a
    block several ranks hold is taken from the first): numpy arrays."""
    first = parts[0]
    out = []
    for j, (path, _) in enumerate(flatten(first)):
        whole = np.zeros(shardings.full_shape(path),
                         dtype=np.asarray(_np_leaf(leaves(first)[j])).dtype)
        for r, part in enumerate(parts):
            b = shardings.block_of(path, r)
            if b is not None:
                whole[b] = _np_leaf(leaves(part)[j])
        out.append(whole)
    return unflatten_like(first, out)


def _np_leaf(x) -> np.ndarray:
    return array_from_tensor(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def shard_train_state(state: Dict[str, Any], cfg, mesh, rank: int,
                      shardings=None) -> Dict[str, Any]:
    """Rank `rank`'s blocks of the port's whole train state on `mesh`, as
    `train_state` makes them and the step updates them
    (`sharding/rules.py::state_shardings`): the params' blocks, and each
    optimizer leaf's block of the whole leaf (AdamW's moments as their
    params; Adafactor's `vr` cut where the leaf's rows and leading dims
    are, `vc` where its columns and leading dims are). With `shardings`,
    the step's ZeRO-2 `grad_shardings`, the optimizer leaves are the rank's
    ZeRO-1 blocks: contiguous copies, empty tensors where another rank owns
    the leaf's layer."""
    sh = state_shardings(state, cfg, mesh, rules_for(mesh), shardings)

    def cut(path, t):
        b = sh.block_of(path, rank)
        return t.new_empty((0,)) if b is None else t[b].clone()
    return map_with_path(cut, state)


# cache leaves whose heads (dim 3) the port cuts over "model" though the
# reference's cache specs leave them whole (H is not among their last two dims)
_HEADS_CUT = {"ssm", "m_C"}


def shard_cache(cache: Dict[str, Any], cfg, mesh, rank: int, global_batch: int):
    """Rank `rank`'s part of a whole decode cache (the stacked layout; numpy
    arrays or tensors) on `mesh`, as its model's `init_cache` lays it out:
    its block under `sharding/rules.py::cache_shardings` (its data
    coordinate's rows of the `global_batch`; the k/v cache heads and the
    xLSTM's m_n, m_m and s_* heads over "model" where they divide), and of
    the hybrid's `ssm` and the xLSTM's `m_C`, which those specs leave whole,
    its heads where the "model" axis divides them. Views of `cache`."""
    sh = cache_shardings(cache, cfg, mesh, rules_for(mesh), global_batch)
    axes = dict(zip(mesh.axis_names, zip(mesh.shape, coordinate(mesh, rank))))
    n, r = axes.get("model", (1, 0))
    out = {}
    for name, leaf in cache.items():
        part = leaf[sh.block_of((name,), rank)]
        if name in _HEADS_CUT and part.shape[3] % n == 0:
            h = part.shape[3] // n
            part = part[:, :, :, r * h:(r + 1) * h]
        out[name] = part
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params -> numpy arrays with the layers stacked again."""
    return {k: _stack(tree_map(array_from_tensor, v), _STACKED.get(k, 0))
            for k, v in params.items()}


def cache_from_jax(cache: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """A JAX cache (dense: {"k", "v"[, "k_scale", "v_scale"]}; hybrid:
    {"k", "v", "conv", "ssm"}; whisper: {"k", "v", "cross_k", "cross_v"};
    xLSTM: {"m_C", "m_n", "m_m", "s_c", "s_n", "s_m", "s_h"}) -> tensors of
    the same layout."""
    return {k: tensor_from_array(v, device) for k, v in cache.items()}


def cache_to_numpy(cache: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: array_from_tensor(v) for k, v in cache.items()}


def train_state_from_jax(state: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """A JAX train state {"params", "opt", "step"} (AdamW's {"m", "v",
    "step"} or Adafactor's {"s", "step"}) -> the port's."""
    def tensors(tree):
        return tree_map(lambda a: tensor_from_array(a, device), tree)

    jopt = state["opt"]
    opt = {"step": tensor_from_array(jopt["step"], device)}
    if "m" in jopt:
        opt["m"] = params_from_jax(jopt["m"], device)
        opt["v"] = params_from_jax(jopt["v"], device)
    else:
        s = {}
        for k, js in jopt["s"].items():
            if k not in _STACKED:
                s[k] = tensors(js)
                continue
            paths = [(path, np.shape(a)) for path, a in flatten(state["params"][k])]
            s[k] = [unflatten((path, tensors(tree_map(lambda a: a[i], get(js, path))))
                              for path, shape in paths if per_layer(shape))
                    for i in range(paths[0][1][0])]
            s[k + "_stacked"] = unflatten((path, tensors(get(js, path)))
                                          for path, shape in paths if not per_layer(shape))
        opt["s"] = s
    return {"params": params_from_jax(state["params"], device), "opt": opt,
            "step": tensor_from_array(state["step"], device)}


def train_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's train state -> numpy arrays in the JAX layout."""
    opt = state["opt"]
    out_opt = {"step": array_from_tensor(opt["step"])}
    params = params_to_numpy(state["params"])
    if "m" in opt:
        out_opt["m"] = params_to_numpy(opt["m"])
        out_opt["v"] = params_to_numpy(opt["v"])
    else:
        s = {}
        for k in params:
            if k not in _STACKED:
                s[k] = tree_map(array_from_tensor, opt["s"][k])
                continue
            per = _stack([tree_map(array_from_tensor, si) for si in opt["s"][k]], 1)
            stacked = tree_map(array_from_tensor, opt["s"][k + "_stacked"])
            s[k] = unflatten((path, get(per, path) if per_layer(np.shape(a))
                              else get(stacked, path)) for path, a in flatten(params[k]))
        out_opt["s"] = s
    return {"params": params, "opt": out_opt, "step": array_from_tensor(state["step"])}


def policy_from_jax(params: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """The RL policy's weights (`rl/rollout.py::init_policy`) -> tensors."""
    return {k: tensor_from_array(v, device) for k, v in params.items()}


def surrogate_matrices_from_numpy(matrices, device="cpu"):
    """A surrogate environment's (W, Pobs, Pact) -> tensors, for
    `rl/envs.py::surrogate_step_fn(..., matrices=...)`."""
    return tuple(tensor_from_array(m, device) for m in matrices)
