"""Uniform model interface of the port, over every family of the JAX package.

build_model(cfg, device=...) returns a Model whose members close over the
config and the device (and the MoE dispatch groups `n_groups`, and a
data-parallel `mesh`):
  init_params(generator)                -> params
  loss(params, batch)                   -> (scalar, metrics)     [train]
  prefill(params, batch)                -> (logits, cache)
  decode_step(params, cache, batch)     -> (logits, cache updated in place)
  init_cache(batch_size, max_len)       -> cache

input_specs(cfg, shape) gives meta tensors (shapes and dtypes, no data)
for every model input of an (arch x shape) cell, cache_specs(cfg, shape)
the decode cache of the cell as meta tensors, built by the model's own
init_cache on the meta device, so no full-width cache is ever allocated;
make_batch(cfg, shape) a concrete random batch of those specs.

`n_groups` splits each MoE layer's tokens into that many contiguous dispatch
groups (the reference sets it to the data-parallel degree). Under a `mesh`
(`launch/mesh.py`) each rank's model runs its share of the global batch:
build it with the rank's share of the groups (usually 1), and its loss
takes the MoE aux loss's means and a masked token mean over the mesh's
data-parallel group, so that the mean of the ranks' losses is the global
loss (`train/steps.py` under the same mesh).

Every family holds the reference's block of every leaf on any mesh (`sharding/rules.py::model_shardings`): over a
"model" axis larger than 1 (tensor parallelism, `tensor_parallel.py`), and
over the data axes where the guarded specs put them there: the FSDP archs'
weights (cfg.fsdp) and the MoE experts (expert parallelism;
`data_parallel.py`; the hybrid's, the xLSTM's and whisper's specs name no
data axis). The rank's init_params draws its blocks of the weights, init_cache holds
its rows' cache heads, and prefill and decode_step run under the mesh's
axis rules, whose `constrain` checks each annotated activation's layout,
and return the logits of the rank's rows. On a (dp, tp) mesh every data
rank prefills and decodes its share of the batch, in lockstep, since the
FSDP gathers and the experts' all-to-all span the data group. The loss
trains on any such mesh (`train/steps.py`): the rank's blocks compute the
whole model's loss on the rank's rows, through the differentiable
collectives of both modules, with the MoE aux loss's means over the data
group. Serving turns FSDP on where the reference's dry-run does
(`serve_config`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, param_count
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import dp_degree, dp_group, tp_degree, tp_group
from repro_torch.models import dense, hybrid, whisper, xlstm
from repro_torch.models.data_parallel import DataParallel
from repro_torch.models.tensor_parallel import TensorParallel
from repro_torch.optim.optimizers import Split
from repro_torch.sharding.rules import model_dims, model_shardings
from repro_torch.sharding.axes import axis_rules, rules_for
from repro_torch.models.whisper import ENC_LEN


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]
    mesh: Any = None
    tp: Any = None      # the rank's TensorParallel plan under a "model" axis
    split: Any = None   # the leaves it holds a block of (optimizers.Split)
    dp: Any = None      # its DataParallel plan where the data axes cut a leaf


def serve_config(cfg: ModelConfig) -> ModelConfig:
    """The reference dry-run's `_serve_cfg`: serving shards the weights over
    the data axes too (FSDP) where the 16-way model-parallel shard alone
    would pass 2 GiB a chip."""
    if param_count(cfg) * 2 / 16 > 2 * 2**30:
        return cfg.replace(fsdp=True)
    return cfg


def build_model(cfg: ModelConfig, *, device="cuda", window: Optional[int] = None,
                n_groups: int = 1, mesh=None) -> Model:
    dev = resolve_device(device)
    if mesh is not None and (tp_degree(mesh) > 1 or _cuts_data(cfg, mesh)):
        return _sharded_model(cfg, dev, window, n_groups, mesh)
    group = dp_group(mesh) if mesh is not None else None
    if cfg.family in ("dense", "moe", "vlm"):
        return Model(
            cfg=cfg,
            device=dev,
            init_params=functools.partial(dense.init_params, cfg=cfg, device=dev),
            loss=functools.partial(dense.lm_loss, cfg=cfg, n_groups=n_groups, group=group),
            prefill=functools.partial(dense.lm_prefill, cfg=cfg, window=window,
                                      n_groups=n_groups),
            decode_step=functools.partial(dense.lm_decode_step, cfg=cfg, n_groups=n_groups),
            init_cache=functools.partial(dense.init_cache, cfg, device=dev),
            mesh=mesh,
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            device=dev,
            init_params=functools.partial(hybrid.init_params, cfg=cfg, device=dev),
            loss=functools.partial(hybrid.lm_loss, cfg=cfg, group=group),
            prefill=functools.partial(hybrid.lm_prefill, cfg=cfg, window=window),
            decode_step=functools.partial(hybrid.lm_decode_step, cfg=cfg),
            init_cache=functools.partial(hybrid.init_cache, cfg, window=window,
                                         device=dev),
            mesh=mesh,
        )
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            device=dev,
            init_params=functools.partial(xlstm.init_params, cfg=cfg, device=dev),
            loss=functools.partial(xlstm.lm_loss, cfg=cfg, group=group),
            prefill=functools.partial(xlstm.lm_prefill, cfg=cfg),
            decode_step=functools.partial(xlstm.lm_decode_step, cfg=cfg),
            init_cache=functools.partial(xlstm.init_cache, cfg, device=dev),
            mesh=mesh,
        )
    if cfg.family == "audio":
        return Model(
            cfg=cfg,
            device=dev,
            init_params=functools.partial(whisper.init_params, cfg=cfg, device=dev),
            loss=functools.partial(whisper.lm_loss, cfg=cfg, group=group),
            prefill=functools.partial(whisper.lm_prefill, cfg=cfg),
            decode_step=functools.partial(whisper.lm_decode_step, cfg=cfg),
            init_cache=functools.partial(whisper.init_cache, cfg, device=dev),
            mesh=mesh,
        )
    raise ValueError(f"unknown family {cfg.family!r}")


def _bound(mesh, fn):
    """fn run under the mesh's axis rules (sharding/axes.py), kept to the
    "model" axis: the rank's activations are its share of the batch, cut
    before the model runs, so no constraint names a data axis."""
    rules = {name: tuple(a for a in axes if a == "model")
             for name, axes in rules_for(mesh).items()}

    @functools.wraps(fn)
    def run(*args, **kw):
        with axis_rules(mesh, rules):
            return fn(*args, **kw)
    return run


def _cuts_data(cfg: ModelConfig, mesh) -> bool:
    """Whether the guarded param specs of `cfg` put a data axis of size > 1
    on a leaf: FSDP (cfg.fsdp) or the MoE experts (EP), dense, MoE and VLM
    families only (no other family's rules name them)."""
    if dp_degree(mesh) == 1 or cfg.family not in ("dense", "moe", "vlm"):
        return False
    return any(c.data for c in model_dims(_whole(cfg), cfg, mesh, rules_for(mesh)).values())


_MODULES = {"dense": dense, "moe": dense, "vlm": dense, "hybrid": hybrid, "ssm": xlstm,
            "audio": whisper}


def _whole(cfg: ModelConfig):
    return _MODULES[cfg.family].init_params(torch.Generator(), cfg, device="meta")


def _sharded_model(cfg: ModelConfig, dev, window, n_groups: int, mesh) -> Model:
    """The model of which this rank holds the reference's blocks on `mesh`:
    tensor-parallel over "model" (every family), FSDP and EP over the data
    axes (the dense, MoE and VLM families)."""
    group = tp_group(mesh)
    tp = TensorParallel.plan(cfg, group) if tp_degree(mesh) > 1 else None
    whole, rules = _whole(cfg), rules_for(mesh)
    dp = DataParallel.plan(cfg, whole, mesh, rules)
    split = Split(model_dims(whole, cfg, mesh, rules), model_shardings(whole, cfg, mesh, rules))
    mod = _MODULES[cfg.family]
    if mod is dense:
        kw = dict(cfg=cfg, n_groups=n_groups, tp=tp, dp=dp)
        pre_kw, cache_kw = dict(kw, window=window), {}
    else:
        kw = dict(cfg=cfg, tp=tp)
        pre_kw = dict(kw, window=window) if mod is hybrid else kw
        cache_kw = dict(window=window) if mod is hybrid else {}
    return Model(
        cfg=cfg,
        device=dev,
        init_params=functools.partial(mod.init_params, cfg=cfg, device=dev, mesh=mesh,
                                      rank=dist.get_rank()),
        loss=_bound(mesh, functools.partial(mod.lm_loss, group=dp_group(mesh), **kw)),
        prefill=_bound(mesh, functools.partial(mod.lm_prefill, **pre_kw)),
        decode_step=_bound(mesh, functools.partial(mod.lm_decode_step, **kw)),
        init_cache=functools.partial(mod.init_cache, cfg, device=dev, tp=tp, **cache_kw),
        mesh=mesh,
        tp=tp,
        split=split,
        dp=dp,
    )


# ----------------------------------------------------------------------------
# Input specs (dry-run stand-ins)
# ----------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, B: int) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "audio":
        out["enc_embeds"] = _spec((B, ENC_LEN, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        out["patch_embeds"] = _spec((B, cfg.vlm.n_patches, cfg.d_model), torch.bfloat16)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta tensors of every input of the cell, with the reference's shapes
    and dtypes: int32 tokens, targets and positions, bf16 frontend
    embeddings."""
    i32 = torch.int32
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {"tokens": _spec((B, T), i32), "targets": _spec((B, T), i32)}
        specs.update(_frontend_specs(cfg, B))
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _spec((B, T), i32)}
        specs.update(_frontend_specs(cfg, B))
        return specs
    if shape.kind == "decode":
        return {"tokens": _spec((B, 1), i32), "positions": _spec((B,), i32)}
    raise ValueError(shape.kind)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, window: Optional[int] = None,
                batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The decode cache of this cell as meta tensors: the model's own
    init_cache on the meta device (zamba2 keeps `window` rows of k/v, the
    xLSTM its O(1) recurrent state). `batch` overrides the shape's global
    batch (a rank's share)."""
    model = build_model(cfg, device="meta", window=window)
    B = shape.global_batch if batch is None else batch
    if cfg.family == "ssm":
        return model.init_cache(B)
    return model.init_cache(B, shape.seq_len)


def shape_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """Long-context cells use the arch's sliding window (if any)."""
    if shape.name == "long_500k":
        return cfg.long_context_window
    return None


def make_batch(cfg: ModelConfig, shape: ShapeConfig, *, device="cuda",
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """A concrete random batch matching input_specs, drawn from `generator`
    (default: seed 0) on `device`: tokens and targets uniform over the
    vocabulary, positions zero, frontend embeddings standard normal in
    bf16. A meta batch takes a CPU generator (meta has none of its own)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(0)
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            if name == "positions":
                out[name] = torch.zeros(s.shape, dtype=torch.int32, device=dev)
            else:
                out[name] = torch.randint(0, cfg.vocab_size, s.shape, generator=generator,
                                          dtype=torch.int32, device=dev)
        else:
            out[name] = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                                    device=dev).to(s.dtype)
    return out
