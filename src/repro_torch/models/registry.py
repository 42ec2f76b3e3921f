"""Uniform model interface of the port, over every family of the JAX package.

build_model(cfg, device=...) returns a Model whose members close over the
config and the device (and the MoE dispatch groups `n_groups`, and a
data-parallel `mesh`):
  init_params(generator)                -> params
  loss(params, batch)                   -> (scalar, metrics)     [train]
  prefill(params, batch)                -> (logits, cache)
  decode_step(params, cache, batch)     -> (logits, cache updated in place)
  init_cache(batch_size, max_len)       -> cache

`n_groups` splits each MoE layer's tokens into that many contiguous dispatch
groups (the reference sets it to the data-parallel degree). Under a `mesh`
(`launch/mesh.py`) each rank's model runs its share of the global batch:
build it with the rank's share of the groups (usually 1), and its loss
takes the MoE aux loss's means and a masked token mean over the mesh's
data-parallel group, so that the mean of the ranks' losses is the global
loss (`train/steps.py` under the same mesh).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import dp_group
from repro_torch.models import dense, hybrid, whisper, xlstm


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


def build_model(cfg: ModelConfig, *, device="cuda", window: Optional[int] = None,
                n_groups: int = 1, mesh=None) -> Model:
    dev = resolve_device(device)
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
