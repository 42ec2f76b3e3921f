"""Uniform model interface of the port (the dense, MoE and hybrid families).

build_model(cfg, device=...) returns a Model whose members close over the
config and the device:
  init_params(generator)                -> params
  loss(params, batch)                   -> (scalar, metrics)     [train]
  prefill(params, batch)                -> (logits, cache)
  decode_step(params, cache, batch)     -> (logits, cache updated in place)
  init_cache(batch_size, max_len)       -> cache
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import dense, hybrid


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


def build_model(cfg: ModelConfig, *, device="cuda",
                window: Optional[int] = None) -> Model:
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe"):
        return Model(
            cfg=cfg,
            device=dev,
            init_params=functools.partial(dense.init_params, cfg=cfg, device=dev),
            loss=functools.partial(dense.lm_loss, cfg=cfg),
            prefill=functools.partial(dense.lm_prefill, cfg=cfg, window=window),
            decode_step=functools.partial(dense.lm_decode_step, cfg=cfg),
            init_cache=functools.partial(dense.init_cache, cfg, device=dev),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            device=dev,
            init_params=functools.partial(hybrid.init_params, cfg=cfg, device=dev),
            loss=functools.partial(hybrid.lm_loss, cfg=cfg),
            prefill=functools.partial(hybrid.lm_prefill, cfg=cfg, window=window),
            decode_step=functools.partial(hybrid.lm_decode_step, cfg=cfg),
            init_cache=functools.partial(hybrid.init_cache, cfg, window=window,
                                         device=dev),
        )
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported to PyTorch yet; see ROADMAP.md, Queue 1")
