"""Architecture config registry of the port: every architecture of the JAX
package, under the same ids and in the same order."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (EncDecConfig, HybridConfig, ModelConfig, MoEConfig,
                                      SSMConfig, VLMConfig, XLSTMConfig, active_param_count,
                                      param_count)
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable

_MODULES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "arctic-480b": "arctic_480b",
    "zamba2-2.7b": "zamba2_2p7b",
    "whisper-tiny": "whisper_tiny",
    "xlstm-350m": "xlstm_350m",
    "granite-8b": "granite_8b",
    "qwen1.5-32b": "qwen1_5_32b",
    "llama3-8b": "llama3_8b",
    "stablelm-12b": "stablelm_12b",
    "internvl2-76b": "internvl2_76b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCH_IDS", "EncDecConfig", "HybridConfig", "ModelConfig", "MoEConfig",
           "SHAPES", "SSMConfig", "ShapeConfig", "VLMConfig", "XLSTMConfig",
           "active_param_count", "applicable", "get_config", "param_count"]
