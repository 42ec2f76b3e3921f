"""Architecture config registry of the port: the dense, MoE and hybrid
architectures that its serving paths run. The other architectures of the
JAX package wait for later slices of the port (see ROADMAP.md, Queue 1)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import HybridConfig, ModelConfig, MoEConfig, SSMConfig

_MODULES = {
    "llama3-8b": "llama3_8b",
    "granite-8b": "granite_8b",
    "qwen1.5-32b": "qwen1_5_32b",
    "stablelm-12b": "stablelm_12b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "arctic-480b": "arctic_480b",
    "zamba2-2.7b": "zamba2_2p7b",
}

# architectures of the JAX package whose families are not ported yet
_NOT_PORTED = ("whisper-tiny", "xlstm-350m", "internvl2-76b")

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported to PyTorch yet; see ROADMAP.md, Queue 1")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCH_IDS", "HybridConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "get_config"]
