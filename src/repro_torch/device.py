"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. The default is the card; the CPU
    is used only when asked for by name. Without a card, a CUDA request
    raises instead of quietly running on the CPU. "meta" gives tensors with
    shapes and no data (for sharding plans of configs too large to hold)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return dev
    if dev.type in ("cpu", "meta"):
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda', 'cpu' or 'meta'")
