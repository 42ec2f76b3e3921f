"""Assigned input shapes, the port's copy of the JAX package's
`configs/shapes.py`. Every architecture is exercised against each of these
cells, unless `applicable` skips it."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def applicable(arch_family: str, sub_quadratic: bool, shape_name: str) -> bool:
    """long_500k needs sub-quadratic attention; all our archs have decoders."""
    if shape_name == "long_500k":
        return sub_quadratic
    return True
