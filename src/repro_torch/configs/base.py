"""Model configuration for the PyTorch port.

The port's own copy of the JAX package's `configs/base.py::ModelConfig`,
cut to the fields and derived properties that the dense serving path reads,
with the same names and defaults, so a config built here describes the
model that the JAX reference builds from the same-named config there. The
other families (MoE, SSM, xLSTM, hybrid, encoder-decoder, VLM) add their own
fields when their slices are ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense (the only family the port serves yet)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    # int8 KV cache (per (token, head) scales in fp32)
    kv_cache_dtype: str = "bfloat16"
    # the cache stores n_kv * kv_replication heads (each kv head repeated in
    # place), so a q head i reads cache head i // (eff_q_heads / cache_kv_heads)
    kv_replication: int = 1
    # padded heads get zero weights inside their GQA group (numerically exact)
    pad_heads_to: int = 0
    pad_kv_heads_to: int = 0

    @property
    def eff_q_heads(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def eff_kv_heads(self) -> int:
        return self.pad_kv_heads_to or self.n_kv_heads

    @property
    def cache_kv_heads(self) -> int:
        return self.eff_kv_heads * self.kv_replication

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256; padded logits are masked to
        -1e9 in unembed."""
        return -(-self.vocab_size // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
