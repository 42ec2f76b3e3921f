"""Model configuration for the PyTorch port.

The port's own copy of the JAX package's `configs/base.py`: `ModelConfig`
cut to the fields and derived properties that the serving paths of the
dense, MoE and hybrid families read, and the family configs `MoEConfig`,
`SSMConfig` and `HybridConfig`, with the same names and defaults, so a
config built here describes the model that the JAX reference builds from
the same-named config there. The other families (xLSTM, encoder-decoder,
VLM) add their own fields when their slices are ported; the long-context
fields (`long_context_window`, `sub_quadratic`) come with the long_500k
shape, and the fields only the JAX package's dry-run launcher reads
(`optimizer`, `fsdp`) with its counterpart.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Arctic keeps a small dense FFN residual alongside the MoE FFN.
    dense_residual_ff: int = 0
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style state-space block parameters."""
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64          # mamba2 heads: d_inner // head_dim
    chunk_size: int = 256
    conv_dim: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class HybridConfig:
    """zamba2-style hybrid: mamba2 backbone + shared attention block."""
    attn_every: int = 6         # one (shared) attention block per 6 mamba blocks
    shared_attention: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid (the families ported yet)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
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
