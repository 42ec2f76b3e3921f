"""Model configuration for the PyTorch port.

The port's own copy of the JAX package's `configs/base.py`: `ModelConfig`
cut to the fields and derived properties that the port's models read, and
the family configs `MoEConfig`, `SSMConfig`, `XLSTMConfig`, `HybridConfig`,
`EncDecConfig` and `VLMConfig`, with the same names and defaults, so a
config built here describes the model that the JAX reference builds from
the same-named config there; and the analytic counts `param_count` and
`active_param_count` that the roofline's `model_flops` reads. `fsdp` is
read by the sharding rules (`sharding/rules.py`); `long_context_window`,
`sub_quadratic` and `optimizer` by the dry-run (`launch/dryrun.py`), as
the JAX package's dry-run reads them. Shapes live in `shapes.py`.
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
class XLSTMConfig:
    """xLSTM block stack: mLSTM with a periodic sLSTM block."""
    slstm_every: int = 8        # 7:1 mLSTM:sLSTM
    mlstm_expand: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv_dim: int = 4


@dataclass(frozen=True)
class HybridConfig:
    """zamba2-style hybrid: mamba2 backbone + shared attention block."""
    attn_every: int = 6         # one (shared) attention block per 6 mamba blocks
    shared_attention: bool = True


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder split (conv frontend is a stub)."""
    n_enc_layers: int = 4
    enc_seq_ratio: float = 1.0  # encoder frames per decoder token in train shapes


@dataclass(frozen=True)
class VLMConfig:
    """InternVL-style: precomputed ViT patch embeddings prepended to the LM."""
    n_patches: int = 256
    patch_dim: int = 0          # 0 => already projected to d_model (stub frontend)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # attention window used in long-context mode (None => full causal).
    long_context_window: Optional[int] = None
    # whether the arch is sub-quadratic in sequence length (SSM / hybrid /
    # windowed attention) and therefore runs the long_500k shape.
    sub_quadratic: bool = False
    param_dtype: str = "bfloat16"
    # optimizer choice at production scale ("adamw" | "adafactor").
    optimizer: str = "adamw"
    # shard parameters over the data axis too (FSDP / ZeRO-3 style weight
    # sharding) -- required for the largest models.
    fsdp: bool = False
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

    @property
    def n_rep(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (used for 6*N*D roofline math): the JAX
    package's formula, term for term."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.resolved_head_dim
    q = cfg.n_heads * hd
    kv = cfg.n_kv_heads * hd
    emb = v * d * (1 if cfg.tie_embeddings else 2)

    def attn_params() -> int:
        return d * q + 2 * d * kv + q * d

    def dense_ff(ff: int) -> int:
        return 3 * d * ff  # swiglu: w1, w3, w2

    per_layer = 0
    if cfg.family in ("dense", "vlm"):
        per_layer = attn_params() + dense_ff(f) + 2 * d
    elif cfg.family == "moe":
        m = cfg.moe
        per_layer = attn_params() + m.n_experts * dense_ff(f) + 2 * d
        per_layer += d * m.n_experts  # router
        if m.dense_residual_ff:
            per_layer += dense_ff(m.dense_residual_ff)
    elif cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        # mamba2 block: in_proj (x, z, B, C, dt) + out_proj + conv + norm
        nheads = d_in // s.head_dim
        mamba = d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads) + d_in * d + 2 * d
        # shared attention every k layers (counted once if shared)
        n_attn = cfg.n_layers // cfg.hybrid.attn_every
        extra = attn_params() + dense_ff(f) + 2 * d
        return emb + cfg.n_layers * mamba + (extra if cfg.hybrid.shared_attention
                                             else n_attn * extra)
    elif cfg.family == "ssm":
        x = cfg.xlstm
        d_in = int(x.mlstm_expand * d)
        # mLSTM: up-proj (2*d_in), out-proj, q/k/v within the up-projected space, norms
        mlstm = d * 2 * d_in + d_in * d + 3 * d_in * d_in + 2 * d
        slstm = d * 4 * d + int(x.slstm_proj_factor * d) * d * 2 + 2 * d
        n_s = cfg.n_layers // x.slstm_every
        return emb + (cfg.n_layers - n_s) * mlstm + n_s * slstm
    elif cfg.family == "audio":
        e = cfg.encdec
        enc_layer = attn_params() + dense_ff(f) + 2 * d
        dec_layer = 2 * attn_params() + dense_ff(f) + 3 * d  # self + cross
        return emb + e.n_enc_layers * enc_layer + cfg.n_layers * dec_layer
    return emb + cfg.n_layers * per_layer


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top_k experts count)."""
    if cfg.family != "moe":
        return param_count(cfg)
    d, f, m = cfg.d_model, cfg.d_ff, cfg.moe
    hd = cfg.resolved_head_dim
    q = cfg.n_heads * hd
    kv = cfg.n_kv_heads * hd
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    per_layer = (d * q + 2 * d * kv + q * d) + m.top_k * 3 * d * f + 2 * d + d * m.n_experts
    if m.dense_residual_ff:
        per_layer += 3 * d * m.dense_residual_ff
    return emb + cfg.n_layers * per_layer
