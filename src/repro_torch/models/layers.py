"""Shared model building blocks, PyTorch.

Counterparts of the JAX package's `models/layers.py`, holding to its
numerics order (where a cast to the working dtype happens relative to each
multiply) so that the two agree to rounding at fp32 and to bf16 rounding at
bf16. Weights keep the JAX orientation: a projection is `x @ w` with `w` of
shape (d_in, d_out). Attention goes through `kernels/ops.py`: the CUDA
kernel on the card, the plain version on the CPU; when autograd is
recording, through `flash_vjp.py`, whose backward is the flash backward.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import flash_vjp

F32 = torch.float32


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w   # cast back before * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, Dh), positions: (..., T). Halves split, not
    interleaved; frequencies in fp32."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[..., None, None] * freqs      # (..., T, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def normal(generator: torch.Generator, shape, std: float, dtype, device):
    """normal(0, std) drawn in fp32, then cast, as the JAX init does."""
    return (torch.randn(shape, generator=generator, dtype=F32, device=device)
            * std).to(dtype)


def swiglu(x, w1, w3, w2):
    h = x @ w1
    g = x @ w3
    h = torch.nn.functional.silu(h.to(F32)).to(h.dtype) * g
    return h @ w2


# ----------------------------------------------------------------------------
# Attention layer (GQA, rope, optional bias)
# ----------------------------------------------------------------------------

def _q_head_permutation(n_heads, n_kv_heads, hq_pad, hkv_pad):
    """Padded q-head index of each real q head, preserving the GQA q->kv
    group mapping: real head i (group g=i//R, slot s=i%R) lands at
    g*R_pad + s, so under the padded ratio R_pad it still reads kv group g."""
    r_real = n_heads // n_kv_heads
    r_pad = hq_pad // hkv_pad
    return [(i // r_real) * r_pad + (i % r_real) for i in range(n_heads)]


def init_attention(generator: torch.Generator, d_model, n_heads, n_kv_heads,
                   head_dim, qkv_bias, dtype, pad_q_to: int = 0,
                   pad_kv_to: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """Normal(0, d_model**-0.5) projections. Padded heads (pad_*_to above the
    real count) get zero weights placed within their GQA group, so padding
    is numerically exact."""
    hq, hkv = pad_q_to or n_heads, pad_kv_to or n_kv_heads
    std = d_model ** -0.5
    wq, wk, wv, wo = (normal(generator, shape, std, dtype, device) for shape in (
        (d_model, n_heads * head_dim), (d_model, n_kv_heads * head_dim),
        (d_model, n_kv_heads * head_dim), (n_heads * head_dim, d_model)))

    if hq > n_heads or hkv > n_kv_heads:
        def expand_cols(w_real, perm, tot_heads):
            w = w_real.new_zeros((w_real.shape[0], tot_heads * head_dim))
            for i, j in enumerate(perm):
                w[:, j * head_dim:(j + 1) * head_dim] = \
                    w_real[:, i * head_dim:(i + 1) * head_dim]
            return w

        qperm = _q_head_permutation(n_heads, n_kv_heads, hq, hkv)
        kvperm = list(range(n_kv_heads))
        wq = expand_cols(wq, qperm, hq)
        wk = expand_cols(wk, kvperm, hkv)
        wv = expand_cols(wv, kvperm, hkv)
        wo = expand_cols(wo.T, qperm, hq).T.contiguous()

    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if qkv_bias:
        p["bq"] = torch.zeros(hq * head_dim, dtype=dtype, device=device)
        p["bk"] = torch.zeros(hkv * head_dim, dtype=dtype, device=device)
        p["bv"] = torch.zeros(hkv * head_dim, dtype=dtype, device=device)
    return p


def qkv(p, x, positions, cfg):
    """Projections, bias and rope of this call's tokens: q (B,T,Hq,hd),
    k/v (B,T,Hkv,hd)."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.eff_q_heads, hd)
    k = k.reshape(B, T, cfg.eff_kv_heads, hd)
    v = v.reshape(B, T, cfg.eff_kv_heads, hd)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def attention(p, x, positions, cfg, *, causal: bool = True,
              window: Optional[int] = None):
    """Self-attention over this call's tokens. Returns (out, (k, v)) with
    k/v (B,T,Hkv,hd) for the cache. Under autograd (training) it goes
    through the flash backward's Function, with the reference's blocks of
    512; otherwise (serving) straight to the kernel, which writes no lse."""
    B, T, _ = x.shape
    q, k, v = qkv(p, x, positions, cfg)
    if torch.is_grad_enabled() and q.requires_grad:
        out = flash_vjp.flash_attention_vjp(q, k, v, causal=causal, window=window)
    else:
        # (B,T,H,hd) read as (B,H,T,hd) through strides: no copy
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
    out = out.reshape(B, T, cfg.eff_q_heads * cfg.resolved_head_dim)
    return out @ p["wo"], (k, v)


# ----------------------------------------------------------------------------
# Embedding
# ----------------------------------------------------------------------------

def init_embedding(generator, vocab, d_model, dtype, tie, padded_vocab=None,
                   device="cpu"):
    pv = padded_vocab or vocab
    p = {"tok": normal(generator, (pv, d_model), 0.02, dtype, device)}
    if not tie:
        p["out"] = normal(generator, (pv, d_model), 0.02, dtype, device)
    return p


def embed(p, tokens):
    return torch.nn.functional.embedding(tokens, p["tok"])


def unembed(p, x, n_valid: Optional[int] = None):
    w = p.get("out", p["tok"])
    logits = x @ w.T
    if n_valid is not None and n_valid < w.shape[0]:
        vocab_ids = torch.arange(w.shape[0], device=logits.device)
        logits = logits.masked_fill(vocab_ids >= n_valid, -1e9)
    return logits


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """Token-mean cross entropy: the fp32 logsumexp minus the gold logit,
    averaged over the tokens, or over the mask's weight (at least 1)."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
