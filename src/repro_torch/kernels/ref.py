"""Plain PyTorch versions of the attention kernels (unblocked, fp32 math).

`attention_ref` is the twin of the JAX package's `kernels/ref.py::
attention_ref` (same layout, same masks, causal alignment of the sequence
ends). `flash_attention_ref` and `decode_attention_ref` compute exactly what
the two CUDA kernels compute, with their signatures, so that `ops.py` can
hand a CPU tensor to them and `chip_smoke.py` can hold each kernel against
them on the card. Every argument may be a strided view (the model passes
its (B, T, H, D) tensors transposed to (B, H, T, D) without a copy).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

F32 = torch.float32


def attention_ref(q, k, v, *, causal=True, window: Optional[int] = None,
                  valid_len=None, kv_scale=None, v_scale=None):
    """q (B,Hq,Tq,D); k/v (B,Hkv,Tk,D) [+ int8 scales (B,Hkv,Tk,1)].

    Lines up the ends of the two axes (query row i at key Tk - Tq + i), as
    the JAX oracle does."""
    return _attention(q, k, v, k.shape[2] - q.shape[2], causal=causal,
                      window=window, valid_len=valid_len, kv_scale=kv_scale,
                      v_scale=v_scale)


def _attention(q, k, v, off: int, *, causal, window, valid_len=None,
               kv_scale=None, v_scale=None):
    """Unblocked attention with query row i at key position off + i."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    R = Hq // Hkv
    kf = k.to(F32)
    vf = v.to(F32)
    if kv_scale is not None:
        kf = kf * kv_scale
    if v_scale is not None:
        vf = vf * v_scale
    kf = torch.repeat_interleave(kf, R, dim=1)
    vf = torch.repeat_interleave(vf, R, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), kf) / math.sqrt(D)
    qpos = torch.arange(Tq, device=q.device)[:, None] + off
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    mask = mask.expand(B, 1, Tq, Tk)
    if valid_len is not None:
        mask = mask & (kpos[None, None] < valid_len.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None):
    """What `flash_attention.cu` computes: q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D),
    query row i at key position i (the starts lined up, as in the Pallas
    kernel; the same as `attention_ref` when Tq == Tk)."""
    return _attention(q, k, v, 0, causal=causal, window=window)


def decode_attention_ref(q, k, v, valid_len, k_scale=None, v_scale=None):
    """What `decode_attention.cu` computes: one query token per sequence.

    q (B,Hq,D); k/v (B,Hc,S,D) in bf16/fp32, or int8 with fp32 scales
    (B,Hc,S,1); valid_len (B,) -- keys at or past it are masked."""
    out = attention_ref(q[:, :, None], k, v, causal=False,
                        valid_len=valid_len, kv_scale=k_scale, v_scale=v_scale)
    return out[:, :, 0]
