"""Flash attention with the flash backward, as a `torch.autograd.Function`.

The port of the JAX package's `models/flash_vjp.py` (a `jax.custom_vjp`).
The forward is `ops.flash_attention(..., return_lse=True)`: the CUDA kernel
on the card (`flash_wgmma` for the model's bf16 views), the plain version on
the CPU. It saves only (q, k, v, out, lse), the fp32 row log-sum-exp. The
backward is `_bwd` of the reference in plain PyTorch, on the same tiles:
delta = rowsum(dO * O); per (q block, kv block) tile of the causal/window
footprint, p recomputed from lse, dp = dO V^T, ds = p (dp - delta) scale;
GQA folded (kv never repeated); dq, dk, dv summed in fp32 and returned in
the inputs' dtypes. The reference backward is jnp, not Pallas, so this is
the port's backward and not a fallback; a Hopper backward kernel is queued
(ROADMAP.md, Queue 2).

Layout as the reference's: q (B,T,Hq,D), k/v (B,T,Hkv,D); query row i at
key position i.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops

F32 = torch.float32


def _footprint(i, nk, block_q, block_k, causal, window):
    """The reference's `_footprint` with q_offset 0: (q_start, lo, hi), the
    kv blocks [lo, hi) that q block i attends to."""
    q_start = i * block_q
    q_end = q_start + block_q - 1
    hi = nk if not causal else min(nk, (q_end // block_k) + 1)
    lo = 0
    if window is not None:
        lo = max(0, (q_start - window + 1) // block_k)
    return q_start, lo, hi


def _mask_for(q_start, j, block_q, block_k, causal, window, device):
    qpos = q_start + torch.arange(block_q, device=device)
    kpos = j * block_k + torch.arange(block_k, device=device)
    mask = torch.ones((block_q, block_k), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def flash_bwd(q, k, v, out, lse, do, causal, window, block_q, block_k):
    """dq, dk, dv of attention, from its residuals and the output's
    gradient `do` (B,T,Hq,D); lse (B,Hq,T) fp32."""
    B, Tq, Hq, Dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    R = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    nq, nk = Tq // block_q, Tk // block_k

    qr = q.reshape(B, nq, block_q, Hkv, R, Dh)
    kr = k.reshape(B, nk, block_k, Hkv, Dh)
    vr = v.reshape(B, nk, block_k, Hkv, Dh)
    do_r = do.reshape(B, nq, block_q, Hkv, R, Dh)
    o_r = out.reshape(B, nq, block_q, Hkv, R, Dh)
    # lse (B,Hq,T) -> (B, nq, Hkv, R, bq), the reference's residual layout
    lse_r = lse.reshape(B, Hkv, R, nq, block_q).permute(0, 3, 1, 2, 4)
    delta = torch.einsum("bnqhrd,bnqhrd->bnhrq", do_r.to(F32), o_r.to(F32))

    dq = torch.zeros((B, nq, block_q, Hkv, R, Dh), dtype=F32, device=q.device)
    dk = torch.zeros((B, nk, block_k, Hkv, Dh), dtype=F32, device=q.device)
    dv = torch.zeros((B, nk, block_k, Hkv, Dh), dtype=F32, device=q.device)
    for i in range(nq):
        q_blk = qr[:, i].to(F32)
        do_blk = do_r[:, i].to(F32)
        lse_i = lse_r[:, i][..., None]
        delta_i = delta[:, i][..., None]
        q_start, lo, hi = _footprint(i, nk, block_q, block_k, causal, window)
        for j in range(lo, hi):
            kb = kr[:, j].to(F32)
            vb = vr[:, j].to(F32)
            s = torch.einsum("bqhrd,bkhd->bhrqk", q_blk, kb) * scale
            mask = _mask_for(q_start, j, block_q, block_k, causal, window, q.device)
            # where, not the reference's multiply by the mask: a masked
            # score may lie far above lse, and exp(inf) * 0 is nan
            p = torch.where(mask, torch.exp(s - lse_i), 0.0)
            dp = torch.einsum("bqhrd,bkhd->bhrqk", do_blk, vb)
            ds = p * (dp - delta_i) * scale
            dq[:, i] += torch.einsum("bhrqk,bkhd->bqhrd", ds, kb)
            dv[:, j] += torch.einsum("bhrqk,bqhrd->bkhd", p, do_blk)
            dk[:, j] += torch.einsum("bhrqk,bqhrd->bkhd", ds, q_blk)
    return (dq.reshape(B, Tq, Hq, Dh).to(q.dtype), dk.reshape(B, Tk, Hkv, Dh).to(k.dtype),
            dv.reshape(B, Tk, Hkv, Dh).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_k):
        out, lse = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=causal, window=window,
                                       return_lse=True)
        out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_vjp(q, k, v, causal: bool = True, window: Optional[int] = None,
                        block_q: int = 512, block_k: int = 512):
    """Attention of q (B,T,Hq,D) over k/v (B,T,Hkv,D) -> (B,T,Hq,D) in q's
    dtype, differentiable through the flash backward. Blocks are cut to the
    sequence (min(block, T), as the reference's caller does), and each
    length must be a multiple of its block."""
    block_q, block_k = min(block_q, q.shape[1]), min(block_k, k.shape[1])
    if q.shape[1] % block_q or k.shape[1] % block_k:
        raise ValueError(f"lengths {q.shape[1]}, {k.shape[1]} are not multiples of the "
                         f"blocks {block_q}, {block_k}")
    return FlashAttention.apply(q, k, v, causal, window, block_q, block_k)
