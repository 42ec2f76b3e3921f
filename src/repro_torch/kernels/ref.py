"""Plain PyTorch versions of the kernels (unblocked, fp32 math).

`attention_ref` is the twin of the JAX package's `kernels/ref.py::
attention_ref` (same layout, same masks, causal alignment of the sequence
ends), `ssd_chunk_ref` of its sequential SSD oracle and `mlstm_ref` of its
sequential mLSTM oracle. `flash_attention_ref`,
`decode_attention_ref`, `moe_gmm_ref` (with `moe_gmm_dx_ref` and
`moe_gmm_dw_ref`, its two backward products) and `ssd_scan_ref` compute
exactly what the CUDA kernels compute, with their signatures, so that `ops.py` can
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
               kv_scale=None, v_scale=None, return_lse=False):
    """Unblocked attention with query row i at key position off + i; with
    `return_lse` also each row's fp32 log-sum-exp of its masked scaled
    scores, (B,Hq,Tq)."""
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
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, return_lse: bool = False):
    """What `flash_attention.cu` computes: q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D),
    query row i at key position i (the starts lined up, as in the Pallas
    kernel; the same as `attention_ref` when Tq == Tk). `return_lse` adds
    the fp32 (B,Hq,Tq) row log-sum-exp, as the kernel writes it."""
    return _attention(q, k, v, 0, causal=causal, window=window, return_lse=return_lse)


def decode_attention_ref(q, k, v, valid_len, k_scale=None, v_scale=None):
    """What `decode_attention.cu` computes: one query token per sequence.

    q (B,Hq,D); k/v (B,Hc,S,D) in bf16/fp32, or int8 with fp32 scales
    (B,Hc,S,1); valid_len (B,) -- keys at or past it are masked."""
    out = attention_ref(q[:, :, None], k, v, causal=False,
                        valid_len=valid_len, kv_scale=k_scale, v_scale=v_scale)
    return out[:, :, 0]


def moe_gmm_ref(x, w):
    """What `moe_gmm.cu` computes: x (E, C, d) @ w (E, d, f) -> (E, C, f),
    summed in fp32 and cast to x's dtype (the JAX `moe_gmm_ref`)."""
    return torch.einsum("ecd,edf->ecf", x.to(F32), w.to(F32)).to(x.dtype)


def moe_gmm_dx_ref(dy, w):
    """What `moe_gmm.cu`'s dx computes: dy (E, C, f) @ w (E, d, f)^T -> (E,
    C, d), summed in fp32 and cast to dy's dtype (the input gradient that
    autodiff of the JAX model's einsum gives)."""
    return torch.einsum("ecf,edf->ecd", dy.to(F32), w.to(F32)).to(dy.dtype)


def moe_gmm_dw_ref(x, dy):
    """What `moe_gmm.cu`'s dw computes: x (E, C, d)^T @ dy (E, C, f) -> (E,
    d, f), summed in fp32 over C and cast to x's dtype (the weight
    gradient)."""
    return torch.einsum("ecd,ecf->edf", x.to(F32), dy.to(F32)).to(x.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """What `ssm_scan.cu` computes, in the Pallas kernel's layout and with its
    clips: x (B,H,T,P), dt (B,H,T), A (H,), Bm/Cm (B,G,T,N) -> (y (B,H,T,P)
    in x's dtype, final state (B,H,P,N) fp32). Per chunk of Q steps, with
    la the in-chunk cumsum of dt*A: the intra-chunk term
    (C_t.B_s) exp(clip(la_t - la_s, -60, 0)) dt_s for s <= t applied to x,
    the inter-chunk term C_t.S exp(la_t) (unclipped), and the state update
    S <- exp(la_end) S + x^T (B exp(clip(la_end - la, -60, 0)) dt). No D
    skip: the model adds it. Sums run in fp32, or in fp64 when x is fp64
    (the card tests' yardstick of the kernels' precision)."""
    Bsz, H, T, P = x.shape
    G = Bm.shape[1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {Q}")
    rep = H // G
    ct = torch.promote_types(x.dtype, F32)
    xf, dtf = x.to(ct), dt.to(ct)
    a = A.to(ct)[None, :, None]
    Bh = torch.repeat_interleave(Bm.to(ct), rep, dim=1)
    Ch = torch.repeat_interleave(Cm.to(ct), rep, dim=1)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    S = torch.zeros((Bsz, H, P, Bm.shape[3]), dtype=ct, device=x.device)
    ys = []
    for c0 in range(0, T, Q):
        xc, dtc = xf[:, :, c0:c0 + Q], dtf[:, :, c0:c0 + Q]
        Bc, Cc = Bh[:, :, c0:c0 + Q], Ch[:, :, c0:c0 + Q]
        la = torch.cumsum(dtc * a, dim=-1)                       # (B,H,Q)
        la_end = la[..., -1:]
        decay = torch.exp(torch.clamp(la[..., :, None] - la[..., None, :], -60.0, 0.0))
        w = torch.where(tri, (Cc @ Bc.transpose(-1, -2)) * decay, 0.0) * dtc[..., None, :]
        y = w @ xc + (Cc @ S.transpose(-1, -2)) * torch.exp(la)[..., None]
        w_state = torch.exp(torch.clamp(la_end - la, -60.0, 0.0)) * dtc
        S = torch.exp(la_end)[..., None] * S + xc.transpose(-1, -2) @ (Bc * w_state[..., None])
        ys.append(y)
    return torch.cat(ys, dim=2).to(x.dtype), S


def ssd_chunk_ref(x, dt, A, Bm, Cm):
    """The sequential SSD recurrence (ground truth, the JAX `ssd_chunk_ref`):
    x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,G,N) -> y (B,T,H,P) fp32."""
    Bsz, T, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = torch.repeat_interleave(Bm.to(F32), rep, dim=2)
    Ch = torch.repeat_interleave(Cm.to(F32), rep, dim=2)
    xf, dtf, a = x.to(F32), dt.to(F32), A.to(F32)
    S = torch.zeros((Bsz, H, P, Bm.shape[3]), dtype=F32, device=x.device)
    ys = []
    for t in range(T):
        S = torch.exp(dtf[:, t] * a)[:, :, None, None] * S + \
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], S))
    return torch.stack(ys, dim=1)


def mlstm_ref(q, k, v, ig, lf):
    """The sequential stabilized mLSTM recurrence (ground truth of
    `models/xlstm.py::_mlstm_chunked`, the JAX `mlstm_ref`; no kernel has
    it as its plain version: the reference's mLSTM is jnp, not Pallas).
    q/k/v (B,T,H,Dh); ig/lf (B,T,H) (input-gate preact, log-sigmoid forget)
    -> h (B,T,H,Dh) fp32."""
    B, T, H, Dh = q.shape
    scale = Dh ** -0.5
    q, k, v, ig, lf = (a.to(F32) for a in (q, k, v, ig, lf))
    C = torch.zeros((B, H, Dh, Dh), dtype=F32, device=q.device)
    n = torch.zeros((B, H, Dh), dtype=F32, device=q.device)
    m = torch.full((B, H), -30.0, dtype=F32, device=q.device)
    hs = []
    for t in range(T):
        qt, kt, vt, it, ft = q[:, t], k[:, t], v[:, t], ig[:, t], lf[:, t]
        m_new = torch.maximum(ft + m, it)
        fp = torch.exp(ft + m - m_new)
        ip = torch.exp(it - m_new)
        C = fp[..., None, None] * C + ip[..., None, None] * torch.einsum("bhd,bhe->bhde", kt, vt)
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhd,bhde->bhe", qt * scale, C)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qt * scale, n)),
                            torch.exp(-m_new))
        m = m_new
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1)
