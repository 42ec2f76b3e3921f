"""Shared model building blocks, PyTorch.

Counterparts of the JAX package's `models/layers.py`, holding to its
numerics order (where a cast to the working dtype happens relative to each
multiply) so that the two agree to rounding at fp32 and to bf16 rounding at
bf16. Weights keep the JAX orientation: a projection is `x @ w` with `w` of
shape (d_in, d_out). Attention goes through `kernels/ops.py`: the CUDA
kernel on the card, the plain version on the CPU; when autograd is
recording, through `flash_vjp.py`, whose backward is the flash backward.
Under tensor parallelism (`tp`, `tensor_parallel.py`) the projections,
attention and embeddings run on the rank's blocks; the `constrain` calls
at the reference's sites check each activation's layout under a binding.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import distributed as D
from repro_torch.kernels import ops
from repro_torch.models import flash_vjp
from repro_torch.sharding.axes import constrain

F32 = torch.float32


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w   # cast back before * w


def rms_norm_split(x: torch.Tensor, w: torch.Tensor, width: int, tp,
                   eps: float = 1e-5) -> torch.Tensor:
    """`rms_norm` over a last dim of `width` split over the "model" ranks:
    x and w are the rank's part of it. The fp32 mean of squares is each
    rank's sum, summed over the ranks (`shared_sum`, whose backward sums
    too: each rank's normed part reads the statistic), over `width`."""
    dt = x.dtype
    xf = x.to(F32)
    var = tp.shared_sum(torch.sum(torch.square(xf), dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


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


def qkv(p, x, positions, cfg, tp=None):
    """Projections, bias and rope of this call's tokens: q (B,T,Hq,hd),
    k/v (B,T,Hkv,hd). Under tensor parallelism (`tp`, a
    `tensor_parallel.TensorParallel`) the heads are the rank's: the head
    counts come from its weights' widths, gathered where its columns split
    heads."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    xq = xkv = x
    if tp is not None:   # a split product's input enters it (its gradient is partial)
        split_q, split_kv = tp.q_split or tp.gather_q, tp.kv_split or tp.gather_kv
        xs = tp.enter(x) if split_q or split_kv else x
        xq, xkv = (xs if split_q else x), (xs if split_kv else x)
    q, k, v = xq @ p["wq"], xkv @ p["wk"], xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if tp is not None and tp.kv_read_partially:
        k, v = tp.enter(k), tp.enter(v)
    if tp is not None and tp.gather_q:
        q = tp.all_gather(q)
    if tp is not None and tp.gather_kv:
        k, v = tp.all_gather(k), tp.all_gather(v)
    q = q.reshape(B, T, -1, hd)
    k = k.reshape(B, T, -1, hd)
    v = v.reshape(B, T, -1, hd)
    q = constrain(q, "batch", None, "model", None, full=(B, T, cfg.eff_q_heads, hd))
    k = constrain(k, "batch", None, "model", None, full=(B, T, cfg.eff_kv_heads, hd))
    v = constrain(v, "batch", None, "model", None, full=(B, T, cfg.eff_kv_heads, hd))
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def project_q(p, x, cfg, tp=None):
    """The q heads (B,T,Hq,hd) of x, bias added, no rope (cross-attention's
    q): under `tp` the rank's heads, or every head gathered where its
    columns split heads (`qkv`'s q)."""
    B, T, _ = x.shape
    split = tp is not None and (tp.q_split or tp.gather_q)
    q = (tp.enter(x) if split else x) @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    if split and tp.gather_q:
        q = tp.all_gather(q)
    return q.reshape(B, T, -1, cfg.resolved_head_dim)


def project_kv(p, x, cfg, tp=None):
    """The k and v heads (B,T,Hkv,hd) of x, no rope (cross-attention's k/v
    of the encoder's output): under `tp` as `qkv` makes them. x must have
    entered already where the rank's k/v product is split
    (`tp.kv_split or tp.gather_kv`): whisper enters its encoder output once
    for every decoder layer."""
    B, T, _ = x.shape
    k, v = x @ p["wk"], x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if tp is not None and tp.kv_read_partially:
        k, v = tp.enter(k, v)
    if tp is not None and tp.gather_kv:
        k, v = tp.all_gather(k), tp.all_gather(v)
    hd = cfg.resolved_head_dim
    return k.reshape(B, T, -1, hd), v.reshape(B, T, -1, hd)


def attn_out(p, out, tp=None):
    """The output projection of the attention's heads out (B,T,Hq*hd): under
    `tp` the rank's rows of wo over its heads' columns, all-reduced where
    that is a partial sum."""
    if tp is None:
        return out @ p["wo"]
    if tp.out_cols is not None:
        out = out[..., tp.out_cols]
    y = tp.psum((out @ p["wo"], tp.attn_partial))
    return constrain(y, "batch", None, None)


def attention(p, x, positions, cfg, *, causal: bool = True,
              window: Optional[int] = None,
              cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, tp=None):
    """Self-attention over this call's tokens, or with `cross_kv` = (k, v)
    (B,Tk,Hkv,hd) cross-attention over those: q projected and not roped,
    non-causal, Tk free. Returns (out, (k, v)) with this call's k/v
    (B,T,Hkv,hd) for the cache, or (out, None) for cross-attention. Under
    autograd (training) it goes through the flash backward's Function, with
    the reference's blocks of 512; otherwise (serving) straight to the
    kernel, which writes no lse. Under tensor parallelism (`tp`) over the
    rank's heads: its q heads read the kv heads of their groups, and k/v
    are the rank's (cross_kv: `project_kv`'s, under the same plan)."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    if cross_kv is None:
        q, k, v = qkv(p, x, positions, cfg, tp)
        new_kv = (k, v)
    else:
        q = project_q(p, x, cfg, tp)
        (k, v), new_kv = cross_kv, None
        causal, window = False, None
    if tp is not None and tp.kv_heads is not None:
        k, v = k[:, :, tp.kv_heads], v[:, :, tp.kv_heads]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = flash_vjp.flash_attention_vjp(q, k, v, causal=causal, window=window)
    else:
        # (B,T,H,hd) read as (B,H,T,hd) through strides: no copy
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
    return attn_out(p, out.reshape(B, T, q.shape[2] * hd), tp), new_kv


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


def embed(p, tokens, tp=None):
    """The token embeddings; under `tp` of the rank's vocab rows, the
    others' tokens zero, summed over the ranks."""
    if tp is None or tp.vocab_rows is None:
        return torch.nn.functional.embedding(tokens, p["tok"])
    ids = tokens.long() - tp.vocab_rows.start
    mine = (ids >= 0) & (ids < p["tok"].shape[0])
    rows = torch.nn.functional.embedding(torch.where(mine, ids, 0), p["tok"])
    x = tp.all_reduce(torch.where(mine[..., None], rows, 0))
    return constrain(x, "batch", None, None)


def unembed(p, x, n_valid: Optional[int] = None, tp=None, gather: bool = True):
    """Logits of x over the (padded) vocabulary, the padded ones -1e9; under
    `tp` the rank's rows' logits, masked by global vocab id, gathered over
    the ranks, or with `gather=False` the rank's own (the vocab-parallel
    loss's input, `softmax_xent(..., tp=)`)."""
    w = p.get("out", p["tok"])
    split = tp is not None and tp.vocab_rows is not None
    logits = (tp.enter(x) if split else x) @ w.T
    first = tp.vocab_rows.start if split else 0
    if n_valid is not None and n_valid < first + w.shape[0]:
        vocab_ids = first + torch.arange(w.shape[0], device=logits.device)
        logits = logits.masked_fill(vocab_ids >= n_valid, -1e9)
    return tp.all_gather(logits) if split and gather else logits


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor, mask=None,
                 group=None, tp=None) -> torch.Tensor:
    """Token-mean cross entropy: the fp32 logsumexp minus the gold logit,
    averaged over the tokens, or over the mask's weight (at least 1).

    Under a data-parallel `group` (never the "model" group) the mean over
    the ranks of what this returns is the global mean: with a mask the
    divisor is the group's summed weight (and the sum is scaled by the
    group's size); without one the rank's own mean, which is the global
    mean's share when every rank holds as many tokens (the train step splits
    the batch so).

    Vocab-parallel (`tp` whose ranks split the vocabulary): `logits` are the
    rank's (B, T, V/n) columns (`unembed(..., gather=False)`). The logsumexp
    comes from the ranks' max (no gradient: the logsumexp does not depend
    on the shift) and the sum of the ranks' exponentials, the gold logit
    from the rank whose columns hold it, the two sums in one all-reduce
    whose backward is the identity: the block's gradient is the softmax
    minus the one-hot on the rank's columns, with no collective."""
    logits = logits.to(F32)
    if tp is None or tp.vocab_rows is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    else:
        m = tp.all_reduce_max(logits.detach().amax(dim=-1))
        ids = targets.long() - tp.vocab_rows.start
        mine = (ids >= 0) & (ids < logits.shape[-1])
        gold = torch.gather(logits, -1, torch.where(mine, ids, 0)[..., None])[..., 0]
        sums = torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1),
                            torch.where(mine, gold, 0.0)])
        total, gold = tp.all_reduce(sums).unbind(0)
        lse = m + torch.log(total)
    nll = lse - gold
    if mask is not None:
        weight = torch.sum(mask).detach()
        if group is None:
            return torch.sum(nll * mask) / torch.clamp_min(weight, 1.0)
        n = torch.distributed.get_world_size(group)
        total = D.all_reduce_(weight.to(F32).clone(), group=group)
        return n * torch.sum(nll * mask) / torch.clamp_min(total, 1.0)
    return torch.mean(nll)
