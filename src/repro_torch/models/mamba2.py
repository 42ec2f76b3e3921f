"""Mamba2 (SSD) blocks: the full-sequence forward (prefill and training)
and the one-token recurrent update (decode).

The port of the JAX package's `models/mamba2.py`. The full-sequence forward
runs the chunked SSD scan through `kernels/ops.py::ssd_scan` (the CUDA kernel
on the card, the plain version on the CPU) on the (B, H, T, P) view of the
model's (B, T, H, P) tensors, with no transpose copy. Under autograd it goes
through `SSDScan`, whose backward differentiates the model's own chunked
scan (`_ssd_chunked`), as the JAX package differentiates its jnp scan.

Numerics: the kernel returns y in the dtype of its x, while the model's
chunked scan keeps y in fp32 and adds the D skip in fp32 before one cast to
the working dtype. So `mamba_fwd` hands the kernel x, B and C in fp32, as the
model's `_ssd_chunked` casts them inside, and the port keeps the model's
numerics exactly at bf16 too. `_ssd_chunked` is the oracle of the model's
own form of the scan (the tests hold `ops.ssd_scan` to it) and the function
`SSDScan`'s backward differentiates; no forward path calls it.

Under tensor parallelism (`tp`, `tensor_parallel.py`) a rank runs its H/n
SSM heads: its block of w_zx is gathered into z and x of every head (its
columns are not its heads'), and it takes its heads' of them; the conv
runs on its heads' x channels and every B and C channel, the scan on its
heads, the gated RMSNorm's statistic is summed over the ranks, and
y @ w_out (its rows are its heads' channels) is a partial sum,
all-reduced once. Its recurrent state is its heads' SSM state and the
whole conv buffer (the raw [x | B | C] of every channel, which the
gathered zx makes whole at no cost). Under autograd the block enters its
normed input, the fp32 B and C, dt and the replicated leaves it reads only
its heads' part of through one `enter` (`mamba_fwd`), so their gradients
are whole on every rank.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.dense import param_dtype
from repro_torch.sharding.axes import constrain

F32 = torch.float32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, s.head_dim, s.n_groups, s.d_state


def _silu_f32(x):
    """silu in fp32, cast back: the JAX model's `silu(x.astype(f32)).astype`."""
    return torch.nn.functional.silu(x.to(F32)).to(x.dtype)


def init_mamba_block(generator: torch.Generator, cfg: ModelConfig, dtype,
                     device) -> Dict[str, Any]:
    d = cfg.d_model
    d_in, H, P, G, N = _dims(cfg)
    K = cfg.ssm.conv_dim
    std = d ** -0.5
    conv_ch = d_in + 2 * G * N
    return {
        "ln": torch.ones(d, dtype=dtype, device=device),
        "w_zx": L.normal(generator, (d, 2 * d_in), std, dtype, device),
        "w_bc": L.normal(generator, (d, 2 * G * N), std, dtype, device),
        "w_dt": L.normal(generator, (d, H), std, dtype, device),
        "dt_bias": torch.zeros(H, dtype=F32, device=device),
        "A_log": torch.zeros(H, dtype=F32, device=device),
        "D": torch.ones(H, dtype=F32, device=device),
        "conv_w": L.normal(generator, (K, conv_ch), 0.2, dtype, device),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "norm_w": torch.ones(d_in, dtype=dtype, device=device),
        "w_out": L.normal(generator, (d_in, d), d_in ** -0.5, dtype, device),
    }


def _causal_conv(xbc, w, b):
    """xbc: (B, T, C); depthwise causal conv of width K, summed term by term
    in the working dtype as the JAX model sums them."""
    K, T = w.shape[0], xbc.shape[1]
    pads = torch.nn.functional.pad(xbc, (0, 0, K - 1, 0))
    out = pads[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + pads[:, i:i + T] * w[i]
    return out + b


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """The model's chunked SSD in its own layout (the JAX `_ssd_chunked`):
    x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,G,N) -> (y (B,T,H,P) fp32,
    final state (B,H,P,N) fp32). The tests' oracle for `ops.ssd_scan`, and
    what `SSDScan`'s backward differentiates."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {chunk}")
    nc = T // chunk
    xr = x.reshape(Bsz, nc, chunk, H, P).to(F32)
    dtr = dt.reshape(Bsz, nc, chunk, H).to(F32)
    Br = torch.repeat_interleave(Bm.reshape(Bsz, nc, chunk, G, N), rep, dim=3).to(F32)
    Cr = torch.repeat_interleave(Cm.reshape(Bsz, nc, chunk, G, N), rep, dim=3).to(F32)

    la = torch.cumsum(dtr * A, dim=2)                      # within-chunk log decay
    la_end = la[:, :, -1]                                  # (B, nc, H)
    scores = torch.einsum("bcqhn,bcshn->bchqs", Cr, Br)
    laq = la.permute(0, 1, 3, 2)                           # (B, nc, H, Q)
    decay = torch.exp(torch.clamp(laq[..., :, None] - laq[..., None, :], -60.0, 0.0))
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    w_intra = torch.where(mask, scores * decay, 0.0) * dtr.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", w_intra, xr)

    w_state = torch.exp(torch.clamp(la_end[:, :, None, :] - la, -60.0, 0.0)) * dtr
    S_c = torch.einsum("bcsh,bcshn,bcshp->bchpn", w_state, Br, xr)
    S = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bqhn,bhpn->bqhp", Cr[:, c], S)
                       * torch.exp(la[:, c])[..., None])
        S = torch.exp(la_end[:, c])[:, :, None, None] * S + S_c[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(Bsz, T, H, P), S


class SSDScan(torch.autograd.Function):
    """The SSD scan with its gradient, in the kernel's layout: x (B,H,T,P),
    dt (B,H,T), A (H,), Bm/Cm (B,G,T,N), any strides (`mamba_fwd` passes
    (B,T,H,P) tensors read as (B,H,T,P) views) -> (y (B,H,T,P), final state
    (B,H,P,N) fp32).

    The forward is `ops.ssd_scan` (the kernel on the card: its tensor-core
    path at the model's fp32 views), keeping only the inputs. The backward
    recomputes the model's own form of the scan, `_ssd_chunked`, in fp32
    and differentiates it with autograd: exactly what the JAX reference
    differentiates, since its backward is autodiff of the jnp scan, not a
    Pallas kernel. So this is the port's backward and not a fallback; a
    Hopper SSD backward kernel is queued (ROADMAP.md, Queue 2). Either
    output's gradient may be absent (training takes no final state)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dS):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        live = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        x, dt, A, Bm, Cm = live
        with torch.enable_grad():
            # the (B,H,T,.) views back in the model's (B,T,H,.) layout
            y, S = _ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2), A,
                                Bm.transpose(1, 2), Cm.transpose(1, 2), ctx.chunk)
        outs, grads = [], []
        if dy is not None:
            outs.append(y)
            grads.append(dy.transpose(1, 2))
        if dS is not None:
            outs.append(S)
            grads.append(dS)
        wanted = [t for t, n in zip(live, need) if n]
        got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True)
                   if outs and wanted else ())
        return (*(_laid_out_as(t, next(got)) if n else None for t, n in zip(saved, need)),
                None)


def _laid_out_as(t, g):
    """The gradient `g` of input `t` in t's strides. Autograd hands it on
    to the input's producers, and an elementwise op there whose inputs lie
    in two layouts picks its output's by a rule that differs between the
    meta device and the card (the dry-run's account must see the card's
    ops: launch/dryrun.py)."""
    if g is None or g.stride() == t.stride():
        return g
    return torch.empty_like(t).copy_(g)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int):
    """The SSD scan of `mamba_fwd`: through `SSDScan` when autograd records
    (a training step), else `ops.ssd_scan` directly (prefill)."""
    args = (x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SSDScan.apply(*args, chunk)
    return ops.ssd_scan(*args, chunk=chunk)


def _project(p, xn):
    """The raw B and C (every group) and dt (every head, fp32) of this
    call's tokens."""
    dt = torch.nn.functional.softplus((xn @ p["w_dt"]).to(F32) + p["dt_bias"])
    return xn @ p["w_bc"], dt


def _zx(p, xn, cfg: ModelConfig, tp=None):
    """z and x of w_zx's product: under `tp` gathered from the rank's
    columns (they are not its heads'), z then cut to the rank's heads and x
    kept whole (the conv buffer holds every channel)."""
    d_in = _dims(cfg)[0]
    zx = xn @ p["w_zx"]
    if tp is not None and tp.gather_zx:
        zx = tp.all_gather(zx)
    z, xin = zx[..., :d_in], zx[..., d_in:]
    return (z if tp is None else z[..., tp.ssm_channels]), xin


def _split_bc(bc, G: int, N: int, tp):
    """The conv's B and C channels (..., 2 G N) -> B, C (..., G', N): the
    groups the rank's heads read (all G without `tp`)."""
    Bm, Cm = bc.reshape(*bc.shape[:-1], 2 * G, N).split(G, dim=-2)
    if tp is not None:
        Bm, Cm = Bm[..., tp.ssm_groups, :], Cm[..., tp.ssm_groups, :]
    return Bm, Cm


def _out_proj(p, x, y, z, norm_w, cfg: ModelConfig, tp=None):
    """x + the gated RMSNorm of y (its statistic over every head) @ w_out,
    summed over the ranks under `tp`."""
    g = y * _silu_f32(z)
    if tp is None:
        return x + L.rms_norm(g, norm_w, cfg.norm_eps) @ p["w_out"]
    g = L.rms_norm_split(g, norm_w, _dims(cfg)[0], tp, cfg.norm_eps)
    return x + constrain(tp.psum((g @ p["w_out"], True)), "batch", None, None)


def mamba_fwd(p, x, cfg: ModelConfig, return_state: bool = False, tp=None):
    """Full-sequence mamba2 block. x: (B, T, d) -> (B, T, d).

    With return_state=True also returns (conv_buf, ssm_state) at position T,
    so prefill can hand a decode-ready recurrent cache over (under `tp` the
    whole conv buffer and the rank's heads' state).

    The conv is depthwise, so its B and C channels run apart from its x
    channels, on the raw B and C every rank computes alike. Under `tp` one
    `enter` then takes the normed input of w_zx's split product, dt, the
    conv's x weights and bias, A_log, D, norm_w (the rank reads its heads'
    part of each) and the fp32 B and C the scan reads (every head reads
    them), so their partial gradients are summed in one fp32 all-reduce,
    B's and C's before any bf16 rounding, as one process sums its heads'."""
    d_in, H, P, G, N = _dims(cfg)
    K = cfg.ssm.conv_dim
    B, T, _ = x.shape
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    bc_raw, dt = _project(p, xn)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    Bm, Cm = _split_bc(_silu_f32(_causal_conv(bc_raw, conv_w[:, d_in:], conv_b[d_in:])), G, N, tp)
    Bm, Cm = Bm.to(F32), Cm.to(F32)
    w_x, b_x, A_log, Dp, norm_w = conv_w[:, :d_in], conv_b[:d_in], p["A_log"], p["D"], p["norm_w"]
    if tp is not None:
        xn, dt, w_x, b_x, A_log, Dp, norm_w, Bm, Cm = tp.enter(xn, dt, w_x, b_x, A_log, Dp,
                                                              norm_w, Bm, Cm)
        ch, h = tp.ssm_channels, tp.ssm_heads
        dt, w_x, b_x, A_log, Dp, norm_w = dt[..., h], w_x[:, ch], b_x[ch], A_log[h], Dp[h], norm_w[ch]
    z, xin = _zx(p, xn, cfg, tp)
    xr = xin if tp is None else xin[..., tp.ssm_channels]
    Hr = xr.shape[-1] // P
    xh = constrain(_silu_f32(_causal_conv(xr, w_x, b_x)).reshape(B, T, Hr, P),
                   "batch", None, "model", None, full=(B, T, H, P)).to(F32)
    A = -torch.exp(A_log)
    chunk = min(cfg.ssm.chunk_size, T)
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the SSD chunk {chunk}")
    # (B,T,H,P) etc. read as (B,H,T,P) through strides; y comes back in xh's layout
    y, S_fin = ssd_scan(xh.transpose(1, 2), dt.transpose(1, 2), A,
                        Bm.transpose(1, 2), Cm.transpose(1, 2), chunk)
    y = y.transpose(1, 2) + Dp[None, None, :, None] * xh
    out = _out_proj(p, x, y.reshape(B, T, Hr * P).to(x.dtype), z, norm_w, cfg, tp)
    if not return_state:
        return out
    xbc_raw = torch.cat([xin, bc_raw], dim=-1)
    tail = torch.nn.functional.pad(xbc_raw, (0, 0, max(K - 1 - T, 0), 0))[:, -(K - 1):]
    return out, (tail.to(x.dtype), S_fin)


def mamba_decode(p, x, state, cfg: ModelConfig, tp=None):
    """One-token recurrent update. x: (B, 1, d); state = (conv_buf, S) with
    conv_buf (B, K-1, conv_ch) and S (B, H, P, N) fp32 (under `tp` the
    rank's H/n heads). Returns (out, (new conv_buf, new S))."""
    d_in, H, P, G, N = _dims(cfg)
    conv_buf, S = state
    B = x.shape[0]
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    bc_raw, dt = _project(p, xn)
    z, xin = _zx(p, xn, cfg, tp)
    full = torch.cat([conv_buf, torch.cat([xin, bc_raw], dim=-1)], dim=1)   # (B, K, C)
    conv_w, conv_b, A_log, Dp, norm_w = (p[k] for k in ("conv_w", "conv_b", "A_log", "D",
                                                        "norm_w"))
    dt, full_r = dt[:, 0], full                             # (B, H)
    if tp is not None:
        ch, h = tp.ssm_channels, tp.ssm_heads
        full_r = torch.cat([full[..., ch], full[..., d_in:]], dim=-1)
        conv_w = torch.cat([conv_w[:, ch], conv_w[:, d_in:]], dim=-1)
        conv_b = torch.cat([conv_b[ch], conv_b[d_in:]])
        dt, A_log, Dp, norm_w = dt[:, h], A_log[h], Dp[h], norm_w[ch]
    # the JAX einsum "bkc,kc->bc": products summed in fp32, one rounding
    conv = (full_r.to(F32) * conv_w.to(F32)).sum(1).to(x.dtype) + conv_b
    conv = _silu_f32(conv)

    Hr = S.shape[1]
    xin1, bc1 = conv[..., :Hr * P], conv[..., Hr * P:]
    Bm, Cm = _split_bc(bc1, G, N, tp)                       # (B, G', N)
    rep = H // G
    first = 0 if tp is None else tp.ssm_heads.start % rep
    Bh = torch.repeat_interleave(Bm, rep, dim=1)[:, first:first + Hr].to(F32)   # (B, Hr, N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1)[:, first:first + Hr].to(F32)
    A = -torch.exp(A_log)
    xh = xin1.reshape(B, Hr, P).to(F32)
    S = torch.exp(dt * A)[:, :, None, None] * S + \
        (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch, S) + Dp[None, :, None] * xh
    out = _out_proj(p, x, y.reshape(B, 1, Hr * P).to(x.dtype), z, norm_w, cfg, tp)
    return out, (full[:, 1:], S)


def init_mamba_state(cfg: ModelConfig, batch: int, *, device="cuda", tp=None):
    """Zero (conv_buf in the param dtype, S in fp32) for `batch` sequences;
    under `tp` the whole conv buffer and the rank's heads' S."""
    dev = resolve_device(device)
    d_in, H, P, G, N = _dims(cfg)
    K = cfg.ssm.conv_dim
    if tp is not None:
        H = tp.ssm_heads.stop - tp.ssm_heads.start
    return (torch.zeros((batch, K - 1, d_in + 2 * G * N), dtype=param_dtype(cfg),
                        device=dev),
            torch.zeros((batch, H, P, N), dtype=F32, device=dev))
