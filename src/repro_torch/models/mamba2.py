"""Mamba2 (SSD) blocks, inference only: the full-sequence forward (prefill)
and the one-token recurrent update (decode).

The port of the JAX package's `models/mamba2.py`. Prefill runs the chunked
SSD scan through `kernels/ops.py::ssd_scan` (the CUDA kernel on the card, the
plain version on the CPU) on the (B, H, T, P) view of the model's
(B, T, H, P) tensors, with no transpose copy.

Numerics: the kernel returns y in the dtype of its x, while the model's
chunked scan keeps y in fp32 and adds the D skip in fp32 before one cast to
the working dtype. So `mamba_fwd` hands the kernel x, B and C in fp32, as the
model's `_ssd_chunked` casts them inside, and the port keeps the model's
numerics exactly at bf16 too. `_ssd_chunked` itself is kept as the oracle of
the model's own form of the scan: the tests hold `ops.ssd_scan` to it; no
forward path calls it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.dense import param_dtype

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
    final state (B,H,P,N) fp32). The tests' oracle for `ops.ssd_scan`."""
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


def _in_proj(p, xn, cfg: ModelConfig):
    """z, the conv input (x, B, C) and dt of this call's tokens."""
    d_in = _dims(cfg)[0]
    zx = xn @ p["w_zx"]
    z, xin = zx[..., :d_in], zx[..., d_in:]
    dt = torch.nn.functional.softplus((xn @ p["w_dt"]).to(F32) + p["dt_bias"])
    return z, torch.cat([xin, xn @ p["w_bc"]], dim=-1), dt


def _out_proj(p, x, y, z, cfg: ModelConfig):
    y = L.rms_norm(y * _silu_f32(z), p["norm_w"], cfg.norm_eps)
    return x + y @ p["w_out"]


def mamba_fwd(p, x, cfg: ModelConfig, return_state: bool = False):
    """Full-sequence mamba2 block. x: (B, T, d) -> (B, T, d).

    With return_state=True also returns (conv_buf, ssm_state) at position T,
    so prefill can hand a decode-ready recurrent cache over."""
    d_in, H, P, G, N = _dims(cfg)
    K = cfg.ssm.conv_dim
    B, T, _ = x.shape
    z, xbc_raw, dt = _in_proj(p, L.rms_norm(x, p["ln"], cfg.norm_eps), cfg)
    xbc = _silu_f32(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xin, bc = xbc[..., :d_in], xbc[..., d_in:]
    Bm, Cm = bc.reshape(B, T, 2 * G, N).split(G, dim=2)

    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, T, H, P).to(F32)
    chunk = min(cfg.ssm.chunk_size, T)
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the SSD chunk {chunk}")
    # (B,T,H,P) etc. read as (B,H,T,P) through strides; y comes back in xh's layout
    y, S_fin = ops.ssd_scan(xh.transpose(1, 2), dt.transpose(1, 2), A,
                            Bm.to(F32).transpose(1, 2), Cm.to(F32).transpose(1, 2),
                            chunk=chunk)
    y = y.transpose(1, 2) + p["D"][None, None, :, None] * xh
    out = _out_proj(p, x, y.reshape(B, T, d_in).to(x.dtype), z, cfg)
    if not return_state:
        return out
    tail = torch.nn.functional.pad(xbc_raw, (0, 0, max(K - 1 - T, 0), 0))[:, -(K - 1):]
    return out, (tail.to(x.dtype), S_fin)


def mamba_decode(p, x, state, cfg: ModelConfig):
    """One-token recurrent update. x: (B, 1, d); state = (conv_buf, S) with
    conv_buf (B, K-1, conv_ch) and S (B, H, P, N) fp32. Returns
    (out, (new conv_buf, new S))."""
    d_in, H, P, G, N = _dims(cfg)
    conv_buf, S = state
    B = x.shape[0]
    z, xbc_new, dt = _in_proj(p, L.rms_norm(x, p["ln"], cfg.norm_eps), cfg)
    dt = dt[:, 0]                                           # (B, H)
    full = torch.cat([conv_buf, xbc_new], dim=1)            # (B, K, C)
    # the JAX einsum "bkc,kc->bc": products summed in fp32, one rounding
    conv = (full.to(F32) * p["conv_w"].to(F32)).sum(1).to(x.dtype) + p["conv_b"]
    conv = _silu_f32(conv)

    xin1, bc1 = conv[..., :d_in], conv[..., d_in:]
    Bm, Cm = bc1.reshape(B, 2 * G, N).split(G, dim=1)
    Bh = torch.repeat_interleave(Bm, H // G, dim=1).to(F32)  # (B, H, N)
    Ch = torch.repeat_interleave(Cm, H // G, dim=1).to(F32)
    A = -torch.exp(p["A_log"])
    xh = xin1.reshape(B, H, P).to(F32)
    S = torch.exp(dt * A)[:, :, None, None] * S + \
        (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch, S) + p["D"][None, :, None] * xh
    out = _out_proj(p, x, y.reshape(B, 1, d_in).to(x.dtype), z, cfg)
    return out, (full[:, 1:], S)


def init_mamba_state(cfg: ModelConfig, batch: int, *, device="cuda"):
    """Zero (conv_buf in the param dtype, S in fp32) for `batch` sequences."""
    dev = resolve_device(device)
    d_in, H, P, G, N = _dims(cfg)
    K = cfg.ssm.conv_dim
    return (torch.zeros((batch, K - 1, d_in + 2 * G * N), dtype=param_dtype(cfg),
                        device=dev),
            torch.zeros((batch, H, P, N), dtype=F32, device=dev))
