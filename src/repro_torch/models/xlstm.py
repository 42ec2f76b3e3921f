"""xLSTM (arXiv:2405.04517): mLSTM blocks (matrix memory, covariance update,
exponential gating) with a periodic sLSTM block (scalar memory,
block-diagonal recurrence per head). Training (`lm_loss`), prefill and
decode.

The port of the JAX package's `models/xlstm.py`. Where JAX scans over
`nb = n_layers // slstm_every` super-blocks of (slstm_every - 1) mLSTM
blocks and one sLSTM block, the port loops: `params["mlstm"]` is a list of
nb lists of slstm_every - 1 block dictionaries and `params["slstm"]` a list
of nb. The cache keeps the JAX layout, fp32 throughout:
  m_C (nb, n_m, B, H, Dh, Dh), m_n (nb, n_m, B, H, Dh), m_m (nb, n_m, B, H),
  s_c / s_n / s_m / s_h (nb, B, H, Dhs),
and a decode step updates it in place.

No kernel runs here: the reference's xLSTM is jnp (there is no Pallas
mLSTM), so the port is plain PyTorch on either device, and that is the
port, not a fallback. The mLSTM's full-sequence form is the stabilized
chunkwise-parallel one (`_mlstm_chunked`, held to the sequential
`kernels/ref.py::mlstm_ref`); the sLSTM runs sequentially over time, since
its recurrence passes through the hidden state.

Reference behaviour kept as it is: `lm_prefill` returns empty recurrent
states (`init_cache`), not the prompt's; the JAX model's note says the
serving engine rebuilds them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.dense import param_dtype

F32 = torch.float32
NEG = -1e30
M0 = -30.0   # the stabilizer of an empty state


def _mlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.xlstm.mlstm_expand * cfg.d_model)
    H = cfg.n_heads
    return d_in, H, d_in // H


def _nb(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.xlstm.slstm_every:
        raise ValueError(f"{cfg.n_layers} layers are not a multiple of "
                         f"slstm_every={cfg.xlstm.slstm_every}")
    return cfg.n_layers // cfg.xlstm.slstm_every


# ----------------------------------------------------------------------------
# mLSTM block
# ----------------------------------------------------------------------------

def init_mlstm_block(generator: torch.Generator, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    d_in, H, _ = _mlstm_dims(cfg)
    std, stdi = d ** -0.5, d_in ** -0.5
    return {
        "ln": torch.ones(d, dtype=dtype, device=device),
        "w_up": L.normal(generator, (d, 2 * d_in), std, dtype, device),
        "w_q": L.normal(generator, (d_in, d_in), stdi, dtype, device),
        "w_k": L.normal(generator, (d_in, d_in), stdi, dtype, device),
        "w_v": L.normal(generator, (d_in, d_in), stdi, dtype, device),
        "w_if": L.normal(generator, (d_in, 2 * H), stdi, F32, device),
        "b_if": torch.cat([torch.zeros(H, dtype=F32, device=device),
                           torch.full((H,), 3.0, dtype=F32, device=device)]),
        "norm_w": torch.ones(d_in, dtype=dtype, device=device),
        "w_down": L.normal(generator, (d_in, d), stdi, dtype, device),
    }


def _mlstm_chunked(q, k, v, ig, lf, chunk: int):
    """Stabilized chunkwise mLSTM, in fp32.

    q/k/v: (B, T, H, Dh); ig: (B, T, H) input-gate preact; lf: (B, T, H)
    log-sigmoid forget preact. Returns h (B, T, H, Dh) fp32. Within a chunk
    the weights D[t, s] = b_t - b_s + i_s (s <= t, b the in-chunk cumsum of
    lf) act in parallel; across chunks the state (C, n, m) carries, m the
    running max that keeps every exp at or below 1."""
    B, T, H, Dh = q.shape
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {chunk}")
    nc = T // chunk
    scale = Dh ** -0.5

    qr = q.reshape(B, nc, chunk, H, Dh).to(F32) * scale
    kr = k.reshape(B, nc, chunk, H, Dh).to(F32)
    vr = v.reshape(B, nc, chunk, H, Dh).to(F32)
    igr = ig.reshape(B, nc, chunk, H).to(F32)
    b = torch.cumsum(lf.reshape(B, nc, chunk, H).to(F32), dim=2)   # (B,nc,Q,H)
    b_end = b[:, :, -1]                                             # (B,nc,H)

    bq = b.transpose(2, 3)                                          # (B,nc,H,Q)
    Dlog = bq[..., :, None] - bq[..., None, :] + igr.transpose(2, 3)[..., None, :]
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    Dlog = torch.where(mask, Dlog, NEG)
    m_intra = Dlog.amax(-1)                                         # (B,nc,H,Q)

    C = torch.zeros((B, H, Dh, Dh), dtype=F32, device=q.device)
    n = torch.zeros((B, H, Dh), dtype=F32, device=q.device)
    m = torch.full((B, H), M0, dtype=F32, device=q.device)
    hs = []
    for c in range(nc):
        qc, kc, vc = qr[:, c], kr[:, c], vr[:, c]                   # (B,Q,H,Dh)
        igc, bc, b_end_c = igr[:, c], b[:, c], b_end[:, c]
        g = bc.transpose(1, 2) + m[:, :, None]                      # (B,H,Q) inter stabilizer
        m_new = torch.maximum(m_intra[:, c], g)
        w_intra = torch.exp(Dlog[:, c] - m_new[..., None])          # (B,H,Q,S)
        e_inter = torch.exp(g - m_new)                              # (B,H,Q)

        ws = w_intra * torch.einsum("bqhd,bshd->bhqs", qc, kc)
        num = torch.einsum("bhqs,bshd->bqhd", ws, vc) \
            + torch.einsum("bqhd,bhde->bqhe", qc, C) * e_inter.transpose(1, 2)[..., None]
        den = ws.sum(-1) + torch.einsum("bqhd,bhd->bhq", qc, n) * e_inter
        den = torch.maximum(torch.abs(den), torch.exp(-m_new))
        hs.append(num / den.transpose(1, 2)[..., None])             # (B,Q,H,Dh)

        # the state at the chunk's end, re-stabilized against the new max
        w_log = (b_end_c[:, None, :] - bc) + igc                    # (B,S,H)
        m_state = torch.maximum(b_end_c + m, w_log.amax(1))
        decay_old = torch.exp(b_end_c + m - m_state)                # (B,H)
        w_state = torch.exp(w_log - m_state[:, None, :])
        C = decay_old[:, :, None, None] * C \
            + torch.einsum("bshd,bshe->bhde", w_state[..., None] * kc, vc)
        n = decay_old[:, :, None] * n + torch.einsum("bsh,bshd->bhd", w_state, kc)
        m = m_state
    return torch.stack(hs, dim=1).reshape(B, T, H, Dh)


def _mlstm_in(p, x, cfg: ModelConfig):
    """The block's input side: (xi, z) halves of the up-projection of the
    normed x, and the gate preacts (ig, lf) in fp32."""
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    xi, z = torch.chunk(xn @ p["w_up"], 2, dim=-1)
    gif = xi.to(F32) @ p["w_if"] + p["b_if"]
    ig, fg = torch.chunk(gif, 2, dim=-1)
    return xi, z, ig, F.logsigmoid(fg)


def _mlstm_out(p, x, h, z, cfg: ModelConfig):
    h = L.rms_norm(h * F.silu(z.to(F32)).to(z.dtype), p["norm_w"], cfg.norm_eps)
    return x + h @ p["w_down"]


def mlstm_fwd(p, x, cfg: ModelConfig, chunk: int = 256):
    """The block over x (B, T, d); T must be a multiple of min(chunk, T)."""
    d_in, H, Dh = _mlstm_dims(cfg)
    B, T, _ = x.shape
    xi, z, ig, lf = _mlstm_in(p, x, cfg)
    q = (xi @ p["w_q"]).reshape(B, T, H, Dh)
    k = (xi @ p["w_k"]).reshape(B, T, H, Dh)
    v = (xi @ p["w_v"]).reshape(B, T, H, Dh)
    h = _mlstm_chunked(q, k, v, ig, lf, min(chunk, T))
    return _mlstm_out(p, x, h.reshape(B, T, d_in).to(x.dtype), z, cfg)


def mlstm_decode(p, x, state, cfg: ModelConfig):
    """O(1) recurrent mLSTM step of x (B, 1, d). state = (C, n, m)."""
    d_in, H, Dh = _mlstm_dims(cfg)
    B = x.shape[0]
    C, n, m = state
    xi, z, ig, lf = _mlstm_in(p, x, cfg)
    q = (xi @ p["w_q"]).reshape(B, H, Dh).to(F32) * (Dh ** -0.5)
    k = (xi @ p["w_k"]).reshape(B, H, Dh).to(F32)
    v = (xi @ p["w_v"]).reshape(B, H, Dh).to(F32)
    ig, lf = ig[:, 0], lf[:, 0]                                      # (B,H)

    m_new = torch.maximum(lf + m, ig)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(ig - m_new)
    C = fp[:, :, None, None] * C + ip[:, :, None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = fp[:, :, None] * n + ip[:, :, None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), torch.exp(-m_new))
    h = (num / den[:, :, None]).reshape(B, 1, d_in).to(x.dtype)
    return _mlstm_out(p, x, h, z, cfg), (C, n, m_new)


# ----------------------------------------------------------------------------
# sLSTM block (sequential over time; block-diagonal recurrence per head)
# ----------------------------------------------------------------------------

def init_slstm_block(generator: torch.Generator, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    H = cfg.n_heads
    Dh = d // H
    dp = int(cfg.xlstm.slstm_proj_factor * d)
    std = d ** -0.5
    return {
        "ln": torch.ones(d, dtype=dtype, device=device),
        "w_gates": L.normal(generator, (d, 4 * d), std, dtype, device),
        "r_gates": L.normal(generator, (H, Dh, 4 * Dh), Dh ** -0.5, F32, device),
        "b_gates": torch.zeros(4 * d, dtype=F32, device=device),
        "ln_ffn": torch.ones(d, dtype=dtype, device=device),
        "w_ff1": L.normal(generator, (d, 2 * dp), std, dtype, device),
        "w_ff2": L.normal(generator, (dp, d), dp ** -0.5, dtype, device),
    }


def _slstm_cell(state, gates_x, r, H: int, Dh: int):
    """One timestep. state = (c, n, m, h), each (B, H, Dh) fp32; gates_x
    (B, 4*d) fp32. Returns the new state."""
    c, n, m, h = state
    B = c.shape[0]
    g = gates_x.reshape(B, H, 4 * Dh) + torch.einsum("bhd,hde->bhe", h, r)
    zt, it, ft, ot = torch.chunk(g, 4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(lf + m - m_new)
    c_new = fp * c + ip * zt
    n_new = fp * n + ip
    h_new = ot * c_new / torch.clamp_min(torch.abs(n_new), 1e-6)
    return c_new, n_new, m_new, h_new


def _slstm_gates(p, x, cfg: ModelConfig):
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    return (xn @ p["w_gates"]).to(F32) + p["b_gates"]


def _geglu(p, x, cfg: ModelConfig):
    """The GeGLU FFN sub-layer; `jax.nn.gelu` is the tanh approximation."""
    a, b = torch.chunk(L.rms_norm(x, p["ln_ffn"], cfg.norm_eps) @ p["w_ff1"], 2, dim=-1)
    y = F.gelu(a.to(F32), approximate="tanh").to(a.dtype) * b
    return x + y @ p["w_ff2"]


def slstm_fwd(p, x, cfg: ModelConfig):
    d, H = cfg.d_model, cfg.n_heads
    Dh = d // H
    B, T, _ = x.shape
    gates_x = _slstm_gates(p, x, cfg)                               # (B,T,4d)
    zeros = torch.zeros((B, H, Dh), dtype=F32, device=x.device)
    state = (zeros, zeros, torch.full_like(zeros, M0), zeros)
    hs = []
    for t in range(T):
        state = _slstm_cell(state, gates_x[:, t], p["r_gates"], H, Dh)
        hs.append(state[3])
    h = torch.stack(hs, dim=1).reshape(B, T, d).to(x.dtype)
    return _geglu(p, x + h, cfg)


def slstm_decode(p, x, state, cfg: ModelConfig):
    """One step of x (B, 1, d). state = (c, n, m, h)."""
    d, H = cfg.d_model, cfg.n_heads
    state = _slstm_cell(state, _slstm_gates(p, x, cfg)[:, 0], p["r_gates"], H, d // H)
    x = x + state[3].reshape(x.shape[0], 1, d).to(x.dtype)
    return _geglu(p, x, cfg), state


# ----------------------------------------------------------------------------
# Full model: super-blocks of (slstm_every - 1) mLSTM + 1 sLSTM
# ----------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> Dict[str, Any]:
    """Random weights drawn from `generator`, which must live on `device`,
    with the JAX init's distributions (from another stream)."""
    dev = resolve_device(device)
    dtype = param_dtype(cfg)
    nb, n_m = _nb(cfg), cfg.xlstm.slstm_every - 1
    return {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype,
                                  cfg.tie_embeddings, cfg.padded_vocab, device=dev),
        "mlstm": [[init_mlstm_block(generator, cfg, dtype, dev) for _ in range(n_m)]
                  for _ in range(nb)],
        "slstm": [init_slstm_block(generator, cfg, dtype, dev) for _ in range(nb)],
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }


def _super_block(blocks, sp, x, cfg: ModelConfig):
    """slstm_every - 1 mLSTM blocks, then the sLSTM block: the JAX scan body."""
    for mp in blocks:
        x = mlstm_fwd(mp, x, cfg)
    return slstm_fwd(sp, x, cfg)


def backbone_fwd(params, x, cfg: ModelConfig, *, remat: bool = True):
    """The stack over x (B, T, d), then the final norm. With `remat` (the
    JAX `lm_loss` checkpoints its super-block) and autograd recording, each
    super-block keeps only its input for the backward and runs again there."""
    for blocks, sp in zip(params["mlstm"], params["slstm"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_super_block, blocks, sp, x, cfg, use_reentrant=False)
        else:
            x = _super_block(blocks, sp, x, cfg)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True, group=None):
    """Next-token loss of batch {"tokens", "targets"} (B, T) [+ "loss_mask"].
    Returns (xent, {"xent": xent}), as the JAX `lm_loss`."""
    x = L.embed(params["embed"], batch["tokens"])
    x = backbone_fwd(params, x, cfg, remat=remat)
    logits = L.unembed(params["embed"], x, cfg.vocab_size)
    loss = L.softmax_xent(logits, batch["targets"], batch.get("loss_mask"), group)
    return loss, {"xent": loss}


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Empty recurrent states; `max_len` is unused (the state is O(1))."""
    dev = resolve_device(device)
    nb, n_m = _nb(cfg), cfg.xlstm.slstm_every - 1
    _, H, Dh = _mlstm_dims(cfg)
    Hs, Dhs = cfg.n_heads, cfg.d_model // cfg.n_heads

    def z(*shape):
        return torch.zeros(shape, dtype=F32, device=dev)
    return {
        "m_C": z(nb, n_m, batch, H, Dh, Dh),
        "m_n": z(nb, n_m, batch, H, Dh),
        "m_m": torch.full((nb, n_m, batch, H), M0, dtype=F32, device=dev),
        "s_c": z(nb, batch, Hs, Dhs),
        "s_n": z(nb, batch, Hs, Dhs),
        "s_m": torch.full((nb, batch, Hs, Dhs), M0, dtype=F32, device=dev),
        "s_h": z(nb, batch, Hs, Dhs),
    }


def lm_decode_step(params, cache, batch, cfg: ModelConfig):
    """One-token decode. batch: {"tokens": (B, 1)} ("positions" is not
    read: the state is the position). Returns (logits (B, 1, V), cache), the
    cache being the same dictionary, updated in place."""
    x = L.embed(params["embed"], batch["tokens"])
    for a, (blocks, sp) in enumerate(zip(params["mlstm"], params["slstm"])):
        for j, mp in enumerate(blocks):
            x, (C, n, m) = mlstm_decode(
                mp, x, (cache["m_C"][a, j], cache["m_n"][a, j], cache["m_m"][a, j]), cfg)
            cache["m_C"][a, j], cache["m_n"][a, j], cache["m_m"][a, j] = C, n, m
        names = ("s_c", "s_n", "s_m", "s_h")
        x, state = slstm_decode(sp, x, tuple(cache[k][a] for k in names), cfg)
        for k, s in zip(names, state):
            cache[k][a] = s
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg.vocab_size), cache


def lm_prefill(params, batch, cfg: ModelConfig):
    """The full forward's last-token logits (B, 1, V), and empty recurrent
    states, as the JAX `lm_prefill` returns (its note: the serving engine
    rebuilds the states); the prompt is not carried into the cache."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens)
    x = backbone_fwd(params, x, cfg, remat=False)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg.vocab_size)
    return logits, init_cache(cfg, tokens.shape[0], device=tokens.device)
