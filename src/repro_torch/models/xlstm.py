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

Under tensor parallelism (`tp`, `tensor_parallel.py`) each rank holds its
blocks of the weights (`init_params(..., mesh=, rank=)`). An mLSTM block
gathers w_up's product (its columns are [xi | z], not the rank's heads'),
so every rank has the whole xi and takes its heads' z; its q, k and v
come from its column blocks of w_q, w_k and w_v, the chunked form runs on
its heads, the output norm's statistic is summed over the ranks, and
w_down's rows (its channels) make a partial sum, all-reduced once. The
whole w_if, b_if and norm_w enter with the block's normed input, since the
rank reads its heads' part of them. An sLSTM block's w_gates columns are
its heads' gates, so its recurrence runs on its heads over time with no
collective, and h is all-gathered once before the residual; the GeGLU
gathers w_ff1's product where it is split. Where n does not divide the
heads, q/k/v's and the gates' columns are gathered and every rank runs
every head (`TensorParallel`'s docstring). The rank's cache holds its
heads' states (m_C too, which the reference's cache specs leave whole).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import dense
from repro_torch.models.dense import param_dtype
from repro_torch.sharding.axes import constrain

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


def _head_cols(t, heads: slice, width: int, H: int):
    """The columns of heads `heads` in each of the H-head groups of `width`
    columns a head that make up t's last dim (w_if's [i | f], b_gates's
    head-major z, i, f, o)."""
    groups = t.shape[-1] // (H * width)
    return torch.cat([t[..., g * H * width + heads.start * width:g * H * width + heads.stop * width]
                      for g in range(groups)], dim=-1)


def _mlstm_in(p, x, cfg: ModelConfig, tp=None):
    """The block's input side: xi (every channel) and z halves of the
    up-projection of the normed x, the gate preacts (ig, lf) in fp32, and
    norm_w; under `tp` z, the gates and norm_w of the rank's heads (all of
    them where its heads are not split), w_up's product gathered, and the
    normed x, w_if, b_if and norm_w entered in one `enter`."""
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    w_if, b_if, norm_w = p["w_if"], p["b_if"], p["norm_w"]
    if tp is not None:
        xn, w_if, b_if, norm_w = tp.enter(xn, w_if, b_if, norm_w)
    up = xn @ p["w_up"]
    if tp is not None:
        up = tp.all_gather(up)
    xi, z = torch.chunk(up, 2, dim=-1)
    if tp is not None and tp.xl_heads is not None:
        H = cfg.n_heads
        w_if, b_if = _head_cols(w_if, tp.xl_heads, 1, H), _head_cols(b_if, tp.xl_heads, 1, H)
        z, norm_w = z[..., tp.xl_channels], norm_w[tp.xl_channels]
    gif = xi.to(F32) @ w_if + b_if
    ig, fg = torch.chunk(gif, 2, dim=-1)
    return xi, z, ig, F.logsigmoid(fg), norm_w


def _qkv(p, xi, tp=None):
    """q, k and v of xi: under `tp` of the rank's heads (its column blocks),
    or of every head, the three blocks gathered in one all-gather, where
    its columns are not its heads'."""
    if tp is None or tp.xl_heads is not None:
        return xi @ p["w_q"], xi @ p["w_k"], xi @ p["w_v"]
    c = p["w_q"].shape[1]
    qkv = tp.all_gather(torch.cat([xi @ p["w_q"], xi @ p["w_k"], xi @ p["w_v"]], dim=-1))
    parts = qkv.unflatten(-1, (tp.size, 3, c))
    return tuple(parts[..., i, :].flatten(-2) for i in range(3))


def _mlstm_out(p, x, h, z, norm_w, cfg: ModelConfig, tp=None):
    """x + the normed, z-gated h @ w_down; under `tp` the norm's statistic
    over every channel (summed over the ranks where h is the rank's heads',
    else computed whole and the rank's channels taken), w_down's rows
    the rank's: a partial sum, all-reduced."""
    g = h * F.silu(z.to(F32)).to(z.dtype)
    if tp is None:
        return x + L.rms_norm(g, norm_w, cfg.norm_eps) @ p["w_down"]
    if tp.xl_heads is not None:
        g = L.rms_norm_split(g, norm_w, _mlstm_dims(cfg)[0], tp, cfg.norm_eps)
    else:
        g = L.rms_norm(g, norm_w, cfg.norm_eps)[..., tp.xl_channels]
    return x + constrain(tp.all_reduce(g @ p["w_down"]), "batch", None, None)


def mlstm_fwd(p, x, cfg: ModelConfig, chunk: int = 256, tp=None):
    """The block over x (B, T, d); T must be a multiple of min(chunk, T).
    Under `tp` the chunked form runs on the rank's heads."""
    d_in, H, Dh = _mlstm_dims(cfg)
    B, T, _ = x.shape
    xi, z, ig, lf, norm_w = _mlstm_in(p, x, cfg, tp)
    q, k, v = (t.reshape(B, T, -1, Dh) for t in _qkv(p, xi, tp))
    q = constrain(q, "batch", None, "model", None, full=(B, T, H, Dh))
    h = _mlstm_chunked(q, k, v, ig, lf, min(chunk, T))
    return _mlstm_out(p, x, h.reshape(B, T, -1).to(x.dtype), z, norm_w, cfg, tp)


def mlstm_decode(p, x, state, cfg: ModelConfig, tp=None):
    """O(1) recurrent mLSTM step of x (B, 1, d). state = (C, n, m), under
    `tp` of the rank's heads."""
    d_in, H, Dh = _mlstm_dims(cfg)
    B = x.shape[0]
    C, n, m = state
    xi, z, ig, lf, norm_w = _mlstm_in(p, x, cfg, tp)
    q, k, v = (t.reshape(B, -1, Dh).to(F32) for t in _qkv(p, xi, tp))
    q = q * (Dh ** -0.5)
    ig, lf = ig[:, 0], lf[:, 0]                                      # (B,H)

    m_new = torch.maximum(lf + m, ig)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(ig - m_new)
    C = fp[:, :, None, None] * C + ip[:, :, None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = fp[:, :, None] * n + ip[:, :, None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)), torch.exp(-m_new))
    h = (num / den[:, :, None]).reshape(B, 1, -1).to(x.dtype)
    return _mlstm_out(p, x, h, z, norm_w, cfg, tp), (C, n, m_new)


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


def _slstm_gates(p, x, cfg: ModelConfig, tp=None):
    """The gate preacts (B, T, 4 d') in fp32 and r_gates of the heads the
    block runs: under `tp` the rank's (its column block of w_gates; its
    heads' b_gates and r_gates, entered with the normed x), or every head,
    the gate product's columns gathered, where its heads are not split."""
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    b, r = p["b_gates"], p["r_gates"]
    if tp is not None and tp.xl_heads is not None:
        xn, b, r = tp.enter(xn, b, r)
        Dh = cfg.d_model // cfg.n_heads
        b, r = _head_cols(b, tp.xl_heads, 4 * Dh, cfg.n_heads), r[tp.xl_heads]
        return (xn @ p["w_gates"]).to(F32) + b, r
    if tp is not None:
        return tp.all_gather(tp.enter(xn) @ p["w_gates"], partial=False).to(F32) + b, r
    return (xn @ p["w_gates"]).to(F32) + b, r


def _geglu(p, x, cfg: ModelConfig, tp=None):
    """The GeGLU FFN sub-layer; `jax.nn.gelu` is the tanh approximation.
    Under `tp` w_ff1's product is gathered where it is split, and every rank
    computes the FFN whole (w_ff2 is whole)."""
    xn = L.rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    if tp is not None and tp.gather_ff:
        up = tp.all_gather(tp.enter(xn) @ p["w_ff1"], partial=False)
    else:
        up = xn @ p["w_ff1"]
    a, b = torch.chunk(up, 2, dim=-1)
    y = F.gelu(a.to(F32), approximate="tanh").to(a.dtype) * b
    return x + y @ p["w_ff2"]


def _slstm_h(h, x, tp):
    """The block's h (B, T, heads x Dh) in x's dtype, under `tp` its heads'
    gathered into every head's (once a block, before the residual)."""
    h = h.reshape(*x.shape[:2], -1).to(x.dtype)
    if tp is not None and tp.xl_heads is not None:
        h = tp.all_gather(h, partial=False)
    return h


def slstm_fwd(p, x, cfg: ModelConfig, tp=None):
    """The block over x (B, T, d), its recurrence over time on the rank's
    heads under `tp`."""
    Dh = cfg.d_model // cfg.n_heads
    B, T, _ = x.shape
    gates_x, r = _slstm_gates(p, x, cfg, tp)                       # (B,T,4d')
    H = r.shape[0]
    zeros = torch.zeros((B, H, Dh), dtype=F32, device=x.device)
    state = (zeros, zeros, torch.full_like(zeros, M0), zeros)
    hs = []
    for t in range(T):
        state = _slstm_cell(state, gates_x[:, t], r, H, Dh)
        hs.append(state[3])
    return _geglu(p, x + _slstm_h(torch.stack(hs, dim=1), x, tp), cfg, tp)


def slstm_decode(p, x, state, cfg: ModelConfig, tp=None):
    """One step of x (B, 1, d). state = (c, n, m, h), under `tp` of the
    rank's heads."""
    gates_x, r = _slstm_gates(p, x, cfg, tp)
    state = _slstm_cell(state, gates_x[:, 0], r, r.shape[0], cfg.d_model // cfg.n_heads)
    x = x + _slstm_h(state[3], x, tp)
    return _geglu(p, x, cfg, tp), state


# ----------------------------------------------------------------------------
# Full model: super-blocks of (slstm_every - 1) mLSTM + 1 sLSTM
# ----------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda", mesh=None, rank: int = 0) -> Dict[str, Any]:
    """Random weights drawn from `generator`, which must live on `device`,
    with the JAX init's distributions (from another stream). With a `mesh`,
    rank `rank`'s blocks of them, each leaf drawn whole in the same order
    and cut a block at a time, as `dense.init_params` cuts them."""
    dev = resolve_device(device)
    dtype = param_dtype(cfg)
    nb, n_m = _nb(cfg), cfg.xlstm.slstm_every - 1
    keep = dense._block_keeper(cfg, mesh, rank, init_params)
    return {
        "embed": keep(("embed",), L.init_embedding(
            generator, cfg.vocab_size, cfg.d_model, dtype, cfg.tie_embeddings,
            cfg.padded_vocab, device=dev)),
        "mlstm": [[keep(("mlstm", i, j), init_mlstm_block(generator, cfg, dtype, dev))
                   for j in range(n_m)] for i in range(nb)],
        "slstm": [keep(("slstm", i), init_slstm_block(generator, cfg, dtype, dev))
                  for i in range(nb)],
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }


def _super_block(blocks, sp, x, cfg: ModelConfig, tp=None):
    """slstm_every - 1 mLSTM blocks, then the sLSTM block: the JAX scan body."""
    for mp in blocks:
        x = mlstm_fwd(mp, x, cfg, tp=tp)
    return slstm_fwd(sp, x, cfg, tp)


def backbone_fwd(params, x, cfg: ModelConfig, *, remat: bool = True, tp=None):
    """The stack over x (B, T, d), then the final norm. With `remat` (the
    JAX `lm_loss` checkpoints its super-block) and autograd recording, each
    super-block keeps only its input for the backward and runs again there;
    under `tp` the replay runs all of the super-block's collectives again
    (the sLSTM's GeGLU reads its gathered product)."""
    for blocks, sp in zip(params["mlstm"], params["slstm"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_super_block, blocks, sp, x, cfg, tp, use_reentrant=False)
        else:
            x = _super_block(blocks, sp, x, cfg, tp)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True, group=None, tp=None):
    """Next-token loss of batch {"tokens", "targets"} (B, T) [+ "loss_mask"].
    Returns (xent, {"xent": xent}), as the JAX `lm_loss`. `group`: the
    data-parallel group, as `dense.lm_loss` takes it; under `tp` the rank's
    blocks compute the whole model's loss, its vocab-parallel part without
    gathering the logits."""
    x = L.embed(params["embed"], batch["tokens"], tp)
    x = backbone_fwd(params, x, cfg, remat=remat, tp=tp)
    logits = L.unembed(params["embed"], x, cfg.vocab_size, tp, gather=False)
    loss = L.softmax_xent(logits, batch["targets"], batch.get("loss_mask"), group, tp)
    return loss, {"xent": loss}


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, *,
               device="cuda", tp=None) -> Dict[str, torch.Tensor]:
    """Empty recurrent states; `max_len` is unused (the state is O(1)).
    Under `tp` of the rank's heads (all of them where they are not split)."""
    dev = resolve_device(device)
    nb, n_m = _nb(cfg), cfg.xlstm.slstm_every - 1
    _, H, Dh = _mlstm_dims(cfg)
    Hs, Dhs = cfg.n_heads, cfg.d_model // cfg.n_heads
    if tp is not None and tp.xl_heads is not None:
        H = Hs = tp.xl_heads.stop - tp.xl_heads.start

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


def lm_decode_step(params, cache, batch, cfg: ModelConfig, tp=None):
    """One-token decode. batch: {"tokens": (B, 1)} ("positions" is not
    read: the state is the position). Returns (logits (B, 1, V), cache), the
    cache being the same dictionary, updated in place; under `tp` the
    rank's heads' states."""
    x = L.embed(params["embed"], batch["tokens"], tp)
    for a, (blocks, sp) in enumerate(zip(params["mlstm"], params["slstm"])):
        for j, mp in enumerate(blocks):
            x, (C, n, m) = mlstm_decode(
                mp, x, (cache["m_C"][a, j], cache["m_n"][a, j], cache["m_m"][a, j]), cfg, tp)
            cache["m_C"][a, j], cache["m_n"][a, j], cache["m_m"][a, j] = C, n, m
        names = ("s_c", "s_n", "s_m", "s_h")
        x, state = slstm_decode(sp, x, tuple(cache[k][a] for k in names), cfg, tp)
        for k, s in zip(names, state):
            cache[k][a] = s
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg.vocab_size, tp), cache


def lm_prefill(params, batch, cfg: ModelConfig, tp=None):
    """The full forward's last-token logits (B, 1, V), and empty recurrent
    states, as the JAX `lm_prefill` returns (its note: the serving engine
    rebuilds the states); the prompt is not carried into the cache."""
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, tp)
    x = backbone_fwd(params, x, cfg, remat=False, tp=tp)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg.vocab_size, tp)
    return logits, init_cache(cfg, tokens.shape[0], device=tokens.device, tp=tp)
