"""Whisper-style encoder-decoder backbone (the audio family): training
(`lm_loss`), prefill and decode.

The port of the JAX package's `models/whisper.py`. As there, the conv/mel
frontend is a stub: the caller hands precomputed frame embeddings
`enc_embeds` (B, T_enc, d). The encoder is a bidirectional transformer with
rope; the decoder has causal self-attention, cross-attention to the
encoder's output and a SwiGLU FFN. Where JAX stacks the layers on a leading
axis, `params["enc_layers"]` and `params["dec_layers"]` are lists of
per-layer dictionaries. The cache keeps the JAX layout, (L, B, S, H, hd)
per buffer: the decoder's self `k`/`v` and the fixed `cross_k`/`cross_v` of
the encoder's T_enc rows (ENC_LEN in `init_cache`).

Prefill attention (the encoder's non-causal self-attention, the decoder's
causal one, and cross-attention with Tq != Tk) goes through
`ops.flash_attention`, decode attention through `ops.decode_attention`:
the self cache with valid_len = pos + 1 after the step's store, the cross
cache with every row valid. Both read a (B, S, H, hd) cache slice as
(B, H, S, hd) through strides, with no copy. Under autograd attention goes
through `flash_vjp.FlashAttention`, and each encoder and decoder layer is
recomputed in the backward (remat), as the JAX model checkpoints its scan
bodies.

Under tensor parallelism (`tp`, `tensor_parallel.py`) each rank holds its
blocks of the weights (`init_params(..., mesh=, rank=)`); the encoder's
and the decoder's self- and cross-attention run on the rank's heads as
`layers.attention` plans them (heads that do not divide the axis, as
whisper-tiny's 6 at n = 4, gathered by column, each rank multiplying its
columns of them by its rows of wo), the FFNs on the rank's d_ff columns,
the embeddings on its vocab rows. The encoder's input is replicated. The
cache holds the rank's cache heads of the self and the cross k/v. Under
autograd the encoder's output enters the decoder's split cross k/v
products once, for every layer.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import dense
from repro_torch.models import layers as L
from repro_torch.models.dense import _replicate_kv, _store_kv, param_dtype

F32 = torch.float32
ENC_LEN = 1536   # encoder frames (~30 s of audio, padded to the flash block size)


def _mlp_init(generator, d, f, dtype, device):
    std = d ** -0.5
    return {"w1": L.normal(generator, (d, f), std, dtype, device),
            "w3": L.normal(generator, (d, f), std, dtype, device),
            "w2": L.normal(generator, (f, d), f ** -0.5, dtype, device)}


def _attn_init(generator, cfg: ModelConfig, dtype, device):
    return L.init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim, False, dtype, device=device)


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda", mesh=None, rank: int = 0) -> Dict[str, Any]:
    """Random weights drawn from `generator`, which must live on `device`,
    with the JAX init's distributions (from another stream). With a `mesh`,
    rank `rank`'s blocks of them, each leaf drawn whole in the same order
    and cut a layer at a time, as `dense.init_params` cuts them."""
    dev = resolve_device(device)
    dtype = param_dtype(cfg)
    keep = dense._block_keeper(cfg, mesh, rank, init_params)

    def ones():
        return torch.ones(cfg.d_model, dtype=dtype, device=dev)

    def enc_block():
        return {"ln1": ones(), "ln2": ones(),
                "attn": _attn_init(generator, cfg, dtype, dev),
                "mlp": _mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, dev)}

    def dec_block():
        return {"ln1": ones(), "ln_x": ones(), "ln2": ones(),
                "attn": _attn_init(generator, cfg, dtype, dev),
                "cross": _attn_init(generator, cfg, dtype, dev),
                "mlp": _mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, dev)}

    return {
        "embed": keep(("embed",), L.init_embedding(
            generator, cfg.vocab_size, cfg.d_model, dtype, cfg.tie_embeddings,
            cfg.padded_vocab, device=dev)),
        "enc_layers": [keep(("enc_layers", i), enc_block())
                       for i in range(cfg.encdec.n_enc_layers)],
        "dec_layers": [keep(("dec_layers", i), dec_block()) for i in range(cfg.n_layers)],
        "enc_norm": ones(),
        "final_norm": ones(),
    }


def _ffn(lp, x, cfg: ModelConfig, tp=None):
    y, _ = dense._ffn(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg, tp=tp)
    return x + y


def _positions(B: int, T: int, device):
    return torch.arange(T, dtype=torch.int32, device=device).expand(B, T)


def _enc_block(lp, x, positions, cfg: ModelConfig, tp=None):
    h, _ = L.attention(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), positions, cfg,
                       causal=False, tp=tp)
    return _ffn(lp, x + h, cfg, tp)


def _run(block, remat: bool, *args):
    """block(*args), kept for the backward as its inputs only (remat) when
    autograd records and `remat` is asked."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def encode(params, enc_embeds, cfg: ModelConfig, *, remat: bool = True, tp=None):
    """enc_embeds: (B, T_enc, d), the stub frontend's output -> the
    encoder's normed output (B, T_enc, d) in the working dtype."""
    B, Te, _ = enc_embeds.shape
    positions = _positions(B, Te, enc_embeds.device)
    x = enc_embeds.to(param_dtype(cfg))
    for lp in params["enc_layers"]:
        x = _run(_enc_block, remat, lp, x, positions, cfg, tp)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enter_encoder(enc_out, tp):
    """The encoder's output as the input of the rank's split cross k/v
    products (every decoder layer's: their partial gradients are summed in
    one all-reduce), or as it is."""
    if tp is not None and (tp.kv_split or tp.gather_kv):
        return tp.enter(enc_out)
    return enc_out


def _cross_kv(lp, enc_out, cfg: ModelConfig, tp=None):
    """The cross-attention's k/v (B, T_enc, Hkv, hd) of the encoder's output
    (under `tp` the rank's heads, of an output `_enter_encoder` entered)."""
    return L.project_kv(lp["cross"], enc_out, cfg, tp)


def _dec_block(lp, x, positions, cross, cfg: ModelConfig, tp=None):
    """One decoder layer over x (B, T, d), given its cross k/v. Returns (x,
    this call's self (k, v))."""
    h, kv = L.attention(lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), positions, cfg,
                        causal=True, tp=tp)
    x = x + h
    h, _ = L.attention(lp["cross"], L.rms_norm(x, lp["ln_x"], cfg.norm_eps), positions, cfg,
                       cross_kv=cross, tp=tp)
    return _ffn(lp, x + h, cfg, tp), kv


def _dec_block_loss(lp, x, positions, enc_out, cfg: ModelConfig, tp=None):
    y, _ = _dec_block(lp, x, positions, _cross_kv(lp, enc_out, cfg, tp), cfg, tp)
    return y


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True, group=None, tp=None):
    """Next-token loss of batch {"tokens", "targets"} (B, T), "enc_embeds"
    (B, T_enc, d) [+ "loss_mask"]. Returns (xent, {"xent": xent}), as the
    JAX `lm_loss`. `group`: the data-parallel group, as `dense.lm_loss`
    takes it; under `tp` the rank's blocks compute the whole model's loss,
    its vocab-parallel part without gathering the logits."""
    tokens, targets = batch["tokens"], batch["targets"]
    B, T = tokens.shape
    enc_out = _enter_encoder(encode(params, batch["enc_embeds"], cfg, remat=remat, tp=tp), tp)
    positions = _positions(B, T, tokens.device)
    x = L.embed(params["embed"], tokens, tp)
    for lp in params["dec_layers"]:
        x = _run(_dec_block_loss, remat, lp, x, positions, enc_out, cfg, tp)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg.vocab_size, tp, gather=False)
    loss = L.softmax_xent(logits, targets, batch.get("loss_mask"), group, tp)
    return loss, {"xent": loss}


# ----------------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda", tp=None) -> Dict[str, torch.Tensor]:
    """Zeros of the cache; under tensor parallelism (`tp`) of the rank's
    cache heads, self and cross."""
    dev = resolve_device(device)
    hd, dtype, Lc = cfg.resolved_head_dim, param_dtype(cfg), cfg.n_layers
    heads = cfg.n_kv_heads if tp is None else tp.cache_heads

    def z(S):
        return torch.zeros((Lc, batch, S, heads, hd), dtype=dtype, device=dev)
    return {"k": z(max_len), "v": z(max_len), "cross_k": z(ENC_LEN), "cross_v": z(ENC_LEN)}


def lm_prefill(params, batch, cfg: ModelConfig, *, tp=None):
    """Encoder pass and decoder prefill of {"tokens" (B, T), "enc_embeds"
    (B, T_enc, d)}. Returns (last-token logits (B, 1, V), cache) with the
    self k/v of length T and the cross k/v of length T_enc (under `tp` the
    rank's cache heads of each). The reference computes each layer's cross
    k/v twice (in the block and for the cache); the port once, with the
    same result."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    enc_out = encode(params, batch["enc_embeds"], cfg, remat=False, tp=tp)
    positions = _positions(B, T, tokens.device)
    x = L.embed(params["embed"], tokens, tp)
    bufs = {"k": [], "v": [], "cross_k": [], "cross_v": []}
    for lp in params["dec_layers"]:
        ck, cv = _cross_kv(lp, enc_out, cfg, tp)
        x, (k, v) = _dec_block(lp, x, positions, (ck, cv), cfg, tp)
        for name, t in zip(bufs, (*_replicate_kv(cfg, k, v, tp), *_replicate_kv(cfg, ck, cv, tp))):
            bufs[name].append(t)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg.vocab_size, tp)
    return logits, {name: torch.stack(ts) for name, ts in bufs.items()}


def lm_decode_step(params, cache, batch, cfg: ModelConfig, *, tp=None):
    """One-token decode. batch: {"tokens": (B, 1), "positions": (B,)}.
    Returns (logits (B, 1, V), cache), the cache being the same dictionary
    with this step's self k/v stored in place at row pos (dropped at or past
    the cache's end, as JAX's scatter with mode="drop" drops it). Under `tp`
    the rank's heads, stored and read as `dense.block_decode` stores and
    reads them, each wo product summed over the ranks."""
    tokens, pos = batch["tokens"], batch["positions"]
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens, tp)
    valid = (pos + 1).to(torch.int32)
    n_cross = torch.full((B,), cache["cross_k"].shape[2], dtype=torch.int32,
                         device=tokens.device)
    heads = None if tp is None else tp.read_heads

    def attend(q, name_k, name_v, li, valid_len):
        """q (B, 1, Hq, hd) over layer li's (B, S, H, hd) slices (or their
        `heads`), read in place as (B, H, S, hd)."""
        kc, vc = cache[name_k][li], cache[name_v][li]
        if heads is not None:
            kc, vc = kc[:, :, heads], vc[:, :, heads]
        return ops.decode_attention(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), valid_len)

    for li, lp in enumerate(params["dec_layers"]):
        xn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv(lp["attn"], xn, pos[:, None], cfg, tp)
        _store_kv(cfg, cache, li, *_replicate_kv(cfg, k, v, tp), pos)
        o = attend(q, "k", "v", li, valid)
        x = x + L.attn_out(lp["attn"], o.reshape(B, 1, -1), tp)
        # cross-attention against the cached encoder k/v
        qx = L.project_q(lp["cross"], L.rms_norm(x, lp["ln_x"], cfg.norm_eps), cfg, tp)
        o = attend(qx, "cross_k", "cross_v", li, n_cross)
        x = x + L.attn_out(lp["cross"], o.reshape(B, 1, -1), tp)
        x = _ffn(lp, x, cfg, tp)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg.vocab_size, tp), cache
