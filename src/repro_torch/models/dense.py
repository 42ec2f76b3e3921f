"""Dense (llama-family) decoder LM, and the same block with an MoE FFN
(family "moe"): the training loss (`lm_loss`, with remat), prefill,
one-token decode against a KV cache, and the full forward that the decode
path is checked against.

The port of the JAX package's `models/dense.py`. Parameters are plain
dictionaries of tensors with the JAX pytree's keys; `params["layers"]` is a
list with one dictionary per layer where JAX stacks them on a leading axis.
The cache keeps the JAX layout, (L, B, S, Hc, D) per buffer plus fp32
(L, B, S, Hc, 1) scales for an int8 cache, and is updated in place one layer
at a time where JAX threads it through the scan carry. Attention goes through
`kernels/ops.py`: the CUDA kernels on the card, the plain versions on the
CPU; so does the MoE FFN's expert matmul (`models/moe.py`). Under autograd,
attention goes through the flash backward (`models/flash_vjp.py`); the
expert matmul has no backward on the card yet, so MoE training runs on the
CPU only (its kernel raises under grad, `kernels/ops.py::check_no_grad`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe_layer, moe_ffn

F32 = torch.float32

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


# ----------------------------------------------------------------------------
# Parameter init
# ----------------------------------------------------------------------------

def init_block(generator: torch.Generator, cfg: ModelConfig, dtype, device):
    p: Dict[str, Any] = {
        "ln1": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "ln2": torch.ones(cfg.d_model, dtype=dtype, device=device),
        "attn": L.init_attention(generator, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.resolved_head_dim,
                                 cfg.qkv_bias, dtype, cfg.pad_heads_to,
                                 cfg.pad_kv_heads_to, device=device),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe_layer(generator, cfg, dtype, device)
        return p
    std = cfg.d_model ** -0.5
    p["mlp"] = {name: L.normal(generator, shape, std, dtype, device)
                for name, shape in (("w1", (cfg.d_model, cfg.d_ff)),
                                    ("w3", (cfg.d_model, cfg.d_ff)),
                                    ("w2", (cfg.d_ff, cfg.d_model)))}
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> Dict[str, Any]:
    """Random weights drawn from `generator`, which must live on `device`:
    normal(0, d_model**-0.5) projections, normal(0, 0.02) embeddings and
    unit norms, as the JAX init draws them (from another stream)."""
    dev = resolve_device(device)
    dtype = param_dtype(cfg)
    return {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                  dtype, cfg.tie_embeddings, cfg.padded_vocab,
                                  device=dev),
        "layers": [init_block(generator, cfg, dtype, dev)
                   for _ in range(cfg.n_layers)],
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------

def _ffn(p, xn, cfg: ModelConfig):
    """The block's FFN on normed x: (y, the MoE aux loss, or None for a dense
    FFN, which has none)."""
    if cfg.family == "moe":
        return moe_ffn(p["moe"], xn, cfg)
    return L.swiglu(xn, p["mlp"]["w1"], p["mlp"]["w3"], p["mlp"]["w2"]), None


def block_fwd(p, x, positions, cfg: ModelConfig, *, window: Optional[int] = None):
    """Full-sequence block: causal attention + FFN. Returns (x, aux), aux
    None for a dense block."""
    h, _ = L.attention(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                       positions, cfg, causal=True, window=window)
    x = x + h
    y, aux = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y, aux


def backbone_fwd(params, x, positions, cfg: ModelConfig, *,
                 window: Optional[int] = None, remat: bool = True):
    """The block stack over x (B, T, d) without a cache, then the final norm.
    Returns (x, summed aux). With `remat` (the JAX default) and autograd
    recording, each block keeps only its input for the backward and runs
    again there (`jax.checkpoint` of the JAX scan body); without autograd
    there is nothing to keep, and the blocks run plainly."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    for lp in params["layers"]:
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(block_fwd, lp, x, positions, cfg, window=window,
                              use_reentrant=False)
        else:
            x, a = block_fwd(lp, x, positions, cfg, window=window)
        if a is not None:
            aux = aux + a
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """Next-token loss of batch {"tokens", "targets"} (B, T) [+ "loss_mask"]:
    embed, the block stack, unembed with the padded vocab masked, the fp32
    cross entropy. Returns (xent + aux, {"xent", "aux"}), as the JAX
    `lm_loss`."""
    if cfg.family not in ("dense", "moe") or "patch_embeds" in batch:
        raise NotImplementedError(
            f"lm_loss of family {cfg.family!r}: the VLM frontend (_inject_frontend) is not "
            "ported yet; see ROADMAP.md, Queue 1")
    tokens, targets = batch["tokens"], batch["targets"]
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    x = L.embed(params["embed"], tokens)
    x, aux = backbone_fwd(params, x, positions, cfg, remat=remat)
    logits = L.unembed(params["embed"], x, cfg.vocab_size)
    loss = L.softmax_xent(logits, targets, batch.get("loss_mask"))
    return loss + aux, {"xent": loss, "aux": aux}


# ----------------------------------------------------------------------------
# KV cache + serving
# ----------------------------------------------------------------------------

def kv_cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.int8 if cfg.kv_cache_dtype == "int8" else param_dtype(cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.cache_kv_heads,
             cfg.resolved_head_dim)
    kd = kv_cache_dtype(cfg)
    cache = {"k": torch.zeros(shape, dtype=kd, device=dev),
             "v": torch.zeros(shape, dtype=kd, device=dev)}
    if cfg.kv_cache_dtype == "int8":
        cache["k_scale"] = torch.zeros(shape[:-1] + (1,), dtype=F32, device=dev)
        cache["v_scale"] = torch.zeros(shape[:-1] + (1,), dtype=F32, device=dev)
    return cache


def _quantize_kv(x):
    """Per (token, head) symmetric int8 quantization. torch.round rounds
    half to even, as jnp.round does."""
    xf = x.to(F32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _replicate_kv(cfg: ModelConfig, k, v):
    """Repeat each kv head kv_replication times in place along the head
    axis (jnp.repeat), so the cache holds cache_kv_heads heads."""
    if cfg.kv_replication > 1:
        k = torch.repeat_interleave(k, cfg.kv_replication, dim=2)
        v = torch.repeat_interleave(v, cfg.kv_replication, dim=2)
    return k, v


def _store_kv(cfg: ModelConfig, cache, li: int, k, v, pos):
    """Write this step's (k, v) (B, 1, Hc, D) into layer li of the cache at
    row pos[b], in place. A row at or past the cache length is dropped, as
    JAX's scatter with mode="drop" drops it."""
    if k.shape[1] != 1:
        raise ValueError(f"a decode step stores one token per sequence, got {k.shape[1]}")
    if cfg.kv_cache_dtype == "int8":
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    S = cache["k"].shape[2]
    # a dropped write rewrites row S-1 with its old contents, so no host
    # sync is needed to filter it out
    row = torch.clamp(pos.to(torch.long), max=S - 1)[:, None]
    keep = (pos < S)[:, None, None, None]
    bidx = torch.arange(k.shape[0], device=pos.device)[:, None]
    for name, val in new.items():
        buf = cache[name][li]
        buf[bidx, row] = torch.where(keep, val.to(buf.dtype), buf[bidx, row])


def block_decode(p, x, cache, li: int, pos, cfg: ModelConfig):
    """One decode step through layer li. x: (B, 1, d); pos: (B,) int32, the
    current length of each sequence. Updates the cache in place."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    positions = pos[:, None] + torch.arange(T, device=x.device, dtype=pos.dtype)[None, :]
    q, k, v = L.qkv(p["attn"], xn, positions, cfg)
    k, v = _replicate_kv(cfg, k, v)
    _store_kv(cfg, cache, li, k, v, pos)
    out = _decode_attend(q, cache, li, (pos + T).to(torch.int32))
    x = x + out.reshape(B, T, cfg.eff_q_heads * hd) @ p["attn"]["wo"]
    y, _ = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + y


def _decode_attend(q, cache, li: int, valid):
    """Attention of q (B, 1, Hq, hd) over layer li's cache, read in place as
    the (B, Hc, S, hd) view of its (B, S, Hc, hd) slice."""
    def view(name):
        return cache[name][li].transpose(1, 2) if name in cache else None
    return ops.decode_attention(q[:, 0], view("k"), view("v"), valid,
                                view("k_scale"), view("v_scale"))


def lm_decode_step(params, cache, batch, cfg: ModelConfig):
    """One-token decode across the whole stack. batch: {"tokens": (B, 1),
    "positions": (B,)}. Returns (logits (B, 1, V), cache), the cache being
    the same dictionary, updated in place.

    Like the JAX decode step this attends over the whole valid prefix; the
    JAX step passes `window` without a query offset, so it never masks."""
    tokens, pos = batch["tokens"], batch["positions"]
    x = L.embed(params["embed"], tokens)
    for li, lp in enumerate(params["layers"]):
        x = block_decode(lp, x, cache, li, pos, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg.vocab_size), cache


def lm_prefill(params, batch, cfg: ModelConfig, *, window: Optional[int] = None):
    """Full forward that also materializes the KV cache.

    Returns (last-token logits (B, 1, V), cache) with cache buffers of
    length T: (L, B, T, Hc, D) [+ int8 scales]."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    x = L.embed(params["embed"], tokens)
    kvs: Dict[str, List[torch.Tensor]] = {}
    for lp in params["layers"]:
        xn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, (k, v) = L.attention(lp["attn"], xn, positions, cfg, causal=True,
                                window=window)
        x = x + h
        y, _ = _ffn(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        x = x + y
        k, v = _replicate_kv(cfg, k, v)
        if cfg.kv_cache_dtype == "int8":
            (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
            kvs.setdefault("k_scale", []).append(ks)
            kvs.setdefault("v_scale", []).append(vs)
        kvs.setdefault("k", []).append(k)
        kvs.setdefault("v", []).append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg.vocab_size)
    return logits, {name: torch.stack(bufs) for name, bufs in kvs.items()}
