"""zamba2-style hybrid model, inference only: a mamba2 backbone with one
*shared* attention + FFN block applied after every `attn_every` mamba2
blocks.

The port of the JAX package's `models/hybrid.py`. Where JAX scans over
`nb = n_layers // attn_every` super-blocks, the port loops:
`params["mamba"]` is a list of nb lists of attn_every block dictionaries,
and the shared block's parameters are used by every application. The cache
keeps the JAX layout, with one KV slice per application and one recurrent
state per mamba2 block:
  k/v (nb, B, W, H, hd), conv (nb, attn_every, B, K-1, C), ssm (nb,
  attn_every, B, H, P, N) fp32,
and a decode step updates it in place. Prefill attention goes through the
flash kernel, decode attention through the decode kernel over the rolling
cache (slot pos % W), and the mamba2 prefill through the SSD scan kernel, all
via `kernels/ops.py`.

The hybrid is driven through this model interface, not through `ServeEngine`:
the engine's cache scatter, copied from the JAX engine, knows only caches
whose axis 1 is the batch slot.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.dense import param_dtype


def _nb(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.hybrid.attn_every:
        raise ValueError(f"{cfg.n_layers} layers are not a multiple of "
                         f"attn_every={cfg.hybrid.attn_every}")
    return cfg.n_layers // cfg.hybrid.attn_every


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> Dict[str, Any]:
    """Random weights drawn from `generator`, which must live on `device`,
    with the JAX init's distributions (from another stream)."""
    dev = resolve_device(device)
    dtype = param_dtype(cfg)
    std = cfg.d_model ** -0.5
    return {
        "embed": L.init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype,
                                  cfg.tie_embeddings, cfg.padded_vocab, device=dev),
        "mamba": [[M.init_mamba_block(generator, cfg, dtype, dev)
                   for _ in range(cfg.hybrid.attn_every)] for _ in range(_nb(cfg))],
        "shared_attn": {
            "ln1": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "ln2": torch.ones(cfg.d_model, dtype=dtype, device=dev),
            "attn": L.init_attention(generator, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.resolved_head_dim,
                                     cfg.qkv_bias, dtype, cfg.pad_heads_to,
                                     cfg.pad_kv_heads_to, device=dev),
            "mlp": {name: L.normal(generator, shape, std, dtype, dev)
                    for name, shape in (("w1", (cfg.d_model, cfg.d_ff)),
                                        ("w3", (cfg.d_model, cfg.d_ff)),
                                        ("w2", (cfg.d_ff, cfg.d_model)))},
        },
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }


def _shared_ffn(sp, x, cfg: ModelConfig):
    mlp = sp["mlp"]
    return x + L.swiglu(L.rms_norm(x, sp["ln2"], cfg.norm_eps),
                        mlp["w1"], mlp["w3"], mlp["w2"])


def _shared_attn_fwd(sp, x, positions, cfg: ModelConfig, window):
    h, kv = L.attention(sp["attn"], L.rms_norm(x, sp["ln1"], cfg.norm_eps),
                        positions, cfg, causal=True, window=window)
    return _shared_ffn(sp, x + h, cfg), kv


def backbone_fwd(params, x, positions, cfg: ModelConfig, *,
                 window: Optional[int] = None):
    """The stack over x (B, T, d) without a cache, then the final norm (the
    JAX `backbone_fwd` with remat off)."""
    for blocks in params["mamba"]:
        for mp in blocks:
            x = M.mamba_fwd(mp, x, cfg)
        x, _ = _shared_attn_fwd(params["shared_attn"], x, positions, cfg, window)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params, batch, cfg: ModelConfig):
    """Not ported yet: the hybrid's loss needs a backward of the SSD scan
    kernel on the card and the mamba2 block under remat."""
    raise NotImplementedError(
        f"{cfg.name}: the hybrid's lm_loss is not ported yet (ROADMAP.md, Queue 1, "
        "item 3: hybrid training)")


# ----------------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: Optional[int] = None, *, device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    nb, k_per = _nb(cfg), cfg.hybrid.attn_every
    W = min(window, max_len) if window else max_len
    shape = (nb, batch, W, cfg.n_kv_heads, cfg.resolved_head_dim)
    conv, ssm = M.init_mamba_state(cfg, batch, device=dev)
    return {
        "k": torch.zeros(shape, dtype=param_dtype(cfg), device=dev),
        "v": torch.zeros(shape, dtype=param_dtype(cfg), device=dev),
        "conv": conv.expand(nb, k_per, *conv.shape).contiguous(),
        "ssm": ssm.expand(nb, k_per, *ssm.shape).contiguous(),
    }


def lm_prefill(params, batch, cfg: ModelConfig, *, window: Optional[int] = None):
    """Full forward that also materializes the decode-ready cache: the KV of
    every application of the shared block (length T) and the conv and SSM
    states at position T of every mamba2 block. Returns (last-token logits
    (B, 1, V), cache)."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    x = L.embed(params["embed"], tokens)
    ks, vs, convs, ssms = [], [], [], []
    for blocks in params["mamba"]:
        conv_sb, ssm_sb = [], []
        for mp in blocks:
            x, (conv, ssm) = M.mamba_fwd(mp, x, cfg, return_state=True)
            conv_sb.append(conv)
            ssm_sb.append(ssm)
        x, (k, v) = _shared_attn_fwd(params["shared_attn"], x, positions, cfg, window)
        ks.append(k)
        vs.append(v)
        convs.append(torch.stack(conv_sb))
        ssms.append(torch.stack(ssm_sb))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg.vocab_size)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "conv": torch.stack(convs), "ssm": torch.stack(ssms)}


def lm_decode_step(params, cache, batch, cfg: ModelConfig):
    """One-token decode. batch: {"tokens": (B, 1), "positions": (B,)}.
    Returns (logits (B, 1, V), cache), the cache being the same dictionary,
    updated in place. Attention reads the rolling cache: this token's k/v go
    to slot pos % W and the first min(pos + 1, W) slots are attended. (The
    JAX step also takes `window` and never reads it: the cache length W is
    the window.)"""
    tokens, pos = batch["tokens"], batch["positions"]
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens)
    sp = params["shared_attn"]
    hd = cfg.resolved_head_dim
    W = cache["k"].shape[2]
    slot = (pos % W).to(torch.long)
    valid = torch.clamp(pos + 1, max=W).to(torch.int32)
    bidx = torch.arange(B, device=tokens.device)
    for a, blocks in enumerate(params["mamba"]):
        for j, mp in enumerate(blocks):
            x, (conv, ssm) = M.mamba_decode(mp, x, (cache["conv"][a, j], cache["ssm"][a, j]),
                                            cfg)
            cache["conv"][a, j] = conv
            cache["ssm"][a, j] = ssm

        xn = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
        q = (xn @ sp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, hd)
        k = (xn @ sp["attn"]["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
        v = (xn @ sp["attn"]["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
        q = L.rope(q, pos[:, None], cfg.rope_theta)
        k = L.rope(k, pos[:, None], cfg.rope_theta)
        ck, cv = cache["k"][a], cache["v"][a]
        ck[bidx, slot] = k[:, 0].to(ck.dtype)
        cv[bidx, slot] = v[:, 0].to(cv.dtype)
        # the (B, W, H, hd) slice read as (B, H, W, hd) in place
        o = ops.decode_attention(q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2), valid)
        x = x + o.reshape(B, 1, cfg.n_heads * hd) @ sp["attn"]["wo"]
        x = _shared_ffn(sp, x, cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg.vocab_size), cache
