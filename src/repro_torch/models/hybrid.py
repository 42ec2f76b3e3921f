"""zamba2-style hybrid model: a mamba2 backbone with one *shared* attention
+ FFN block applied after every `attn_every` mamba2 blocks. Training
(`lm_loss`), prefill and decode.

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
via `kernels/ops.py`. The loss differentiates attention through
`flash_vjp.FlashAttention` and the scan through `mamba2.SSDScan`, and
recomputes each super-block in the backward (remat), as the JAX
`backbone_fwd` checkpoints its scan body.

The hybrid is driven through this model interface, not through `ServeEngine`:
the engine's cache scatter, copied from the JAX engine, knows only caches
whose axis 1 is the batch slot.

Under tensor parallelism (`tp`, `tensor_parallel.py`) each rank holds its
blocks of the weights (`init_params(..., mesh=, rank=)`): the mamba2
blocks run on the rank's SSM heads (`mamba2.py`), the shared block's
attention on its heads and its FFN on its d_ff columns as the dense
block's do, the embeddings on its vocab rows. Its cache holds its k/v
cache heads, its heads' SSM state and the whole conv buffer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import dense
from repro_torch.models import mamba2 as M
from repro_torch.models.dense import param_dtype


def _nb(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.hybrid.attn_every:
        raise ValueError(f"{cfg.n_layers} layers are not a multiple of "
                         f"attn_every={cfg.hybrid.attn_every}")
    return cfg.n_layers // cfg.hybrid.attn_every


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda", mesh=None, rank: int = 0) -> Dict[str, Any]:
    """Random weights drawn from `generator`, which must live on `device`,
    with the JAX init's distributions (from another stream). With a `mesh`,
    rank `rank`'s blocks of them, each leaf drawn whole in the same order
    and cut a block at a time, as `dense.init_params` cuts them."""
    dev = resolve_device(device)
    dtype = param_dtype(cfg)
    std = cfg.d_model ** -0.5
    keep = dense._block_keeper(cfg, mesh, rank, init_params)
    return {
        "embed": keep(("embed",), L.init_embedding(
            generator, cfg.vocab_size, cfg.d_model, dtype, cfg.tie_embeddings,
            cfg.padded_vocab, device=dev)),
        "mamba": [[keep(("mamba", i, j), M.init_mamba_block(generator, cfg, dtype, dev))
                   for j in range(cfg.hybrid.attn_every)] for i in range(_nb(cfg))],
        "shared_attn": keep(("shared_attn",), {
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
        }),
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }


def _shared_ffn(sp, x, cfg: ModelConfig, tp=None):
    y, _ = dense._ffn(sp, L.rms_norm(x, sp["ln2"], cfg.norm_eps), cfg, tp=tp)
    return x + y


def _shared_attn_fwd(sp, x, positions, cfg: ModelConfig, window, tp=None):
    h, kv = L.attention(sp["attn"], L.rms_norm(x, sp["ln1"], cfg.norm_eps),
                        positions, cfg, causal=True, window=window, tp=tp)
    return _shared_ffn(sp, x + h, cfg, tp), kv


def _super_block(blocks, sp, x, positions, cfg: ModelConfig, window, tp=None):
    """attn_every mamba2 blocks, then the shared block: the JAX scan body."""
    for mp in blocks:
        x = M.mamba_fwd(mp, x, cfg, tp=tp)
    x, _ = _shared_attn_fwd(sp, x, positions, cfg, window, tp)
    return x


def backbone_fwd(params, x, positions, cfg: ModelConfig, *,
                 window: Optional[int] = None, remat: bool = True, tp=None):
    """The stack over x (B, T, d) without a cache, then the final norm. With
    `remat` (the JAX default) and autograd recording, each super-block keeps
    only its input for the backward and runs again there (`jax.checkpoint`
    of the JAX scan body, `hybrid.py:68-86` of the reference): the scan and
    attention kernels launch twice per super-block. Without autograd there
    is nothing to keep, and the super-blocks run plainly. Under `tp` the
    replay runs the super-block's forward collectives again, up to the last
    tensor the backward needs (the shared FFN's all-reduce is not
    replayed)."""
    sp = params["shared_attn"]
    for blocks in params["mamba"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_super_block, blocks, sp, x, positions, cfg, window, tp,
                           use_reentrant=False)
        else:
            x = _super_block(blocks, sp, x, positions, cfg, window, tp)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True, group=None, tp=None):
    """Next-token loss of batch {"tokens", "targets"} (B, T) [+ "loss_mask"]:
    embed, the stack, unembed with the padded vocab masked, the fp32 cross
    entropy. Returns (xent, {"xent": xent}), as the JAX `lm_loss` (the
    hybrid has no aux loss). `group`: the data-parallel group, as
    `dense.lm_loss` takes it; under `tp` the rank's blocks compute the whole
    model's loss, its vocab-parallel part without gathering the logits."""
    tokens, targets = batch["tokens"], batch["targets"]
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    x = L.embed(params["embed"], tokens, tp)
    x = backbone_fwd(params, x, positions, cfg, remat=remat, tp=tp)
    logits = L.unembed(params["embed"], x, cfg.vocab_size, tp, gather=False)
    loss = L.softmax_xent(logits, targets, batch.get("loss_mask"), group, tp)
    return loss, {"xent": loss}


# ----------------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: Optional[int] = None, *, device="cuda", tp=None) -> Dict[str, torch.Tensor]:
    """Zeros of the cache; under tensor parallelism (`tp`) of the rank's
    cache heads and SSM heads, with the whole conv buffer."""
    dev = resolve_device(device)
    nb, k_per = _nb(cfg), cfg.hybrid.attn_every
    W = min(window, max_len) if window else max_len
    heads = cfg.n_kv_heads if tp is None else tp.cache_heads
    shape = (nb, batch, W, heads, cfg.resolved_head_dim)
    conv, ssm = M.init_mamba_state(cfg, batch, device=dev, tp=tp)
    return {
        "k": torch.zeros(shape, dtype=param_dtype(cfg), device=dev),
        "v": torch.zeros(shape, dtype=param_dtype(cfg), device=dev),
        "conv": conv.expand(nb, k_per, *conv.shape).contiguous(),
        "ssm": ssm.expand(nb, k_per, *ssm.shape).contiguous(),
    }


def lm_prefill(params, batch, cfg: ModelConfig, *, window: Optional[int] = None, tp=None):
    """Full forward that also materializes the decode-ready cache: the KV of
    every application of the shared block (length T) and the conv and SSM
    states at position T of every mamba2 block. Returns (last-token logits
    (B, 1, V), cache); under `tp` the cache of `init_cache(..., tp=)`."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    x = L.embed(params["embed"], tokens, tp)
    ks, vs, convs, ssms = [], [], [], []
    for blocks in params["mamba"]:
        conv_sb, ssm_sb = [], []
        for mp in blocks:
            x, (conv, ssm) = M.mamba_fwd(mp, x, cfg, return_state=True, tp=tp)
            conv_sb.append(conv)
            ssm_sb.append(ssm)
        x, (k, v) = _shared_attn_fwd(params["shared_attn"], x, positions, cfg, window, tp)
        k, v = dense._replicate_kv(cfg, k, v, tp)
        ks.append(k)
        vs.append(v)
        convs.append(torch.stack(conv_sb))
        ssms.append(torch.stack(ssm_sb))
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg.vocab_size, tp)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "conv": torch.stack(convs), "ssm": torch.stack(ssms)}


def lm_decode_step(params, cache, batch, cfg: ModelConfig, tp=None):
    """One-token decode. batch: {"tokens": (B, 1), "positions": (B,)}.
    Returns (logits (B, 1, V), cache), the cache being the same dictionary,
    updated in place. Attention reads the rolling cache: this token's k/v go
    to slot pos % W and the first min(pos + 1, W) slots are attended. (The
    JAX step also takes `window` and never reads it: the cache length W is
    the window.) Under `tp` the rank's heads, stored and read as
    `dense.block_decode` stores and reads them, wo's product summed."""
    tokens, pos = batch["tokens"], batch["positions"]
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens, tp)
    sp = params["shared_attn"]
    heads = None if tp is None else tp.read_heads
    W = cache["k"].shape[2]
    slot = (pos % W).to(torch.long)
    valid = torch.clamp(pos + 1, max=W).to(torch.int32)
    bidx = torch.arange(B, device=tokens.device)
    for a, blocks in enumerate(params["mamba"]):
        for j, mp in enumerate(blocks):
            x, (conv, ssm) = M.mamba_decode(mp, x, (cache["conv"][a, j], cache["ssm"][a, j]),
                                            cfg, tp)
            cache["conv"][a, j] = conv
            cache["ssm"][a, j] = ssm

        xn = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv(sp["attn"], xn, pos[:, None], cfg, tp)
        k, v = dense._replicate_kv(cfg, k, v, tp)
        ck, cv = cache["k"][a], cache["v"][a]
        ck[bidx, slot] = k[:, 0].to(ck.dtype)
        cv[bidx, slot] = v[:, 0].to(cv.dtype)
        if heads is not None:
            ck, cv = ck[:, :, heads], cv[:, :, heads]
        # the (B, W, H, hd) slice read as (B, H, W, hd) in place
        o = ops.decode_attention(q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2), valid)
        x = x + L.attn_out(sp["attn"], o.reshape(B, 1, -1), tp)
        x = _shared_ffn(sp, x, cfg, tp)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg.vocab_size, tp), cache
