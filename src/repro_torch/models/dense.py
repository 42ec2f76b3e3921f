"""Dense (llama-family) decoder LM, the same block with an MoE FFN (family
"moe"), and the VLM (family "vlm": the dense LM whose first n_patches
token embeddings a stub frontend's patch embeddings replace): the training
loss (`lm_loss`, with remat), prefill, one-token decode against a KV cache,
and the full forward that the decode path is checked against.

The port of the JAX package's `models/dense.py`. Parameters are plain
dictionaries of tensors with the JAX pytree's keys; `params["layers"]` is a
list with one dictionary per layer where JAX stacks them on a leading axis.
The cache keeps the JAX layout, (L, B, S, Hc, D) per buffer plus fp32
(L, B, S, Hc, 1) scales for an int8 cache, and is updated in place one layer
at a time where JAX threads it through the scan carry. Attention goes through
`kernels/ops.py`: the CUDA kernels on the card, the plain versions on the
CPU; so does the MoE FFN's expert matmul (`models/moe.py`). Under autograd,
attention goes through the flash backward (`models/flash_vjp.py`) and the
expert matmul through `moe.GroupedMatmul`.

Serving runs tensor-parallel too (`tp`, `tensor_parallel.py`): each rank
holds its blocks of the weights (`init_params(..., mesh=, rank=)`) and its
heads of the cache, and the prefill and decode step sum and gather over the
"model" axis where the reference's sharding constraints stand. Under FSDP
and expert parallelism (`dp`, `data_parallel.py`) the blocks are cut over
the data axes too: each layer gathers its FSDP leaves before use, the
embeddings gather theirs before the lookup and the logits, and the MoE FFN
sends its slots to the rank's experts and back.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.data_parallel import gather
from repro_torch.models.moe import init_moe_layer, moe_ffn
from repro_torch.sharding.axes import constrain, rules_for
from repro_torch.sharding.rules import model_shardings

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
                device="cuda", mesh=None, rank: int = 0) -> Dict[str, Any]:
    """Random weights drawn from `generator`, which must live on `device`:
    normal(0, d_model**-0.5) projections, normal(0, 0.02) embeddings and
    unit norms, as the JAX init draws them (from another stream).

    With a `mesh`, rank `rank`'s blocks of them: its block of every leaf
    under the guarded param specs (`sharding/rules.py::model_shardings`;
    over "model", and over the data axes for FSDP and the experts). Each
    leaf is drawn whole, in the same order, and all but the rank's block
    freed a layer at a time, so the blocks are bit for bit those of the
    whole draw and the peak is one layer, not the model."""
    dev = resolve_device(device)
    dtype = param_dtype(cfg)
    keep = _block_keeper(cfg, mesh, rank)
    return {
        "embed": keep(("embed",), L.init_embedding(
            generator, cfg.vocab_size, cfg.d_model, dtype, cfg.tie_embeddings,
            cfg.padded_vocab, device=dev)),
        "layers": [keep(("layers", i), init_block(generator, cfg, dtype, dev))
                   for i in range(cfg.n_layers)],
        "final_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
    }


def _block_keeper(cfg: ModelConfig, mesh, rank: int, init=None):
    """keep(prefix, subtree) -> the subtree's leaves cut to rank `rank`'s
    blocks under the param specs of `mesh`; the identity without a mesh.
    `init` draws the family's whole params (this module's by default)."""
    if mesh is None:
        return lambda prefix, tree: tree
    whole = (init or init_params)(torch.Generator(), cfg, device="meta")
    sh = model_shardings(whole, cfg, mesh, rules_for(mesh))
    return lambda prefix, tree: sh.take(tree, rank, prefix)


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------

def _ffn(p, xn, cfg: ModelConfig, n_groups: int = 1, group=None, tp=None, dp=None):
    """The block's FFN on normed x: (y, the MoE aux loss, or None for a dense
    FFN, which has none). `n_groups`, `group` and `dp`: see moe.moe_ffn.
    Under tensor parallelism (`tp`) y is summed over the ranks: the
    counterpart of the reference's constraint on the block's output."""
    if cfg.family == "moe":
        return moe_ffn(p["moe"], xn, cfg, n_groups, group, tp=tp, dp=dp)
    split = tp is not None and tp.splits(cfg.d_ff)
    y = L.swiglu(tp.enter(xn) if split else xn, p["mlp"]["w1"], p["mlp"]["w3"], p["mlp"]["w2"])
    if tp is not None:
        y = constrain(tp.psum((y, split)), "batch", "seq", None)
    return y, None


def block_fwd(p, x, positions, cfg: ModelConfig, *, window: Optional[int] = None,
              n_groups: int = 1, group=None, tp=None, dp=None):
    """Full-sequence block: causal attention + FFN. Returns (x, aux), aux
    None for a dense block. Under tensor parallelism (`tp`) on the rank's
    blocks, its collectives differentiable (tensor_parallel.py); under `dp`
    its FSDP leaves gathered first (data_parallel.py)."""
    p = gather(dp, p, ("layers",))
    h, _ = L.attention(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                       positions, cfg, causal=True, window=window, tp=tp)
    x = x + h
    y, aux = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg, n_groups, group, tp=tp, dp=dp)
    return x + y, aux


def backbone_fwd(params, x, positions, cfg: ModelConfig, *,
                 window: Optional[int] = None, remat: bool = True,
                 n_groups: int = 1, group=None, tp=None, dp=None):
    """The block stack over x (B, T, d) without a cache, then the final norm.
    Returns (x, summed aux). With `remat` (the JAX default) and autograd
    recording, each block keeps only its input for the backward and runs
    again there (`jax.checkpoint` of the JAX scan body); without autograd
    there is nothing to keep, and the blocks run plainly. Under `tp` the
    replay runs the block's forward collectives again, in the same order on
    every rank (the ranks run in lockstep); it stops at the last tensor the
    backward needs, so a block's last all-reduce is not replayed. Under
    `dp` the replay gathers the block's FSDP leaves again, and runs the
    experts' all-to-all both ways again."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    for lp in params["layers"]:
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(block_fwd, lp, x, positions, cfg, window=window,
                              n_groups=n_groups, group=group, tp=tp, dp=dp,
                              use_reentrant=False)
        else:
            x, a = block_fwd(lp, x, positions, cfg, window=window, n_groups=n_groups,
                             group=group, tp=tp, dp=dp)
        if a is not None:
            aux = aux + a
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def lm_loss(params, batch, cfg: ModelConfig, *, remat: bool = True, n_groups: int = 1,
            group=None, tp=None, dp=None):
    """Next-token loss of batch {"tokens", "targets"} (B, T) [+ "loss_mask",
    the VLM's "patch_embeds"]: embed, the VLM's patches, the block stack,
    unembed with the padded vocab masked, the fp32 cross entropy. Returns (xent + aux, {"xent", "aux"}), as the JAX
    `lm_loss`. Under a data-parallel `group` (each rank's batch a share of
    the global one) the MoE aux loss and a masked mean are global: see
    moe.moe_ffn and layers.softmax_xent. Under tensor parallelism (`tp`)
    the rank's blocks compute the whole model's loss, alike on every rank of
    the "model" group, its vocab-parallel part without gathering the logits.
    Under FSDP and expert parallelism (`dp`) the rank's blocks over the
    data axes are gathered where they are used (data_parallel.py)."""
    tokens, targets = batch["tokens"], batch["targets"]
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    x = _inject_frontend(batch, L.embed(_embedding(params, "tok", dp), tokens, tp), cfg)
    x, aux = backbone_fwd(params, x, positions, cfg, remat=remat, n_groups=n_groups,
                          group=group, tp=tp, dp=dp)
    logits = L.unembed(_embedding(params, "out", dp), x, cfg.vocab_size, tp, gather=False)
    loss = L.softmax_xent(logits, targets, batch.get("loss_mask"), group, tp)
    return loss + aux, {"xent": loss, "aux": aux}


def _embedding(params, use: str, dp=None):
    """The embeddings with the table that `use` ("tok", the lookup; "out",
    the logits: the untied output table, else the tied one) gathered over
    the data axes that cut its d_model (FSDP)."""
    emb = params["embed"]
    name = "out" if use == "out" and "out" in emb else "tok"
    if dp is None:
        return emb
    return {**emb, name: dp.gather_leaf(emb[name], ("embed", name))}


def _inject_frontend(batch, x, cfg: ModelConfig):
    """The VLM's stub frontend: precomputed patch embeddings
    batch["patch_embeds"] (B, n_patches, d) replace the first n_patches
    token embeddings of x (B, T, d). Other families, and a VLM batch without
    patches (text only), keep x."""
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


# ----------------------------------------------------------------------------
# KV cache + serving
# ----------------------------------------------------------------------------

def kv_cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.int8 if cfg.kv_cache_dtype == "int8" else param_dtype(cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda", tp=None) -> Dict[str, torch.Tensor]:
    """Zeros of the cache; under tensor parallelism (`tp`) of the rank's
    cache heads."""
    dev = resolve_device(device)
    heads = cfg.cache_kv_heads if tp is None else tp.cache_heads
    shape = (cfg.n_layers, batch, max_len, heads, cfg.resolved_head_dim)
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


def _replicate_kv(cfg: ModelConfig, k, v, tp=None):
    """Repeat each kv head kv_replication times in place along the head
    axis (jnp.repeat), so the cache holds cache_kv_heads heads; under
    tensor parallelism (`tp`) the rank's cache heads of them."""
    if cfg.kv_replication > 1:
        k = torch.repeat_interleave(k, cfg.kv_replication, dim=2)
        v = torch.repeat_interleave(v, cfg.kv_replication, dim=2)
    if tp is not None and tp.store_heads is not None:
        k, v = k[:, :, tp.store_heads], v[:, :, tp.store_heads]
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


def block_decode(p, x, cache, li: int, pos, cfg: ModelConfig, n_groups: int = 1, tp=None,
                 dp=None):
    """One decode step through layer li. x: (B, 1, d); pos: (B,) int32, the
    current length of each sequence. Updates the cache in place."""
    p = gather(dp, p, ("layers",))
    B, T, _ = x.shape
    xn = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    positions = pos[:, None] + torch.arange(T, device=x.device, dtype=pos.dtype)[None, :]
    q, k, v = L.qkv(p["attn"], xn, positions, cfg, tp)
    k, v = _replicate_kv(cfg, k, v, tp)
    _store_kv(cfg, cache, li, k, v, pos)
    heads = None if tp is None else tp.read_heads
    out = _decode_attend(q, cache, li, (pos + T).to(torch.int32), heads)
    x = x + L.attn_out(p["attn"], out.reshape(B, T, -1), tp)
    y, _ = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg, n_groups, tp=tp, dp=dp)
    return x + y


def _decode_attend(q, cache, li: int, valid, heads: Optional[slice] = None):
    """Attention of q (B, 1, Hq, hd) over layer li's cache, read in place as
    the (B, Hc, S, hd) view of its (B, S, Hc, hd) slice, or of its `heads`."""
    def view(name):
        if name not in cache:
            return None
        layer = cache[name][li]
        return (layer if heads is None else layer[:, :, heads]).transpose(1, 2)
    return ops.decode_attention(q[:, 0], view("k"), view("v"), valid,
                                view("k_scale"), view("v_scale"))


def lm_decode_step(params, cache, batch, cfg: ModelConfig, *, n_groups: int = 1, tp=None,
                   dp=None):
    """One-token decode across the whole stack. batch: {"tokens": (B, 1),
    "positions": (B,)}. Returns (logits (B, 1, V), cache), the cache being
    the same dictionary, updated in place. Under tensor parallelism (`tp`)
    the rank's blocks and cache heads, and the logits of every rank; under
    `dp` the rank's rows, its FSDP leaves gathered where they are used.

    Like the JAX decode step this attends over the whole valid prefix; the
    JAX step passes `window` without a query offset, so it never masks."""
    tokens, pos = batch["tokens"], batch["positions"]
    x = L.embed(_embedding(params, "tok", dp), tokens, tp)
    for li, lp in enumerate(params["layers"]):
        x = block_decode(lp, x, cache, li, pos, cfg, n_groups, tp, dp)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(_embedding(params, "out", dp), x, cfg.vocab_size, tp), cache


def lm_prefill(params, batch, cfg: ModelConfig, *, window: Optional[int] = None,
               n_groups: int = 1, tp=None, dp=None):
    """Full forward of batch {"tokens" (B, T)} [+ the VLM's "patch_embeds"
    (B, n_patches, d)] that also materializes the KV cache.

    Returns (last-token logits (B, 1, V), cache) with cache buffers of
    length T: (L, B, T, Hc, D) [+ int8 scales]; under tensor parallelism
    (`tp`) of the rank's cache heads."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    x = _inject_frontend(batch, L.embed(_embedding(params, "tok", dp), tokens, tp), cfg)
    kvs: Dict[str, List[torch.Tensor]] = {}
    for lp in params["layers"]:
        lp = gather(dp, lp, ("layers",))
        xn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        h, (k, v) = L.attention(lp["attn"], xn, positions, cfg, causal=True,
                                window=window, tp=tp)
        x = x + h
        y, _ = _ffn(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg, n_groups, tp=tp, dp=dp)
        x = x + y
        k, v = _replicate_kv(cfg, k, v, tp)
        if cfg.kv_cache_dtype == "int8":
            (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
            kvs.setdefault("k_scale", []).append(ks)
            kvs.setdefault("v_scale", []).append(vs)
        kvs.setdefault("k", []).append(k)
        kvs.setdefault("v", []).append(v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(_embedding(params, "out", dp), x[:, -1:, :], cfg.vocab_size, tp)
    return logits, {name: torch.stack(bufs) for name, bufs in kvs.items()}
