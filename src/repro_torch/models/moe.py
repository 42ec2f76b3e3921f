"""Mixture-of-Experts FFN with static-shape, sort-based token dispatch.

The port of the JAX package's `models/moe.py`: tokens are processed in G
groups; in each group every (token, k) choice is sorted by expert and gets a
slot up to the capacity C, and choices over capacity are dropped (they pass
through the residual only). On one card the expert-parallel all-to-all is
the identity, but the group-major (G, E, C, d) and expert-major (E, G, C, d)
shapes are kept so the two packages can be compared step by step. The three
expert products go through `kernels/ops.py::moe_gmm` on the (E, G*C, d) view
of the expert-major tensor: the CUDA kernel on the card, the plain version
on the CPU (the JAX model computes them with `jnp.einsum`). The router runs
in fp32.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

F32 = torch.float32


def capacity(cfg: ModelConfig, n_tokens_per_group: int) -> int:
    """Slots per expert: the JAX expression to the same float, so the same
    integer (>= 4, a multiple of 4)."""
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens_per_group * m.top_k / m.n_experts)
    return max(4, -(-c // 4) * 4)


def init_moe_layer(generator: torch.Generator, cfg: ModelConfig, dtype,
                   device) -> Dict[str, Any]:
    """Normal(0, d_model**-0.5) router (fp32) and expert weights, as the JAX
    init draws them (from another stream)."""
    m = cfg.moe
    d, f, e = cfg.d_model, cfg.d_ff, m.n_experts
    std = d ** -0.5
    p = {"router": L.normal(generator, (d, e), std, F32, device)}
    for name, shape in (("w1", (e, d, f)), ("w3", (e, d, f)), ("w2", (e, f, d))):
        p[name] = L.normal(generator, shape, std, dtype, device)
    if m.dense_residual_ff:
        fr = m.dense_residual_ff
        p["dense"] = {name: L.normal(generator, shape, std, dtype, device)
                      for name, shape in (("w1", (d, fr)), ("w3", (d, fr)),
                                          ("w2", (fr, d)))}
    return p


def _dispatch_one_group(x, logits, top_k: int, cap: int):
    """Sort-based dispatch for one token group. x: (N, d), logits: (N, E) ->
    (slots (E*C, d), slot of each (token, k) or the dump row E*C, gates of the
    top k renormalised (N, k), all gates (N, E))."""
    n, e = logits.shape
    dev = x.device
    gates = torch.softmax(logits.to(F32), dim=-1)
    top_g, top_e = torch.topk(gates, top_k, dim=-1)
    top_g = top_g / torch.clamp_min(top_g.sum(-1, keepdim=True), 1e-9)

    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)            # slots sorted by expert
    sorted_e = flat_e[order]
    # rank of each sorted slot within its expert
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev), side="left")
    rank = torch.arange(n * top_k, device=dev) - starts[sorted_e]
    valid = rank < cap
    dest = torch.where(valid, sorted_e * cap + rank, e * cap)   # dump row at the end

    rows = x[order // top_k] * valid[:, None].to(x.dtype)
    slots = torch.zeros((e * cap + 1, x.shape[-1]), dtype=x.dtype, device=dev)
    slots = slots.index_add_(0, dest, rows)[:-1]          # (E*C, d)

    inv = torch.empty(n * top_k, dtype=torch.long, device=dev)
    inv[order] = dest
    return slots, inv, top_g, gates


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig,
            n_groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (y: (B, T, d), Switch-style aux loss, a scalar)."""
    m = cfg.moe
    B, T, d = x.shape
    e, k = m.n_experts, m.top_k
    N = B * T
    if N % n_groups:
        raise ValueError(f"{N} tokens do not split into {n_groups} groups")
    ng = N // n_groups
    cap = capacity(cfg, ng)

    xg = x.reshape(n_groups, ng, d)
    logits = xg.to(F32) @ p["router"]
    groups = [_dispatch_one_group(xg[g], logits[g], k, cap) for g in range(n_groups)]
    slots, inv, top_g, gates = (torch.stack(t) for t in zip(*groups))

    # group-major (G, E, C, d) -> expert-major (E, G, C, d), seen as (E, G*C, d)
    xe = slots.reshape(n_groups, e, cap, d).transpose(0, 1).reshape(e, n_groups * cap, d)
    h1 = ops.moe_gmm(xe, p["w1"])
    h3 = ops.moe_gmm(xe, p["w3"])
    h = torch.nn.functional.silu(h1.to(F32)).to(h1.dtype) * h3
    out_e = ops.moe_gmm(h, p["w2"])                       # (E, G*C, d)
    out_g = out_e.reshape(e, n_groups, cap, d).transpose(0, 1).reshape(n_groups, e * cap, d)

    # combine: gather each (token, k) slot row, weight by its gate
    pad = torch.cat([out_g, out_g.new_zeros((n_groups, 1, d))], dim=1)
    picked = torch.gather(pad, 1, inv[..., None].expand(-1, -1, d))
    picked = picked.reshape(n_groups, ng, k, d)
    y = torch.sum(picked * top_g[..., None].to(picked.dtype), dim=2).reshape(B, T, d)

    # load-balancing aux loss (Switch-style)
    me = gates.mean(dim=(0, 1))                           # mean router prob per expert
    ce = torch.nn.functional.one_hot(gates.argmax(-1), e).to(F32).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce) * m.aux_loss_weight

    if "dense" in p:
        dp = p["dense"]
        y = y + L.swiglu(x, dp["w1"], dp["w3"], dp["w2"])
    return y, aux
