"""Mixture-of-Experts FFN with static-shape, sort-based token dispatch.

The port of the JAX package's `models/moe.py`: tokens are processed in G
groups; in each group every (token, k) choice is sorted by expert and gets a
slot up to the capacity C, and choices over capacity are dropped (they pass
through the residual only). On one card the expert-parallel all-to-all is
the identity, but the group-major (G, E, C, d) and expert-major (E, G, C, d)
shapes are kept so the two packages can be compared step by step. The three
expert products go through `kernels/ops.py::moe_gmm` on the (E, G*C, d) view
of the expert-major tensor: the CUDA kernel on the card, the plain version
on the CPU (the JAX model computes them with `jnp.einsum`). Under autograd
they go through `GroupedMatmul`, whose backward is the two grouped products
`ops.moe_gmm_dx` and `ops.moe_gmm_dw`; the router, the gates, the dispatch,
the combine and the aux loss are differentiated by plain autograd. The
router runs in fp32.

Under data parallelism (`group`, a process group whose ranks each hold a
contiguous share of the global tokens, as the reference's groups line up
with its data shards) the Switch aux loss is the global one: its mean
router probabilities and mean assignments are averaged over the group
before their product, the probabilities through a differentiable all-reduce.

Under expert parallelism (`dp`, a `data_parallel.DataParallel` whose
`ep_group` splits the experts over the "data" axis) the rank holds E/n
experts: the group-major slots of its groups go to the experts' ranks and
come back through the all-to-all of the reference's transposes
(`DataParallel.to_experts`, `.to_groups`), and the expert products run on
the rank's experts over every rank's groups.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import distributed as D
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding.axes import constrain

F32 = torch.float32


class GroupedMatmul(torch.autograd.Function):
    """x (E, C, d) @ w (E, d, f) -> (E, C, f) with its gradient: the forward
    is `ops.moe_gmm` (the kernel on the card), the backward the two grouped
    products dx = dy w^T (`ops.moe_gmm_dx`) and dw = x^T dy
    (`ops.moe_gmm_dw`), each only where autograd asks for it. They are what
    autodiff of the JAX model's einsum computes, summed in fp32 and returned
    in the inputs' dtype. Autograd runs both methods with grad off, so the
    CUDA ops' grad guard passes; a double backward would make it raise."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return ops.moe_gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        # autograd may hand over an expanded (stride-0) or transposed
        # gradient, which TMA cannot read: the kernels want it contiguous
        dy = dy.contiguous()
        dx = ops.moe_gmm_dx(dy, w) if ctx.needs_input_grad[0] else None
        dw = ops.moe_gmm_dw(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def grouped_matmul(x, w):
    """The expert product: through `GroupedMatmul` when autograd records (a
    training step), else `ops.moe_gmm` directly (serving)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w)
    return ops.moe_gmm(x, w)


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


def _dispatch_one_group(x, logits, top_k: int, cap: int, top_e=None):
    """Sort-based dispatch for one token group. x: (N, d), logits: (N, E) ->
    (slots (E*C, d), slot of each (token, k) or the dump row E*C, gates of the
    top k renormalised (N, k), all gates (N, E)). `top_e` (N, k), if given,
    names the experts to take instead of the top k of these gates (to replay
    one run's routing in another: chip_smoke.py's MoE gradient gate)."""
    n, e = logits.shape
    dev = x.device
    gates = torch.softmax(logits.to(F32), dim=-1)
    if top_e is None:
        top_g, top_e = torch.topk(gates, top_k, dim=-1)
    else:
        top_g = torch.gather(gates, -1, top_e)
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


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, n_groups: int = 1,
            group=None, tp=None, dp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (y: (B, T, d), Switch-style aux loss, a scalar). The
    B*T tokens are dispatched in `n_groups` contiguous groups; under a
    data-parallel `group` the aux loss's means are the group's (every rank
    holding as many tokens).

    Under tensor parallelism (`tp`, expert-TP: every rank holds every
    expert, with its columns of d_ff in w1/w3 and its rows in w2, and its
    block of arctic's dense residual) the router and the dispatch run on
    the replicated x, alike on every rank; the combine is linear in the
    expert outputs, so the rank combines its partial sums and y is summed
    over the ranks once, after the dense residual's (the reference
    constrains out_e, which lays the same sum on the expert outputs). Under
    autograd the expert products' input and the gates the combine reads
    enter through `tp.enter`, whose backward sums the ranks' partial
    gradients; the router's own input, and the aux loss, are whole.

    Under expert parallelism (`dp` with an `ep_group`) the rank's E/n
    experts (`p["w1"]` etc. are its blocks) take their slots of every
    rank's groups through the all-to-all and give them back after the
    expert products; the combine, the psum over "model" and the aux loss
    are as above."""
    m = cfg.moe
    B, T, d = x.shape
    e, k = m.n_experts, m.top_k
    N = B * T
    if N % n_groups:
        raise ValueError(f"{N} tokens do not split into {n_groups} groups")
    ng = N // n_groups
    cap = capacity(cfg, ng)

    xg = constrain(x.reshape(n_groups, ng, d), "batch", None, None)
    logits = xg.to(F32) @ p["router"]
    # the experts' columns and the dense residual's give partial gradients of
    # x: it enters them once
    split = tp is not None and tp.splits(cfg.d_ff)
    dsplit = tp is not None and "dense" in p and tp.splits(m.dense_residual_ff)
    xin = tp.enter(x) if split or dsplit else x
    xs = xin.reshape(n_groups, ng, d) if split else xg
    groups = [_dispatch_one_group(xs[g], logits[g], k, cap) for g in range(n_groups)]
    slots, inv, top_g, gates = (torch.stack(t) for t in zip(*groups))

    # group-major (G, E, C, d) -> expert-major (E, G, C, d), seen as (E, G*C, d);
    # under EP the rank's experts over every rank's groups, (E/n, n G, C, d)
    xd = constrain(slots.reshape(n_groups, e, cap, d), "batch", None, None, None)
    ep = dp is not None and dp.ep_group is not None
    if ep:
        xe = dp.to_experts(xd)
    else:
        xe = constrain(xd.transpose(0, 1), "expert", "ep_batch", None, None)
    el, ge = xe.shape[:2]
    xe = xe.reshape(el, ge * cap, d)
    h1 = grouped_matmul(xe, p["w1"])
    h3 = grouped_matmul(xe, p["w3"])
    h = torch.nn.functional.silu(h1.to(F32)).to(h1.dtype) * h3
    out_e = grouped_matmul(h, p["w2"]).reshape(el, ge, cap, d)
    if ep:
        out_g = dp.to_groups(out_e).reshape(n_groups, e * cap, d)
    else:
        out_e = constrain(out_e, "expert", "ep_batch", None, None)
        out_g = constrain(out_e.transpose(0, 1).reshape(n_groups, e * cap, d),
                          "batch", None, None)

    # combine: gather each (token, k) slot row, weight by its gate
    pad = torch.cat([out_g, out_g.new_zeros((n_groups, 1, d))], dim=1)
    picked = torch.gather(pad, 1, inv[..., None].expand(-1, -1, d))
    picked = picked.reshape(n_groups, ng, k, d)
    # under expert-TP `picked` is the rank's partial sum, so the combine's
    # gradient of the gates is too: summed over the ranks here (B T k
    # entries), not in the router's gradient, whose aux-loss part is whole
    gate = tp.enter(top_g) if split else top_g
    y = torch.sum(picked * gate[..., None].to(picked.dtype), dim=2).reshape(B, T, d)

    # load-balancing aux loss (Switch-style)
    me = gates.mean(dim=(0, 1))                           # mean router prob per expert
    # one-hot as a comparison: F.one_hot takes other ops on each device
    # (a range check that reads the values back on the CPU), and the
    # dry-run's account must see the card's ops on the meta device
    experts = torch.arange(e, device=gates.device)
    ce = (gates.argmax(-1)[..., None] == experts).to(F32).mean(dim=(0, 1))
    if group is not None:
        n = torch.distributed.get_world_size(group)
        me = D.all_reduce_sum(me, group) / n
        ce = D.all_reduce_(ce, group=group) / n
    aux = e * torch.sum(me * ce) * m.aux_loss_weight

    dense = None
    if "dense" in p:
        pd = p["dense"]
        dense = L.swiglu(xin if dsplit else x, pd["w1"], pd["w3"], pd["w2"])
    if tp is not None:
        y = tp.psum((y, tp.splits(cfg.d_ff)),
                    *([(dense, tp.splits(m.dense_residual_ff))] if dense is not None else []))
    elif dense is not None:
        y = y + dense
    return constrain(y, "batch", None, None), aux
