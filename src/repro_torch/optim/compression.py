"""Quantized ring all-reduce with error feedback (gradient compression), the
port of the JAX package's `optim/compression.py`.

A real wire-compression scheme: the ring reduce-scatter and all-gather move
int8 chunks (+ one fp32 scale per chunk) between neighbours, one
`batch_isend_irecv` a hop to rank (r+1) mod n and from (r-1) mod n, so each
hop carries ~1/2 of the bf16 bytes (~1/4 of fp32's). Accumulation happens in
fp32 after dequantization at every hop; the residual between the true local
gradient and its quantized representation is fed back into the next step
(error feedback). The fp32 operations are the reference's, in its order, so
the results match it to rounding. A hop's payload is one byte buffer: the
scale's four bytes (in the all-gather the chunk's id, four more), then the
int8 codes, so each hop is one message each way. Under gloo a card's
payload goes through host memory (`distributed.transport` names the route);
quantizing and dequantizing stay on the rank's device.

Usage on every rank of a group:
    g_avg, new_err = compressed_psum_mean(g, err, group)
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch.tree import leaves, unflatten_like

F32 = torch.float32


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a correctly rounded division on every device: CUDA divides
    by a Python number as a product with its rounded reciprocal, which moves
    a scale by an ulp and can flip a code, so the divisor sits on x's
    device."""
    return x / torch.tensor(c, dtype=F32, device=x.device)


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of x and their fp32 scale; torch.round rounds
    half to even, as jnp.round does."""
    amax = torch.amax(torch.abs(x))
    scale = _div(torch.clamp_min(amax, 1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def _pack(q, scale, chunk_id=None) -> torch.Tensor:
    head = [scale.reshape(1).view(torch.uint8)]
    if chunk_id is not None:
        head.append(chunk_id.reshape(1).view(torch.uint8))
    return torch.cat(head + [q.view(torch.uint8)])


def _unpack(buf, with_id: bool = False):
    scale = buf[:4].view(F32)[0]
    if not with_id:
        return buf[4:].view(torch.int8), scale
    return buf[8:].view(torch.int8), scale, buf[4:8].view(torch.int32)[0]


def compressed_psum_mean(g: torch.Tensor, err: torch.Tensor, group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce `g` over `group` (the default group if None) with int8
    ring collectives. Called on every rank of the group with its own `g` and
    residual `err`. Returns (mean gradient, new error-feedback residual). g is
    flattened internally; the group's size must divide g.numel()."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    flat = (g.to(F32) + err.to(F32)).reshape(-1)
    if flat.numel() % n:
        raise ValueError(f"{flat.numel()} entries do not split into {n} chunks")
    chunks = flat.reshape(n, -1)
    m = chunks.shape[1]
    recv = torch.empty(m + 4, dtype=torch.uint8, device=g.device)

    # ---- ring reduce-scatter: at hop s a rank adds its chunk (idx - s) mod n
    # to what its neighbour sent; after n-1 hops it owns the full sum of
    # chunk (idx + 1) mod n
    q, sc = _quant(chunks[idx])
    for s in range(1, n):
        rq, rs = _unpack(D.shift(_pack(q, sc), recv, group))
        partial_sum = _dequant(rq, rs) + chunks[(idx - s) % n]
        q, sc = _quant(partial_sum)
    owned_id = (idx - (n - 1)) % n

    # ---- ring all-gather of the quantized owned chunks, with their ids
    gathered_q = torch.zeros((n, m), dtype=torch.int8, device=g.device)
    gathered_s = torch.zeros((n,), dtype=F32, device=g.device)
    gathered_q[owned_id] = q
    gathered_s[owned_id] = sc
    send = _pack(q, sc, torch.tensor(owned_id, dtype=torch.int32, device=g.device))
    recv = torch.empty(m + 8, dtype=torch.uint8, device=g.device)
    for _ in range(n - 1):
        send, recv = D.shift(send, recv, group), send
        rq, rs, rid = _unpack(send, with_id=True)
        gathered_q[rid] = rq
        gathered_s[rid] = rs

    total = _dequant(gathered_q, gathered_s[:, None]).reshape(flat.shape)
    mean = _div(total, n).reshape(g.shape).to(g.dtype)

    # ---- error feedback: what the ring carried for our local data is
    # (approximately) the quantization of (g + err); the residual re-enters
    # next step
    q_local, s_local = _quant(flat)
    new_err = (flat - _dequant(q_local, s_local)).reshape(g.shape).to(F32)
    return mean, new_err


def make_compressed_grad_reduce(mesh, axis_name: str):
    """reduce_tree(grads, errs) -> (mean grads, new errs): every leaf of the
    rank's gradient tree mean-reduced over the mesh's `axis_name` group."""
    group = mesh.group(axis_name)

    def reduce_tree(grads, errs):
        out = [compressed_psum_mean(g, e, group) for g, e in zip(leaves(grads), leaves(errs))]
        return (unflatten_like(grads, [o[0] for o in out]),
                unflatten_like(grads, [o[1] for o in out]))

    return reduce_tree
