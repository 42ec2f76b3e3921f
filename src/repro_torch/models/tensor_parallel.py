"""Tensor parallelism over the mesh's "model" axis: what a rank of the dense,
MoE, VLM, hybrid and audio models holds, and the collectives that make its
blocks compute what the whole model computes.

The reference shards by annotation: the serving specs (`sharding/rules.py`:
wq/wk/wv/w1/w3 column-parallel, wo/w2 row-parallel, the embeddings'
vocab rows and the experts' d_ff on "model") and `constrain` on q, k, v
and on the row-parallel outputs; XLA inserts the collectives. The port
runs eagerly, so each rank holds its block of every weight under the same
guarded specs (`init_params(..., mesh=, rank=)`, `bridge.shard_params`)
and the models call the collectives themselves, through a `TensorParallel`
that says, from the config alone, what the rank holds:

  * q heads: where n divides the padded q heads, the rank computes its
    Hq/n heads; else every rank computes all of them, gathering q's
    columns where n divides wq's columns though not its heads (qwen SMOKE's
    96 columns of 6 heads at n = 4).
  * k and v heads likewise. Where the q heads are split and the kv heads
    are not, the rank's q heads read only the kv heads of their own GQA
    groups (`kv_heads`; llama SMOKE's 2 kv heads at n = 4, one a rank).
  * the cache holds Hc/n heads where n divides cache_kv_heads
    (`cache_heads`, the dry-run's cache specs), else all of them. A rank
    whose k/v heads are whole stores only its block of them
    (`store_heads`); one whose cache is whole while its q heads are split
    reads its groups' heads of it (`read_heads`).
  * wo's rows are split where n divides them: the rank's product is a
    partial sum, all-reduced; where the q heads are whole but wo's rows are
    split the rank multiplies its rows' columns of the attention output
    (`out_cols`), so what is summed is each part once.
  * the FFN (w1/w3 columns, w2 rows; the experts' d_ff, arctic's dense
    residual) likewise: the block's output is a partial sum where n divides
    the width, all-reduced once at the block.
  * the embeddings' vocab rows: a masked lookup of the rank's rows,
    all-reduced; the logits of the rank's rows, masked by global vocab id,
    all-gathered into the (B, T, V) logits every caller expects.
  * the hybrid's mamba2 blocks (`ssm_heads`, where n divides the SSM heads
    H = d_in / P): w_zx's block is columns of [z | x], not the rank's
    heads' z and x (at n = 4 two ranks hold z and two x), so the product's
    columns are gathered (`gather_zx`) and the rank takes its heads' z and
    x of it; the conv's input stays whole (the recurrent conv buffer holds
    every channel). The scan runs on the rank's heads, which read every B
    and C of their groups (`ssm_groups`); w_out's row block is exactly the
    rank's heads' channels, so y @ w_out is a partial sum, all-reduced
    once. The gated RMSNorm's statistic spans every head: each rank sums
    its channels' squares and the sums are all-reduced (`shared_sum`).

Partial sums are all-reduced in fp32 and cast back, so gloo (ranks sharing
a card, through host memory) and NCCL (a card a rank) sum the same values
in the same precision. Each collective runs under a `record_function`
("tp_all_reduce", "tp_all_gather", "tp_reduce_scatter"), which a profile of
the step reads, and is counted by that name in `calls` (read by
chip_smoke.py, as data_parallel.calls is).

Training (Megatron's f and g, each a `torch.autograd.Function` over the
"model" group; every rank computes the same replicated loss, so a
replicated tensor's gradient must come out whole on every rank, and a
block's gradient exact for the block):
  * `all_reduce` (g): the sum of partial sums forward; backward the identity,
    since the gradient of a replicated output is already whole on every
    rank. At the row-parallel outputs and the masked embedding lookup.
  * `enter` (f): the identity forward; backward the sum over the ranks,
    since each rank's column-parallel products give a partial gradient of
    their replicated input. On the normed activation entering each split
    product (q/k/v, the FFN, the experts' dispatch) and on the unembed's
    input; a replicated product reads the activation as it is.
  * `all_gather` (the guard's column gathers, `gather_q`/`gather_kv`,
    `gather_zx`): every rank's columns forward; backward the sum over the
    ranks of the whole gradient, of which the rank keeps its columns (a
    reduce-scatter): the gathered heads feed a partial product (`out_cols`,
    q heads that read only their groups' kv heads, the rank's SSM heads),
    so each rank's gradient of them is partial.
  * `shared_sum`: the sum over the ranks forward and backward. A statistic
    of a split dim (the gated RMSNorm's sum of squares) that each rank then
    reads for its own part only: the rank's gradient of the sum is partial.
`enter` takes several tensors at once and sums their gradients in one
all-reduce: a mamba2 block enters its normed input, the fp32 B and C
(every head reads them), dt and the replicated leaves whose heads' part
alone the rank reads (the conv's x weights and bias, A_log, D, norm_w),
whose gradients would otherwise be right on the rank's heads and zero
elsewhere, and drift apart across the ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch import distributed as D
from repro_torch.configs.base import ModelConfig

F32 = torch.float32

# the collectives run in this process, by span name
calls = {"tp_all_reduce": 0, "tp_all_gather": 0, "tp_reduce_scatter": 0}


def _group_heads(hq: int, hk: int, n: int, r: int) -> slice:
    """The kv heads (of hk, all held) that q heads [r hq/n, (r+1) hq/n)
    read under GQA (q head i reads kv head i // (hq / hk))."""
    local, ratio = hq // n, hq // hk
    if local % ratio == 0:
        count = local // ratio
    elif ratio % local == 0:
        count = 1
    else:
        raise ValueError(f"the {local} q heads of a rank straddle the GQA groups of "
                         f"{ratio} heads: {hq} q heads over {hk} kv heads do not split "
                         f"{n} ways")
    start = r * local // ratio
    return slice(start, start + count)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """Rank `rank` of `size` in the "model" axis's process `group`, and what
    it holds of a config's model (see the module's docstring)."""
    group: Any
    rank: int
    size: int
    q_split: bool                  # the rank computes Hq/n q heads
    gather_q: bool                 # q's columns are gathered (all heads, wq split)
    gather_kv: bool                # k's and v's likewise
    kv_split: bool                 # the rank computes Hkv/n k/v heads
    kv_heads: Optional[slice]      # the kv heads its q heads read, of all of them
    cache_heads: int               # heads of its cache
    store_heads: Optional[slice]   # its block of the replicated k/v heads
    read_heads: Optional[slice]    # the cache heads its q heads read, of all of them
    out_cols: Optional[slice]      # its wo rows' columns of a whole attention output
    attn_partial: bool             # out @ wo is a partial sum
    vocab_rows: Optional[slice]    # its rows of the (padded) embeddings, or None: all
    ssm_heads: Optional[slice] = None    # the hybrid's SSM heads it computes, of H
    ssm_channels: Optional[slice] = None  # their channels of d_in (z, x, norm_w, w_out rows)
    ssm_groups: Optional[slice] = None   # the B/C groups those heads read, of G
    gather_zx: bool = False              # w_zx's columns are gathered (split, not by head)

    @classmethod
    def plan(cls, cfg: ModelConfig, group) -> "TensorParallel":
        """This process's plan in `group`, for `cfg`."""
        n, r = dist.get_world_size(group), dist.get_rank(group)
        hq, hkv, hc = cfg.eff_q_heads, cfg.eff_kv_heads, cfg.cache_kv_heads
        hd = cfg.resolved_head_dim
        q_split, kv_split, cache_split = hq % n == 0, hkv % n == 0, hc % n == 0
        rows = hq * hd
        vocab = cfg.padded_vocab
        return cls(
            group=group, rank=r, size=n,
            q_split=q_split, gather_q=not q_split and rows % n == 0,
            gather_kv=not kv_split and hkv * hd % n == 0, kv_split=kv_split,
            kv_heads=_group_heads(hq, hkv, n, r) if q_split and not kv_split else None,
            cache_heads=hc // n if cache_split else hc,
            store_heads=(slice(r * hc // n, (r + 1) * hc // n)
                         if cache_split and not kv_split else None),
            read_heads=_group_heads(hq, hc, n, r) if q_split and not cache_split else None,
            out_cols=(slice(r * rows // n, (r + 1) * rows // n)
                      if rows % n == 0 and not q_split else None),
            attn_partial=rows % n == 0,
            vocab_rows=(slice(r * vocab // n, (r + 1) * vocab // n)
                        if vocab % n == 0 else None),
            **(_ssm_plan(cfg, n, r) if cfg.family == "hybrid" else {}))

    @property
    def kv_read_partially(self) -> bool:
        """k and v are whole on every rank, from whole weights, and read
        by a partial product (the rank's q heads' groups, or the rank's
        columns of the output): their gradient is partial, so they enter
        the product through `enter`."""
        return (not self.kv_split and not self.gather_kv
                and (self.kv_heads is not None or self.out_cols is not None))

    def splits(self, dim: int) -> bool:
        """Whether the guard splits a dim of this size over the ranks."""
        return dim % self.size == 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of x, computed in fp32 and returned in
        x's dtype; under autograd its backward is the identity (g)."""
        return _Reduce.apply(x, self.group)

    def enter(self, *xs: torch.Tensor):
        """xs, replicated, as the input of column-parallel products (or of
        the rank's heads): the identity, whose backward sums the ranks'
        partial gradients, all of them in one all-reduce. One tensor given,
        one returned, else a tuple. Outside autograd, xs themselves."""
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            out = _Enter.apply(self.group, *xs)
        else:
            out = xs
        return out[0] if len(xs) == 1 else tuple(out)

    def psum(self, *parts) -> torch.Tensor:
        """The sum of `parts`, each (tensor, partial): the partial ones
        summed over the ranks in one all-reduce, the whole ones added."""
        partial = [t for t, p in parts if p]
        whole = [t for t, p in parts if not p]
        out = self.all_reduce(sum(partial[1:], partial[0])) if partial else None
        for t in whole:
            out = t if out is None else out + t
        return out

    def shared_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of x (in fp32, returned in x's dtype),
        which every rank then reads for its own part of a split dim: its
        backward sums the ranks' partial gradients too."""
        return _SharedSum.apply(x, self.group)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x, concatenated in rank order along the last dim;
        under autograd its backward is the reduce-scatter of the gradient
        (see the module's docstring)."""
        return _Gather.apply(x, self.group)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks of x (no gradient)."""
        calls["tp_all_reduce"] += 1
        with torch.profiler.record_function("tp_all_reduce"):
            return D.all_reduce_(x.detach().clone(), op=dist.ReduceOp.MAX, group=self.group)


def _ssm_plan(cfg: ModelConfig, n: int, r: int) -> dict:
    """The hybrid's mamba2 part of rank r's plan of n: its H/n SSM heads,
    their channels and the groups they read. The guard splits w_zx's 2 d_in
    columns and w_out's d_in rows wherever n divides them; the port splits
    the scan by head, so n must divide H."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H, G = d_in // s.head_dim, s.n_groups
    if H % n:
        raise NotImplementedError(
            f"{cfg.name}: {H} SSM heads do not split {n} ways (d_in {d_in}): the port splits "
            "the mamba2 scan by head, and a rank's block of w_zx and w_out would cut a head")
    local, per_group = H // n, H // G
    if local % per_group == 0:
        groups = slice(r * local // per_group, (r + 1) * local // per_group)
    elif per_group % local == 0:
        groups = slice(r * local // per_group, r * local // per_group + 1)
    else:
        raise NotImplementedError(f"{cfg.name}: a rank's {local} SSM heads straddle the "
                                  f"groups of {per_group} heads")
    P = s.head_dim
    return dict(ssm_heads=slice(r * local, (r + 1) * local),
                ssm_channels=slice(r * local * P, (r + 1) * local * P),
                ssm_groups=groups, gather_zx=2 * d_in % n == 0)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    calls["tp_all_reduce"] += 1
    with torch.profiler.record_function("tp_all_reduce"):
        return D.all_reduce_(x.to(F32, copy=True), group=group).to(x.dtype)


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    calls["tp_all_gather"] += 1
    with torch.profiler.record_function("tp_all_gather"):
        n = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        D.all_gather_(out, x, group=group)
        out = out.view(n, *x.shape).movedim(0, -2)
        return out.reshape(*x.shape[:-1], n * x.shape[-1])


def _reduce_scatter_last(dy: torch.Tensor, group) -> torch.Tensor:
    """The rank's columns of the sum over the ranks of dy (..., n c), in fp32
    and returned in dy's dtype."""
    calls["tp_reduce_scatter"] += 1
    with torch.profiler.record_function("tp_reduce_scatter"):
        n = dist.get_world_size(group)
        parts = dy.reshape(*dy.shape[:-1], n, dy.shape[-1] // n).movedim(-2, 0)
        inp = parts.to(F32).contiguous()
        out = inp.new_empty((1, *inp.shape[1:]))
        return D.reduce_scatter_(out, inp, group)[0].to(dy.dtype)


class _Reduce(torch.autograd.Function):
    """g: the sum over the "model" group forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Enter(torch.autograd.Function):
    """f: the identity forward, the sum over the "model" group backward, of
    every input's gradient in one fp32 all-reduce."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *dys):
        need = ctx.needs_input_grad[1:]
        live = [dy for dy, k in zip(dys, need) if k]
        if len(live) == 1:
            summed = iter([_sum(live[0], ctx.group)])
        else:
            flat = _sum(torch.cat([dy.reshape(-1).to(F32) for dy in live]), ctx.group)
            summed = (part.view(dy.shape).to(dy.dtype) for part, dy in
                      zip(flat.split([dy.numel() for dy in live]), live))
        return (None, *(next(summed) if k else None for k in need))


class _SharedSum(torch.autograd.Function):
    """The sum over the "model" group forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.group), None


class _Gather(torch.autograd.Function):
    """The all-gather of the last dim forward, its reduce-scatter backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter_last(dy, ctx.group), None
