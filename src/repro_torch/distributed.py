"""Ranks and collectives for the port's multi-rank paths.

`spawn(fn, world_size, *args, device=...)` runs `fn(rank, world_size,
device, *args)` in `world_size` fresh processes (the `spawn` start method)
and returns their results by rank. `Ranks(world_size, device=...)` starts
such processes once and runs job after job on them (`run(fn, *args)`), so a
caller with many multi-rank jobs pays the processes' start-up (imports,
the card's context, the group) once; `spawn` is one job on a `Ranks`. Each
rank's device is explicit: the CPU when asked for, else card
`rank % torch.cuda.device_count()`. The group is initialised from a
`file://` rendezvous in a temporary directory, so parallel test workers
never contend for a port, with `timeout` on every collective, so a hung
collective raises instead of hanging; it is torn down in a `finally`. A
rank that raises makes `spawn` (or `run`) raise with its traceback, and the
other ranks are stopped.

The backend follows from the cards present (`backend_for`): NCCL needs a
card of its own for every rank, so NCCL when there are at least as many
cards as ranks, gloo otherwise (ranks on the CPU, or ranks sharing a card).
Nothing switches one for the other on failure.

The collectives below take tensors on the rank's device. gloo's
point-to-point takes CPU tensors only (handed a card's tensor, `send`
fails and `batch_isend_irecv` aborts the rank: tools/gloo_cuda_probe.py),
so under gloo every payload of a card goes through host memory, as
explicit copies, for the collectives too (`transport` names the route;
gloo's `all_to_all_single` takes CPU tensors); the arithmetic stays on the
card. The copies go through two pinned host buffers a process, one for
what a collective reads and one for what it writes, grown to the largest
payload (a pinned copy runs at the link's rate, a pageable one through a
bounce buffer). Under gloo `reduce_scatter_` and `all_gather_` run as rings
of n - 1 point-to-point hops (`shift`), the sums on the rank's device:
gloo's own `reduce_scatter_tensor` runs a whole all-reduce and its
`all_gather_into_tensor` takes as long or longer, where a ring moves
(n - 1)/n of the payload a rank (tests/test_torch_distributed.py holds the
rings to gloo's ops). Under NCCL every payload stays on the card. The cost
account (`roofline.CostModel`) counts a collective on such a host copy, or
run as a ring (`CostModel.count_collective`), as the card's own collective
and leaves the staging copies and the hops out, so a rank's account on the
card is the account of the same step under NCCL.
"""
from __future__ import annotations

import datetime
import gc
import multiprocessing as mp
import os
import queue
import tempfile
import traceback
import weakref
from typing import Any, Callable, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import (_disable_current_modes,
                                          _get_current_dispatch_mode_stack)

SUM = dist.ReduceOp.SUM


def backend_for(world_size: int, device="cuda") -> str:
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device="cuda") -> torch.device:
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks "
                           "on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, world_size, device, init, timeout, jobs, results):
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend_for(world_size, device), init_method=init, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        for fn, args in iter(jobs.get, None):
            try:
                value = fn(rank, world_size, dev, *args)
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
                raise
            results.put((rank, True, value))
            del value
            # a job's staging buffers and cached blocks do not outlive it:
            # the next job starts with the memory of a fresh rank
            _PINNED.clear()
            if dev.type == "cuda":
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


class Ranks:
    """`world_size` rank processes (the `spawn` start method) in one process
    group, kept until `close()`: `run(fn, *args)` runs `fn(rank, world_size,
    device, *args)` on every rank and returns each rank's result, by rank.
    `fn` must be importable (a module-level function) and return plain
    Python or numpy values, which are pickled back. `timeout` (seconds)
    bounds the rendezvous and every collective. A rank that raises, or
    dies, makes `run` raise and stops the ranks."""

    def __init__(self, world_size: int, device="cuda", timeout: float = 300.0):
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self._tmp = tempfile.TemporaryDirectory(prefix="repro-torch-rdv-")
        init = "file://" + os.path.join(self._tmp.name, "init")
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(world_size)]   # a rank's own: each runs every job
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, world_size, device, init, timeout, self._jobs[r],
                                         self._results))
                       for r in range(world_size)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args) -> List[Any]:
        if self._procs is None:
            raise RuntimeError("these ranks are closed")
        for q in self._jobs:
            q.put((fn, args))
        got = {}
        try:
            while len(got) < self.world_size:
                try:
                    rank, ok, value = self._results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{self._procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {self.world_size} failed:\n{value}")
                got[rank] = value
        except BaseException:
            self.close(wait=False)
            raise
        return [got[r] for r in range(self.world_size)]

    def close(self, wait: bool = True):
        """Stop the ranks: each leaves after its job (`wait`: within 30 s),
        else it is terminated."""
        if self._procs is None:
            return
        procs, self._procs = self._procs, None
        for q in self._jobs:
            q.put(None)
        for p in procs:
            p.join(timeout=30 if wait else 0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        for q in (self._results, *self._jobs):
            q.close()
        self._tmp.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(wait=exc[0] is None)


def spawn(fn: Callable, world_size: int, *args, device="cuda",
          timeout: float = 300.0) -> List[Any]:
    """Run `fn(rank, world_size, device, *args)` on `world_size` fresh ranks
    (`Ranks`) and stop them; return each rank's result, by rank."""
    with Ranks(world_size, device, timeout) as ranks:
        return ranks.run(fn, *args)


# ----------------------------------------------------------------------------
# Collectives on the rank's device
# ----------------------------------------------------------------------------

def host_staged(t: torch.Tensor, group=None) -> bool:
    """Whether the payload of `t` travels through host memory: a card's
    tensor under gloo."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def transport(device, group=None) -> str:
    """The route a payload on `device` takes: the backend, and whether the
    bytes go through host memory."""
    backend = dist.get_backend(group)
    staged = torch.device(device).type != "cpu" and backend == "gloo"
    return f"{backend}, through host memory" if staged else backend


# id -> a weak reference to each host copy that stands for a card's tensor
# in a collective
_STAGED = {}
# "in" / "out" -> this process's pinned host buffer (bytes) for the payloads
# a collective reads and writes; the collectives are synchronous, so one of
# each serves them all
_PINNED = {}


def _pinned(t: torch.Tensor, slot: str) -> torch.Tensor:
    """A contiguous host tensor of t's shape and dtype in the pinned buffer
    `slot`, grown (reallocated) where t does not fit."""
    n = t.numel() * t.element_size()
    buf = _PINNED.get(slot)
    if buf is None or buf.numel() < n:
        _PINNED.pop(slot, None)
        buf = _PINNED[slot] = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True)
    return buf[:n].view(t.dtype).view(t.shape)


def is_staged(t: torch.Tensor) -> bool:
    """Whether `t` is a host copy of a card's tensor made for a collective."""
    ref = _STAGED.get(id(t))
    return ref is not None and ref() is t


def _host(t, group, read: bool = True):
    """The tensor a collective takes for `t`: `t` itself, or under gloo its
    host copy (with `read` False an empty host buffer: `t` is only written)."""
    if not host_staged(t, group):
        return t
    with _disable_current_modes():   # transport, not the step's own traffic
        h = _pinned(t, "in" if read else "out")
        if read:
            h.copy_(t)
    _STAGED[id(h)] = weakref.ref(h, lambda _, key=id(h): _STAGED.pop(key, None))
    return h


def _back(t, h):
    if h is not t:
        with _disable_current_modes():
            t.copy_(h)
    return t


def all_reduce_(t, op=SUM, group=None):
    h = _host(t, group)
    dist.all_reduce(h, op, group)
    return _back(t, h)


def reduce_(t, dst: int, op=SUM, group=None):
    """Sum `t` over the group into rank `dst`'s `t`; the others' `t` are
    left as they are, or with partial sums, as `dist.reduce` leaves them.
    Ranks here are global ranks, as torch.distributed's."""
    h = _host(t, group)
    dist.reduce(h, dst, op, group)
    return _back(t, h) if dist.get_rank() == dst else t


def broadcast_(t, src: int, group=None):
    h = _host(t, group)
    dist.broadcast(h, src, group)
    return _back(t, h)


def _count_ring(name, out, inp, group):
    """Show a collective that ran as point-to-point hops (out of sight of
    any dispatch mode) to the cost accounts that are on
    (`roofline.CostModel.count_collective`) as the c10d op `name`."""
    for mode in _get_current_dispatch_mode_stack():
        count = getattr(mode, "count_collective", None)
        if count is not None:
            count(name, out, inp, dist.get_world_size(group))


def reduce_scatter_(out, inp, group=None):
    """`out` (the rank's part, dim 0) <- the sum over ranks of `inp`, which
    stacks every rank's part on dim 0. Under gloo a ring of n - 1 hops
    (`shift`), each adding the rank's part on its device to the partial sum
    it receives: gloo runs `reduce_scatter_tensor` as a whole all-reduce."""
    if dist.get_backend(group) != "gloo":   # no staging: NCCL takes the card's tensors
        dist.reduce_scatter_tensor(out, inp, SUM, group)
        return out
    n, r = dist.get_world_size(group), dist.get_rank(group)
    with _disable_current_modes():   # the ring is the collective's transport
        parts = inp.chunk(n)
        if n == 1:
            out.copy_(parts[0])
        send = parts[(r - 1) % n]
        for s in range(n - 1):   # part (r - s - 2) % n's partial sum arrives
            shift(send, out, group)
            out.add_(parts[(r - s - 2) % n])
            if s < n - 2:
                send = out.clone()
    _count_ring("c10d::_reduce_scatter_base_", out, inp, group)
    return out


def all_gather_(out, inp, group=None):
    """`out` <- every rank's `inp`, stacked on dim 0 in rank order. Under
    gloo a ring of n - 1 hops (`shift`), each passing on the part the rank
    received last: gloo's `all_gather_into_tensor` takes about twice an
    all-reduce of the output."""
    if dist.get_backend(group) != "gloo":
        dist.all_gather_into_tensor(out, inp, group)
        return out
    n, r = dist.get_world_size(group), dist.get_rank(group)
    with _disable_current_modes():
        parts = out.chunk(n)
        parts[r].copy_(inp)
        for s in range(n - 1):   # part (r - s - 1) % n arrives
            shift(parts[(r - s) % n], parts[(r - s - 1) % n], group)
    _count_ring("c10d::_allgather_base_", out, inp, group)
    return out


def all_to_all_(out, inp, group=None):
    """`out` <- part r of every rank's `inp`: both stack n equal parts on
    dim 0, rank q's part j of `inp` landing in part q of rank j's `out`."""
    ho, hi = _host(out, group, read=False), _host(inp, group)
    dist.all_to_all_single(ho, hi.contiguous(), group=group)
    return _back(out, ho)


def send(t, dst: int, group=None):
    dist.send(_host(t, group).contiguous(), dst, group)


def recv(t, src: int, group=None):
    h = _host(t, group, read=False)
    dist.recv(h, src, group)
    return _back(t, h)


def shift(send_buf, recv_buf, group=None):
    """One hop of a ring: send to rank (r+1) mod n, receive from (r-1) mod n,
    as one `batch_isend_irecv`. Returns `recv_buf`."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n) if group is not None else (r + 1) % n
    prv = dist.get_global_rank(group, (r - 1) % n) if group is not None else (r - 1) % n
    hs, hr = _host(send_buf, group), _host(recv_buf, group, read=False)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, hs.contiguous(), nxt, group),
                                     dist.P2POp(dist.irecv, hr, prv, group)]):
        w.wait()
    return _back(recv_buf, hr)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group, whose gradient is the sum over the group of
    the gradients (each rank's copy of the result feeds its own loss): the
    data-parallel MoE aux loss's collective (`moe.moe_ffn`'s mean router
    probabilities over the data group). Not tensor parallelism's: there
    every rank of the "model" group computes the same loss, so this
    backward would give n times the gradient; TP's collectives are their
    own Functions (`models/tensor_parallel.py`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.detach().clone(), group=group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.detach().clone(), group=ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-reduce (sum) over a data-parallel group: see
    `_AllReduceSum`."""
    return _AllReduceSum.apply(x, group)
