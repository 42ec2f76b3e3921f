"""Roofline analysis of the port's eager steps on an NVIDIA H100, the
counterpart of the JAX package's `roofline.py`.

The reference parses compiled HLO. The port has none: eager PyTorch runs
each op as a kernel that reads its inputs from HBM and writes its outputs
there. So `CostModel` is a `TorchDispatchMode` that watches the ops of a
step as they run, on the meta device (the dry-run, `launch/dryrun.py`) or
on the card, alike:
  flops       : `torch.utils.flop_counter`'s formulas (mm, bmm, addmm,
                convolution, SDPA) and each kernel op's own
                (`kernels/ops.py::COSTS`, from `kernels/costs.py`);
  hbm bytes   : inputs plus outputs of every op that is not a view, a
                factory or a metadata op (the reference's
                `_SKIP_BYTES_OPS`), slice-aware as the reference's: a
                gather reads what it writes, an in-place scatter writes its
                update and not the whole buffer; a kernel op's bytes are
                its cost formula's, its scratch stays inside it;
  collectives : each `c10d` collective, its operand bytes and the ring
                algorithm's wire bytes per device (the reference's factors)
                over the devices of its process group;
  kernel ops  : calls by name, to be held to the wrappers' launch counts;
  live bytes  : the high-water mark of the tensors' storages, those held
                at the start (`hold`) and those the ops create, freed when
                their storage dies.

Roofline terms (NVIDIA H100 80GB HBM3, SXM5, 700 W; NVIDIA's data sheet,
dense rates): 989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink 4 each way.
At import this module needs torch alone (tools/chip_ab.py loads it beside
another checkout's package); the port's modules are imported where used.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry


# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit, NVIDIA's data sheet, dense
PEAK_FLOPS = 989e12          # bf16 tensor cores, FLOP/s
PEAK_TF32_FLOPS = 495e12     # TF32 tensor cores, FLOP/s
PEAK_F32_FLOPS = 67e12       # fp32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12             # bytes / s
HBM_BYTES = 80 * 2**30       # device memory, bytes
# NVLink 4, bytes / s each way per card: a data-sheet figure until a
# four-card run measures the bus rate
LINK_BW = 450e9

aten = torch.ops.aten

# ops that move no bytes: no kernel (empty), or a factory whose values no
# input decides; views and ops without a tensor input are skipped too
_SKIP_BYTES_OPS = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten.zeros_like, aten.ones_like, aten.full_like, aten.rand_like, aten.randn_like,
    aten.detach, aten.alias, aten.lift_fresh, aten._local_scalar_dense,
}
# ops that read only the rows they write out (the reference's gather and
# dynamic-slice: twice the output), and in-place scatters, which read and
# write only the rows of their update (its in-place dynamic-update-slice)
_GATHER_OPS = {aten.index, aten.gather, aten.index_select, aten.embedding}
_SCATTER_OPS = {aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.scatter_,
                aten.scatter_add_, aten.index_add_}
# ops that evaluate a transcendental function per output element
_TRANSCENDENTAL_OPS = {
    aten.exp, aten.exp_, aten.exp2, aten.expm1, aten.log, aten.log_, aten.log1p, aten.log2,
    aten.tanh, aten.rsqrt, aten.sqrt, aten.sqrt_, aten.sigmoid, aten.silu, aten.softplus,
    aten.pow, aten.sin, aten.cos, aten.erf, aten._softmax, aten._log_softmax,
    aten.logsumexp, aten.gelu,
}
# c10d op -> (kind, index of the operand in its arguments)
_COLLECTIVES = {
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::broadcast_": ("broadcast", 0),
    "c10d::reduce_": ("reduce", 0),
    "c10d::alltoall_base_": ("all-to-all", 1),
}


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    # kind -> [ops, operand_bytes, wire_bytes]
    collectives: Dict[str, List[float]] = field(default_factory=dict)


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a kernel reads or writes of `t`: its elements, or the span
    its strides cover where that is smaller (a broadcast)."""
    n = t.numel()
    if n == 0:
        return 0
    if not t.is_contiguous():
        n = min(n, 1 + sum((s - 1) * abs(st) for s, st in zip(t.shape, t.stride())))
    return n * t.element_size()


def wire_bytes(kind: str, operand: float, parts: int) -> float:
    """Bytes a device puts on the links for one collective of `operand`
    bytes over `parts` devices, as a ring (the reference's factors; a
    broadcast or a reduce sends its payload once)."""
    if parts <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * operand * (parts - 1) / parts
    if kind == "all-gather":
        return operand * (parts - 1)
    if kind in ("reduce-scatter", "all-to-all"):
        return operand * (parts - 1) / parts
    return operand


class CostModel(TorchDispatchMode):
    """The FLOP, byte, collective and live-memory account of the ops run
    under it (see the module's docstring). `device` ("meta", "cuda",
    "cpu") restricts the account to ops that touch a tensor on that device
    type (a step's host-side bookkeeping, such as the RNG state that remat
    saves, is not HBM traffic); None counts every op.

      with CostModel("meta") as cm:
          cm.hold(state, batch)
          step(state, batch)
      cm.totals, cm.kernels, cm.peak_bytes
    """

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        self.device = torch.device(device).type if device is not None else None
        self.totals = CostTotals()
        self.by_op: Dict[str, List[float]] = {}   # op name -> [calls, flops, bytes]
        self.kernels: Dict[str, int] = {}         # kernel op -> calls
        self.live_bytes = 0
        self.peak_bytes = 0
        self._refs: Dict[int, weakref.ref] = {}
        self._ops: Dict[object, tuple] = {}

    # -- live memory ---------------------------------------------------------

    def _on_device(self, t: torch.Tensor) -> bool:
        return self.device is None or t.device.type == self.device

    def _track(self, t: torch.Tensor) -> int:
        if not self._on_device(t):
            return 0
        st = t.untyped_storage()
        key = id(st)
        ref = self._refs.get(key)
        if ref is not None and ref() is st:
            return 0
        n = st.nbytes()

        def free(_, key=key, n=n):
            self._refs.pop(key, None)
            self.live_bytes -= n

        self._refs[key] = weakref.ref(st, free)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def hold(self, *trees) -> int:
        """Count the storages of the tensors in `trees` (what a step is
        called with) as live from now on; returns their bytes."""
        return sum(self._track(t) for t in tree_leaves(trees) if isinstance(t, torch.Tensor))

    # -- the account ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + (_tensors(kwargs.values()) if kwargs else [])
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if self.device is None or any(t.device.type == self.device for t in ins + outs) \
                or _staged_collective(func, ins):
            self._count(func, args, kwargs, out, ins, outs)
        for t in outs:
            self._track(t)
        return out

    def _op(self, func):
        """(name, packet, what to count) of an op, worked out once."""
        info = self._ops.get(func)
        if info is None:
            from repro_torch.kernels import ops
            name, packet = func._schema.name, func.overloadpacket
            if packet in ops.COSTS:
                kind = "kernel"
            elif name in _COLLECTIVES:
                kind = "collective"
            elif func.is_view or packet in _SKIP_BYTES_OPS:
                kind = "no_bytes"
            elif packet in _GATHER_OPS:
                kind = "gather"
            elif packet in _SCATTER_OPS:
                kind = "scatter"
            else:
                kind = "op"
            info = self._ops[func] = (name, packet, kind, ops.COSTS.get(packet)
                                      or flop_registry.get(packet),
                                      packet in _TRANSCENDENTAL_OPS)
        return info

    def _count(self, func, args, kwargs, out, ins, outs):
        name, packet, kind, formula, transcendental = self._op(func)
        flops = nbytes = 0.0
        if kind == "kernel":
            flops, nbytes = formula(*args, **kwargs)
            short = name.split("::", 1)[1]
            self.kernels[short] = self.kernels.get(short, 0) + 1
        else:
            if formula is not None:
                flops = formula(*args, **kwargs, out_val=out)
            if kind == "gather":
                nbytes = 2 * sum(tensor_bytes(t) for t in outs) + _index_bytes(ins)
            elif kind == "scatter":   # ins[0] is the buffer updated in place
                nbytes = 2 * sum(tensor_bytes(t) for t in ins[1:] if t.is_floating_point()) \
                    + _index_bytes(ins[1:])
            elif kind != "no_bytes" and ins:
                nbytes = sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
            if transcendental:
                self.totals.transcendentals += sum(t.numel() for t in outs)
            if kind == "collective":
                ckind, at = _COLLECTIVES[name]
                operand = sum(tensor_bytes(t) for t in _tensors((args[at],)))
                parts = _group_size(args)
                cur = self.totals.collectives.setdefault(ckind, [0.0, 0.0, 0.0])
                cur[0] += 1
                cur[1] += operand
                cur[2] += wire_bytes(ckind, operand, parts)
        self.totals.flops += flops
        self.totals.bytes += nbytes
        row = self.by_op.get(name)
        if row is None:
            row = self.by_op[name] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def count_collective(self, name: str, out: torch.Tensor, inp: torch.Tensor,
                         parts: int) -> None:
        """Count the c10d op `name` (`_reduce_scatter_base_` or
        `_allgather_base_`) on `out` and `inp` over `parts` devices, as a
        dispatch of it would be counted: a collective that `distributed.py`
        ran as point-to-point hops under gloo, which this mode did not see."""
        if not (self._on_device(out) or self._on_device(inp)):
            return
        ckind, _ = _COLLECTIVES[name]
        operand = tensor_bytes(inp)
        nbytes = 2 * tensor_bytes(out) + operand   # its arguments, then its result
        cur = self.totals.collectives.setdefault(ckind, [0.0, 0.0, 0.0])
        cur[0] += 1
        cur[1] += operand
        cur[2] += wire_bytes(ckind, operand, parts)
        self.totals.bytes += nbytes
        row = self.by_op.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[2] += nbytes


def _staged_collective(func, ins) -> bool:
    """Whether `func` is a collective on host copies that stand for a card's
    tensors (`distributed.py`'s staging under gloo): counted as the card's."""
    if func._schema.name not in _COLLECTIVES:
        return False
    from repro_torch.distributed import is_staged
    return any(is_staged(t) for t in ins)


def _group_size(args) -> int:
    """The size of the process group a c10d op's arguments name (the world's
    where none unboxes to one)."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue
    return dist.get_world_size() if dist.is_initialized() else 1


def _index_bytes(ts) -> int:
    return sum(tensor_bytes(t) for t in ts if not t.is_floating_point())


def _tensors(xs) -> list:
    """The tensors among `xs` and in its lists and tuples (an op's
    arguments and results)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


# ----------------------------------------------------------------------------
# Roofline terms
# ----------------------------------------------------------------------------

def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> Tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time the card takes
    for `flops` at `peak` and `nbytes` through HBM, and which bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BW
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def roofline_terms(cost: CostTotals) -> Dict[str, float]:
    wire = sum(v[2] for v in cost.collectives.values())
    return {
        "compute_s": cost.flops / PEAK_FLOPS,
        "memory_s": cost.bytes / HBM_BW,
        "collective_s": wire / LINK_BW,
        "hlo_flops_per_device": cost.flops,
        "hbm_bytes_per_device": cost.bytes,
        "wire_bytes_per_device": wire,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    keys = ["compute_s", "memory_s", "collective_s"]
    return max(keys, key=lambda k: terms[k])


def roofline_fraction(terms: Dict[str, float]) -> float:
    """compute-term / max-term: 1.0 == perfectly compute-bound (roofline)."""
    top = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    return terms["compute_s"] / top if top > 0 else 0.0


# ----------------------------------------------------------------------------
# Analytic MODEL_FLOPS (global, whole step)
# ----------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """6*N*D-style useful-math FLOPs for the whole (global) step of `cfg`
    (a ModelConfig) at `shape` (a ShapeConfig)."""
    from repro_torch.configs.base import active_param_count
    B, T = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim
    n_act = active_param_count(cfg)
    # attention context math per attn layer
    if cfg.family in ("dense", "moe", "vlm"):
        n_attn = cfg.n_layers
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.hybrid.attn_every
    elif cfg.family == "audio":
        n_attn = cfg.n_layers * 2 + cfg.encdec.n_enc_layers  # self+cross+enc
    else:
        n_attn = 0

    if shape.kind == "train":
        matmul = 6.0 * n_act * B * T
        attn = n_attn * 12.0 * B * T * T * cfg.n_heads * hd * 0.5
        return matmul + attn
    if shape.kind == "prefill":
        return 2.0 * n_act * B * T + n_attn * 4.0 * B * T * T * cfg.n_heads * hd * 0.5
    # decode: one token, context = T (or the window for windowed layers)
    ctx = T
    if cfg.long_context_window and shape.name == "long_500k":
        ctx = cfg.long_context_window
    attn = n_attn * 4.0 * B * ctx * cfg.n_heads * hd
    return 2.0 * n_act * B + attn
