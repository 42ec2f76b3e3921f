"""Public kernel entry points, with the names of the JAX package's
`kernels/ops.py`. A CUDA tensor goes to the hand-written kernel (a build or
launch error propagates); a CPU tensor goes to the plain PyTorch version in
`ref.py`; a meta tensor (the dry-run, `launch/dryrun.py`) gets the kernel's
outputs as meta tensors, with the kernel's shapes and dtypes. The tensor's
device decides, and nothing else.

On CUDA and meta each kernel is a `torch.library.custom_op` in the
`repro_torch` namespace (`torch.ops.repro_torch.*`): its CUDA implementation
calls the ctypes wrapper exactly as a direct call would, its fake
implementation gives the meta outputs, and its cost formula (`costs.py`,
registered with `torch.utils.flop_counter`) gives its FLOPs and the
HBM bytes it must move: each input read once, each output written once. So
a dispatch mode (`roofline.CostModel`, `FlopCounterMode`) sees each kernel
launch as one op whose inputs and outputs are its HBM boundary, while the
kernel's own scratch stays inside it. The formulas are also the bounds that
chip_smoke.py prints. The CPU path calls the plain version directly, since
the CPU tests differentiate through it.

The CUDA kernels' outputs carry no `grad_fn`, so a gradient through one
would silently leave its inputs out. A CUDA (or meta) call with grad
enabled and an input that requires grad therefore raises (`check_no_grad`).
Training differentiates each kernel through a `torch.autograd.Function`
that calls it under no_grad: attention through `models/flash_vjp.py`, the
grouped matmul through `models/moe.py::GroupedMatmul` (whose backward is
the two products `moe_gmm_dx` and `moe_gmm_dw`), the SSD scan through
`models/mamba2.py::SSDScan`. The plain versions are differentiable, so a
CPU call never raises."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssd
from repro_torch.kernels.costs import decode_cost, flash_cost, gmm_cost, ssd_cost

Tensor = torch.Tensor
F32 = torch.float32


# where each kernel's gradient on the card comes from instead (ROADMAP.md,
# Queue 2, "Backward kernels")
NO_BACKWARD = {
    "flash_attention": "differentiate through models.flash_vjp.flash_attention_vjp, "
                       "whose backward is plain PyTorch until the flash backward kernel",
    "decode_attention": "decoding is inference only; no backward is queued",
    "moe_gmm": "differentiate through models.moe.GroupedMatmul, whose backward is the "
               "grouped products moe_gmm_dx and moe_gmm_dw (themselves not differentiable)",
    "ssd_scan": "differentiate through models.mamba2.SSDScan, whose backward is the "
                "model's chunked scan in plain PyTorch until an SSD backward kernel",
}


def check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a backward of kernel `name`: grad is
    enabled and one of `tensors` requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            f"{NO_BACKWARD[name]} (ROADMAP.md, Queue 2, \"Backward kernels\")")


def _kernel_device(t) -> bool:
    """True for the custom ops' devices (CUDA, meta), False for the CPU."""
    if t.device.type in ("cuda", "meta"):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


# ----------------------------------------------------------------------------
# The custom ops
# ----------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _flash_op(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: Optional[int]) -> Tensor:
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


@_flash_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=(),
                         device_types="cuda")
def _flash_lse_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  window: Optional[int]) -> Tuple[Tensor, Tensor]:
    return _flash.flash_attention(q, k, v, causal=causal, window=window, return_lse=True)


@_flash_lse_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=F32)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(), device_types="cuda")
def _decode_op(q: Tensor, k: Tensor, v: Tensor, valid_len: Tensor, k_scale: Optional[Tensor],
               v_scale: Optional[Tensor]) -> Tensor:
    return _decode.decode_attention(q, k, v, valid_len, k_scale, v_scale)


@_decode_op.register_fake
def _(q, k, v, valid_len, k_scale, v_scale):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=(), device_types="cuda")
def _gmm_op(x: Tensor, w: Tensor) -> Tensor:
    return _gmm.moe_gmm(x, w)


@_gmm_op.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@torch.library.custom_op("repro_torch::moe_gmm_dx", mutates_args=(), device_types="cuda")
def _gmm_dx_op(dy: Tensor, w: Tensor) -> Tensor:
    return _gmm.moe_gmm_dx(dy, w)


@_gmm_dx_op.register_fake
def _(dy, w):
    return dy.new_empty((dy.shape[0], dy.shape[1], w.shape[1]))


@torch.library.custom_op("repro_torch::moe_gmm_dw", mutates_args=(), device_types="cuda")
def _gmm_dw_op(x: Tensor, dy: Tensor) -> Tensor:
    return _gmm.moe_gmm_dw(x, dy)


@_gmm_dw_op.register_fake
def _(x, dy):
    return x.new_empty((x.shape[0], x.shape[2], dy.shape[2]))


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(), device_types="cuda")
def _ssd_op(x: Tensor, dt: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor,
            chunk: int) -> Tuple[Tensor, Tensor]:
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


@_ssd_op.register_fake
def _(x, dt, A, Bm, Cm, chunk):
    B, H, _, P = x.shape
    return torch.empty_like(x), x.new_empty((B, H, P, Bm.shape[3]), dtype=F32)


def _flash_args_cost(q, k, v, causal, window, lse):
    B, Hq, Tq, D = q.shape
    return flash_cost(B, Hq, k.shape[1], Tq, k.shape[2], D, causal=causal, window=window,
                      itemsize=q.element_size(), lse=lse)


def _gmm_args_cost(a, b, kind):
    E = a.shape[0]
    M, K, N = {"fwd": (a.shape[1], a.shape[2], b.shape[2]),
               "dx": (a.shape[1], a.shape[2], b.shape[1]),
               "dw": (a.shape[2], a.shape[1], b.shape[2])}[kind]
    return gmm_cost(E, M, K, N, a.element_size())


# op packet -> (FLOPs, bytes) of a call with these arguments: what
# roofline.CostModel counts for each kernel op
COSTS: Dict[object, Callable[..., Tuple[int, int]]] = {
    torch.ops.repro_torch.flash_attention:
        lambda q, k, v, causal, window: _flash_args_cost(q, k, v, causal, window, False),
    torch.ops.repro_torch.flash_attention_lse:
        lambda q, k, v, causal, window: _flash_args_cost(q, k, v, causal, window, True),
    torch.ops.repro_torch.decode_attention:
        lambda q, k, v, valid_len, k_scale, v_scale: decode_cost(
            q.shape[0], q.shape[1], k.shape[1], k.shape[2], q.shape[2],
            q_itemsize=q.element_size(), cache_itemsize=k.element_size(),
            scales=k_scale is not None),
    torch.ops.repro_torch.moe_gmm: lambda x, w: _gmm_args_cost(x, w, "fwd"),
    torch.ops.repro_torch.moe_gmm_dx: lambda dy, w: _gmm_args_cost(dy, w, "dx"),
    torch.ops.repro_torch.moe_gmm_dw: lambda x, dy: _gmm_args_cost(x, dy, "dw"),
    torch.ops.repro_torch.ssd_scan:
        lambda x, dt, A, Bm, Cm, chunk: ssd_cost(
            x.shape[0], x.shape[1], x.shape[2], x.shape[3], Bm.shape[1], Bm.shape[3],
            min(chunk, x.shape[2]), x.element_size()),
}


def _register_flops(packet, cost):
    @register_flop_formula(packet, get_raw=True)
    def _(*args, out_val=None, **kwargs):
        return cost(*args, **kwargs)[0]


for _packet, _cost in COSTS.items():
    _register_flops(_packet, _cost)


# ----------------------------------------------------------------------------
# Entry points
# ----------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, return_lse: bool = False):
    """q (B,Hq,Tq,D); k/v (B,Hkv,Tk,D); query row i at key position i.
    `return_lse` returns (out, fp32 (B,Hq,Tq) row log-sum-exp)."""
    if _kernel_device(q):
        check_no_grad("flash_attention", q, k, v)
        op = torch.ops.repro_torch.flash_attention_lse if return_lse \
            else torch.ops.repro_torch.flash_attention
        return op(q, k, v, causal, window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=return_lse)


def decode_attention(q, k, v, valid_len, k_scale=None, v_scale=None):
    """q (B,Hq,D); k/v cache (B,Hc,S,D) [+ int8 scales]; valid_len (B,)."""
    if _kernel_device(q):
        check_no_grad("decode_attention", q, k, v, k_scale, v_scale)
        return torch.ops.repro_torch.decode_attention(q, k, v, valid_len, k_scale, v_scale)
    return ref.decode_attention_ref(q, k, v, valid_len, k_scale, v_scale)


def moe_gmm(x, w):
    """Grouped expert matmul: (E,C,d) @ (E,d,f) -> (E,C,f)."""
    if _kernel_device(x):
        check_no_grad("moe_gmm", x, w)
        return torch.ops.repro_torch.moe_gmm(x, w)
    return ref.moe_gmm_ref(x, w)


def moe_gmm_dx(dy, w):
    """The input gradient of moe_gmm: (E,C,f) @ (E,d,f)^T -> (E,C,d)."""
    if _kernel_device(dy):
        check_no_grad("moe_gmm", dy, w)
        return torch.ops.repro_torch.moe_gmm_dx(dy, w)
    return ref.moe_gmm_dx_ref(dy, w)


def moe_gmm_dw(x, dy):
    """The weight gradient of moe_gmm: (E,C,d)^T @ (E,C,f) -> (E,d,f)."""
    if _kernel_device(x):
        check_no_grad("moe_gmm", x, dy)
        return torch.ops.repro_torch.moe_gmm_dw(x, dy)
    return ref.moe_gmm_dw_ref(x, dy)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """Mamba2 SSD: x (B,H,T,P), dt (B,H,T), A (H,), Bm/Cm (B,G,T,N)."""
    if _kernel_device(x):
        check_no_grad("ssd_scan", x, dt, A, Bm, Cm)
        return torch.ops.repro_torch.ssd_scan(x, dt, A, Bm, Cm, chunk)
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)


__all__ = ["COSTS", "decode_attention", "flash_attention", "moe_gmm", "moe_gmm_dw",
           "moe_gmm_dx", "ref", "ssd_scan"]
