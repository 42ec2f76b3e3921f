"""Wrapper of the CUDA prefill attention kernels (`csrc/flash_attention.cu`),
the port of the Pallas kernel `repro/kernels/flash_attention.py::
_flash_kernel`. It takes CUDA tensors only; `ops.flash_attention` sends CPU
tensors to the plain version instead.

The source holds two kernels. `route` picks one from the dtype, head dim,
strides and alignment alone, before the launch: the bf16 tensor-core kernel
(`wgmma`, fed by TMA) wherever TMA can read q, k and v, else the CUDA-core
kernel (`simt`). A failed build, tensor-map encode or launch raises;
nothing falls back to another kernel. With `return_lse=True` either kernel
also writes each row's fp32 log-sum-exp, the flash backward's residual
(`models/flash_vjp.py`); the serving call writes none.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of the kernel in this process, in all and by path (read by
# chip_smoke.py)
launches = 0
launches_by_path = {"wgmma": 0, "simt": 0}
lse_launches = 0   # of those, the launches that wrote the lse (training)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"simt": 0, "wgmma": 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
_fn = None


def route(dtype, D: int, strides, ptr_align: int) -> str:
    """The kernel for q (B,Hq,Tq,D), k/v (B,Hkv,Tk,D): "wgmma" or "simt".

    strides: the element strides of the non-last axes of q, k and v;
    ptr_align: the largest power of two (in bytes) dividing their base
    addresses. The tensor-core kernel takes bf16 whenever TMA can read q, k
    and v: every stride a positive multiple of 16 bytes and the bases
    16-byte aligned. The CUDA-core kernel takes fp32 and the rest.

    No length stays on the CUDA-core kernel: in chip_smoke.py's sweeps
    (T = 16 to 2048 at D = 128, 80 and 160; H100 80GB HBM3, 700 W) the
    tensor-core kernel's device time is lower at every T, 0.0047 against
    0.0192 ms at T = 16 and 0.0355 against 0.7619 ms at T = 1024 (B=1,
    Hq=32, Hkv=8, D=128). Up to T = 128 a call is paced by the host, about
    0.03 ms for either kernel."""
    if (dtype == torch.bfloat16 and D in HEAD_DIMS and ptr_align % build.TMA_ALIGN == 0
            and all(s > 0 and 2 * s % build.TMA_ALIGN == 0 for s in strides)):
        return "wgmma"
    return "simt"


def route_for(q, k, v) -> str:
    """`route` of these tensors."""
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    return route(q.dtype, q.shape[3], strides, build.alignment(q, k, v))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-D with a contiguous last axis, "
                             f"got shape {tuple(t.shape)} strides {t.stride()}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not supported: float32 or bfloat16")
    B, Hq, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {k.shape[1]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported: {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, path: Optional[str] = None,
                    return_lse: bool = False):
    """q (B,Hq,Tq,D); k/v (B,Hkv,Tk,D) -> out like q (with q's strides),
    and with `return_lse` also (out, lse), lse fp32 (B,Hq,Tq): each row's
    log-sum-exp of its masked scaled scores.

    Any strides with a contiguous D axis; query row i sits at key position
    i, as in the Pallas kernel. fp32 softmax, output in q's dtype. `path`
    None takes the kernel `route` names; "simt" or "wgmma" names one (the
    CUDA-core kernel takes any input; chip_smoke.py times it on the inputs
    the tensor-core kernel takes), and a kernel that cannot read the inputs
    raises."""
    global launches, lse_launches
    _check(q, k, v, window)
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device) if return_lse else None
    routed = route_for(q, k, v)
    path = path or routed
    if path not in PATH_CODES or (path == "wgmma" and routed != "wgmma"):
        raise ValueError(f"flash_attention: kernel {path!r} cannot take these inputs "
                         f"(route names {routed!r})")
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                     *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       strides, B, Hq, Hkv, Tq, Tk, D, DTYPE_CODES[q.dtype],
                       int(causal), window or 0, 1.0 / math.sqrt(D), PATH_CODES[path],
                       None if lse is None else lse.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {path} kernel: {build.error_text(rc)}")
    launches += 1
    launches_by_path[path] += 1
    lse_launches += int(return_lse)
    return (out, lse) if return_lse else out
