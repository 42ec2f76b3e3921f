"""Wrapper of the CUDA prefill attention kernel (`csrc/flash_attention.cu`),
the port of the Pallas kernel `repro/kernels/flash_attention.py::
_flash_kernel`. It takes CUDA tensors only; `ops.flash_attention` sends CPU
tensors to the plain version instead."""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

# launches of the kernel in this process (read by chip_smoke.py)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
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
                    window: Optional[int] = None):
    """q (B,Hq,Tq,D); k/v (B,Hkv,Tk,D) -> out like q (with q's strides).

    Any strides with a contiguous D axis; query row i sits at key position
    i, as in the Pallas kernel. fp32 softmax, output in q's dtype."""
    global launches
    _check(q, k, v, window)
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                     *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       strides, B, Hq, Hkv, Tq, Tk, D, DTYPE_CODES[q.dtype],
                       int(causal), window or 0, 1.0 / math.sqrt(D),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {rc})")
    launches += 1
    return out
