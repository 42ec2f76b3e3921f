"""Wrapper of the CUDA decode attention kernel (`csrc/decode_attention.cu`),
the port of the Pallas kernel `repro/kernels/decode_attention.py::
_decode_kernel`. It takes CUDA tensors only; `ops.decode_attention` sends
CPU tensors to the plain version instead."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

# launches of the kernel in this process (read by chip_smoke.py)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
MAX_GROUP = 8   # q heads per cache head
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("decode_attention").decode_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, valid_len, k_scale, v_scale):
    dev = q.device
    named = [("q", q), ("k", k), ("v", v), ("valid_len", valid_len)]
    int8 = k.dtype == torch.int8
    if int8:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 cache needs k_scale and v_scale")
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported: float32 or bfloat16")
    if v.dtype != k.dtype or not (int8 or k.dtype == q.dtype):
        raise ValueError(f"cache dtypes k {k.dtype} v {v.dtype} do not go with "
                         f"q {q.dtype}: the same dtype, or int8 with scales")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,Hq,D), k/v (B,Hc,S,D); got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, Hq, D = q.shape
    Hc, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)}")
    if Hq % Hc or Hq // Hc > MAX_GROUP:
        raise ValueError(f"q heads {Hq} must be 1..{MAX_GROUP} times cache "
                         f"heads {Hc}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported: {HEAD_DIMS}")
    if valid_len.shape != (B,) or valid_len.dtype != torch.int32:
        raise ValueError("valid_len must be int32 of shape (B,)")
    if int8 and (k_scale.shape != (B, Hc, S, 1) or v_scale.shape != (B, Hc, S, 1)
                 or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("scales must be float32 of shape (B, Hc, S, 1)")
    # each lane loads ceil(D/32), rounded up to a power of two, consecutive
    # elements of a row in one access
    per_lane = 1 << (-(-D // 32) - 1).bit_length()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")
        if t.data_ptr() % (per_lane * t.element_size()) or any(
                s % per_lane for s in t.stride()[:-1]):
            raise ValueError(f"{name} rows are not aligned to {per_lane} elements")


def decode_attention(q, k, v, valid_len, k_scale=None, v_scale=None):
    """q (B,Hq,D); k/v (B,Hc,S,D) [int8 + fp32 scales (B,Hc,S,1)];
    valid_len (B,) int32 -> (B,Hq,D) in q's dtype. Any strides with a
    contiguous D axis; rows at or past valid_len[b] are not read."""
    global launches
    _check(q, k, v, valid_len, k_scale, v_scale)
    B, Hq, D = q.shape
    Hc, S = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    int8 = k.dtype == torch.int8
    ks_strides = k_scale.stride()[:3] if int8 else (0, 0, 0)
    vs_strides = v_scale.stride()[:3] if int8 else (0, 0, 0)
    strides = (ctypes.c_int64 * 16)(*q.stride()[:2], *k.stride()[:3],
                                     *v.stride()[:3], *ks_strides, *vs_strides,
                                     *out.stride()[:2])
    with torch.cuda.device(q.device):
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       k_scale.data_ptr() if int8 else None,
                       v_scale.data_ptr() if int8 else None,
                       valid_len.data_ptr(), out.data_ptr(), strides,
                       B, Hq, Hc, S, D, DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype],
                       1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (code {rc})")
    launches += 1
    return out
