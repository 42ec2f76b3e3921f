"""Wrapper of the CUDA grouped expert matmul (`csrc/moe_gmm.cu`), the port of
the Pallas kernel `repro/kernels/moe_gmm.py::_gmm_kernel`. It takes CUDA
tensors only; `ops.moe_gmm` sends CPU tensors to the plain version instead."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of the kernel in this process (read by chip_smoke.py)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LANE_COLS = 8   # columns a lane of the kernel loads in one go
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("moe_gmm").moe_gmm_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, w):
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
        if t.dim() != 3 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 3-D with a contiguous last axis, "
                             f"got shape {tuple(t.shape)} strides {t.stride()}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"dtypes x {x.dtype} w {w.dtype}: both float32 or both bfloat16")
    if w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"shape mismatch x {tuple(x.shape)} w {tuple(w.shape)}: "
                         "want (E, C, d) and (E, d, f)")


def _vector_loads(w) -> bool:
    """Whether each lane's LANE_COLS columns of a weight row are one aligned
    16-byte-multiple load: f, the strides and the base all line up."""
    return (w.shape[2] % LANE_COLS == 0 and w.data_ptr() % 16 == 0
            and all(s % LANE_COLS == 0 for s in w.stride()[:2]))


def moe_gmm(x, w):
    """x (E, C, d) @ w (E, d, f) -> (E, C, f) in x's dtype, summed in fp32.
    Any C, d and f; any strides with a contiguous last axis."""
    global launches
    _check(x, w)
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_int64 * 6)(*x.stride()[:2], *w.stride()[:2], *out.stride()[:2])
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), strides,
                       E, C, d, f, DTYPE_CODES[x.dtype], int(_vector_loads(w)),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed (code {rc})")
    launches += 1
    return out
