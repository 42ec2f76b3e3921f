"""Wrapper of the CUDA grouped expert matmul (`csrc/moe_gmm.cu`), the port of
the Pallas kernel `repro/kernels/moe_gmm.py::_gmm_kernel`. It takes CUDA
tensors only; `ops.moe_gmm` sends CPU tensors to the plain version instead.

The source holds three kernels. `route` picks one from the dtype, C,
strides and alignment alone, before the launch: the bf16 tensor-core kernel
(`wgmma`, fed by TMA) wherever TMA can read the operands, else the CUDA-core
row kernel for small capacities and the tiled one above. A failed build,
tensor-map encode or launch raises; nothing falls back to another kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of the kernel in this process, in all and by path (read by
# chip_smoke.py)
launches = 0
launches_by_path = {"wgmma": 0, "rows": 0, "tiled": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"rows": 0, "tiled": 1, "wgmma": 2}
LANE_COLS = 8   # columns a lane of the row kernel loads in one go
# The CUDA-core kernels cross at C = 32: the row kernel takes C <= 32 and
# the tiled one larger C (chip_smoke.py phase 3d's sweep on the H100). In
# bf16 the tensor-core kernel beats both at every capacity of that sweep,
# 4 to 160, so it has no switch: it takes every bf16 call TMA can read.
ROWS_MAX_C = 32
_fn = None


def route(dtype, C: int, d: int, strides, ptr_align: int) -> str:
    """The kernel for x (E, C, d) @ w (E, d, f): "wgmma", "rows" or "tiled".

    strides: the element strides of the non-last axes of x, w and out;
    ptr_align: the largest power of two (in bytes) dividing the three base
    addresses. The tensor-core kernel takes bf16 whenever TMA can read x
    and w: every stride a positive multiple of 16 bytes and the bases
    16-byte aligned (out's row stride is f, so f % 8 == 0 too), and d > 0
    (a tensor map has no empty axis)."""
    if (dtype == torch.bfloat16 and d > 0 and ptr_align % build.TMA_ALIGN == 0
            and all(s > 0 and 2 * s % build.TMA_ALIGN == 0 for s in strides)):
        return "wgmma"
    return "rows" if C <= ROWS_MAX_C else "tiled"


def _strides(x, w, out):
    return (*x.stride()[:2], *w.stride()[:2], *out.stride()[:2])


def route_for(x, w, out) -> str:
    """`route` of these tensors."""
    _, C, d = x.shape
    return route(x.dtype, C, d, _strides(x, w, out), build.alignment(x, w, out))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("moe_gmm").moe_gmm_fwd
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
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
    path = route_for(x, w, out)
    strides = (ctypes.c_int64 * 6)(*_strides(x, w, out))
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), w.data_ptr(), out.data_ptr(), strides,
                       E, C, d, f, DTYPE_CODES[x.dtype], int(_vector_loads(w)),
                       PATH_CODES[path], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm {path} kernel: {build.error_text(rc)}")
    launches += 1
    launches_by_path[path] += 1
    return out
