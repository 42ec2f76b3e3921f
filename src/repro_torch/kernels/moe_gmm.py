"""Wrapper of the CUDA grouped expert matmul (`csrc/moe_gmm.cu`), the port of
the Pallas kernel `repro/kernels/moe_gmm.py::_gmm_kernel`, and of its two
backward products. It takes CUDA tensors only; `ops.moe_gmm`,
`ops.moe_gmm_dx` and `ops.moe_gmm_dw` send CPU tensors to the plain versions
instead.

  moe_gmm(x, w)      x (E, C, d) @ w (E, d, f)     -> (E, C, f)
  moe_gmm_dx(dy, w)  dy (E, C, f) @ w (E, d, f)^T  -> (E, C, d)
  moe_gmm_dw(x, dy)  x (E, C, d)^T @ dy (E, C, f)  -> (E, d, f)

Each is one launch of out (E, M, N) = A (E, M, K) @ B (E, K, N) over the
operands' own strides (no transposed copy). The source holds three kernels.
`route` picks one from the dtype, M, strides and alignment alone, before
the launch: the bf16 tensor-core kernel (`wgmma`, fed by TMA) wherever TMA
can read the operands, else the CUDA-core row kernel for small M and the
tiled one above. A failed build, tensor-map encode or launch raises;
nothing falls back to another kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of each product in this process, in all and by path (read by
# chip_smoke.py)
launches = 0
launches_by_path = {"wgmma": 0, "rows": 0, "tiled": 0}
dx_launches = 0
dx_launches_by_path = {"wgmma": 0, "rows": 0, "tiled": 0}
dw_launches = 0
dw_launches_by_path = {"wgmma": 0, "rows": 0, "tiled": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"rows": 0, "tiled": 1, "wgmma": 2}
LAYOUT_CODES = {"fwd": 0, "dx": 1, "dw": 2}
LANE_COLS = 8   # columns a lane of the row kernel loads in one go
# The CUDA-core kernels cross at M = 32: the row kernel takes M <= 32 and
# the tiled one larger M (chip_smoke.py phase 3d's sweep on the H100). In
# bf16 the tensor-core kernel beats both at every capacity of that sweep,
# 4 to 160, so it has no switch: it takes every bf16 call TMA can read.
ROWS_MAX_C = 32
_fn = None


def route(dtype, M: int, K: int, strides, ptr_align: int) -> str:
    """The kernel for A (E, M, K) @ B (E, K, N): "wgmma", "rows" or "tiled".

    strides: the element strides of the non-last axes of the three tensors
    (the two operands and the output, each contiguous along its last axis);
    ptr_align: the largest power of two (in bytes) dividing the three base
    addresses. The tensor-core kernel takes bf16 whenever TMA can read the
    operands: every stride a positive multiple of 16 bytes and the bases
    16-byte aligned (the output's row stride is N, so N % 8 == 0 too), and
    K > 0 (a tensor map has no empty axis)."""
    if (dtype == torch.bfloat16 and K > 0 and ptr_align % build.TMA_ALIGN == 0
            and all(s > 0 and 2 * s % build.TMA_ALIGN == 0 for s in strides)):
        return "wgmma"
    return "rows" if M <= ROWS_MAX_C else "tiled"


def _operands(kind: str, a, b):
    """((M, K, N), the 6 element strides of A (e, m, k) and B (e, k, n)) of
    product `kind` on its two arguments."""
    sa, sb = a.stride(), b.stride()
    if kind == "fwd":   # x (E, C, d), w (E, d, f)
        return (a.shape[1], a.shape[2], b.shape[2]), (*sa, *sb)
    if kind == "dx":    # dy (E, C, f), w (E, d, f): B[k, n] = w[n, k]
        return (a.shape[1], a.shape[2], b.shape[1]), (*sa, sb[0], sb[2], sb[1])
    # dw: x (E, C, d), dy (E, C, f): A[m, k] = x[k, m]
    return (a.shape[2], a.shape[1], b.shape[2]), (sa[0], sa[2], sa[1], *sb)


def _strides(a, b, out):
    return (*a.stride()[:2], *b.stride()[:2], *out.stride()[:2])


def route_for(a, b, out, kind: str = "fwd") -> str:
    """`route` of these tensors for product `kind` ("fwd": moe_gmm(a=x,
    b=w); "dx": moe_gmm_dx(a=dy, b=w); "dw": moe_gmm_dw(a=x, b=dy))."""
    (M, K, _), _ = _operands(kind, a, b)
    return route(a.dtype, M, K, _strides(a, b, out), build.alignment(a, b, out))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("moe_gmm").moe_gmm_run
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


# what each product's two arguments are, and which of their axes must agree
_ARGS = {"fwd": ("x", "w"), "dx": ("dy", "w"), "dw": ("x", "dy")}
_WANT = {"fwd": "(E, C, d) and (E, d, f)", "dx": "(E, C, f) and (E, d, f)",
         "dw": "(E, C, d) and (E, C, f)"}


def _check(kind, a, b):
    for name, t in zip(_ARGS[kind], (a, b)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"{name} must be a CUDA tensor on {a.device}")
        if t.dim() != 3 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 3-D with a contiguous last axis, "
                             f"got shape {tuple(t.shape)} strides {t.stride()}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"dtypes {a.dtype} and {b.dtype}: both float32 or both bfloat16")
    E, s1, s2 = a.shape
    ok = {"fwd": b.shape[:2] == (E, s2), "dx": (b.shape[0], b.shape[2]) == (E, s2),
          "dw": b.shape[:2] == (E, s1)}[kind]
    if not ok:
        a_name, b_name = _ARGS[kind]
        raise ValueError(f"shape mismatch {a_name} {tuple(a.shape)} {b_name} "
                         f"{tuple(b.shape)}: want {_WANT[kind]}")


def _vector_loads(kind, b) -> bool:
    """Whether each lane's LANE_COLS columns of a B row are one aligned
    16-byte-multiple load: B is N-major (b's last axis is N: the forward's w,
    dw's dy), and N, the strides and the base all line up."""
    return (kind != "dx" and b.shape[2] % LANE_COLS == 0 and b.data_ptr() % 16 == 0
            and all(s % LANE_COLS == 0 for s in b.stride()[:2]))


def _count(kind: str, path: str) -> None:
    global launches, dx_launches, dw_launches
    if kind == "fwd":
        launches += 1
        launches_by_path[path] += 1
    elif kind == "dx":
        dx_launches += 1
        dx_launches_by_path[path] += 1
    else:
        dw_launches += 1
        dw_launches_by_path[path] += 1


def _run(kind: str, a, b):
    _check(kind, a, b)
    (M, K, N), ab_strides = _operands(kind, a, b)
    E = a.shape[0]
    out = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    path = route_for(a, b, out, kind)
    strides = (ctypes.c_int64 * 8)(*ab_strides, *out.stride()[:2])
    with torch.cuda.device(a.device):
        rc = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), strides, E, M, K, N,
                       DTYPE_CODES[a.dtype], int(_vector_loads(kind, b)), PATH_CODES[path],
                       LAYOUT_CODES[kind], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm {kind} {path} kernel: {build.error_text(rc)}")
    _count(kind, path)
    return out


def moe_gmm(x, w):
    """x (E, C, d) @ w (E, d, f) -> (E, C, f) in x's dtype, summed in fp32.
    Any C, d and f; any strides with a contiguous last axis."""
    return _run("fwd", x, w)


def moe_gmm_dx(dy, w):
    """The input gradient of moe_gmm: dy (E, C, f) @ w (E, d, f)^T -> (E, C,
    d) in dy's dtype, summed in fp32, reading w as it lies (K-major)."""
    return _run("dx", dy, w)


def moe_gmm_dw(x, dy):
    """The weight gradient of moe_gmm: x (E, C, d)^T @ dy (E, C, f) -> (E,
    d, f) in x's dtype, summed in fp32 over C, reading x as it lies
    (M-major)."""
    return _run("dw", x, dy)
