"""Wrapper of the CUDA chunked SSD scan (`csrc/ssm_scan.cu`), the port of the
Pallas kernel `repro/kernels/ssm_scan.py::_ssd_kernel`. It takes CUDA tensors
only; `ops.ssd_scan` sends CPU tensors to the plain version instead.

The source holds two kernels. `route` picks one from the dtype, shapes,
strides and alignment alone, before the launch: the chunk-parallel
tensor-core path (`mma`: three launches, products in 3xTF32, tiles fed by
TMA) for fp32 that TMA can read at P = N = 64 and a chunk that is a multiple
of 64 up to 256, else the first version (`simt`). `plan` gives the
tensor-core path's grids and workspaces from shapes alone, so the host reads
nothing from the device. A failed build, tensor-map encode or launch raises;
nothing falls back to another kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build

# launches of the kernel in this process, in all and by path (read by
# chip_smoke.py); a call of the tensor-core path is one launch here
launches = 0
launches_by_path = {"mma": 0, "simt": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATH_CODES = {"simt": 0, "mma": 1}
# the first version's limits; at all three a CTA needs 192,768 bytes of shared memory
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 64
# the tensor-core path's shapes (csrc TC_ROWS, TC_DIM, TC_QMAX): 64-row tiles
# of a chunk, P = N = 64, chunks of 64 to 256 steps
TILE_ROWS, TC_DIM, TC_MAX_CHUNK = 64, 64, 256
STATE_THREADS = 256   # csrc TC_STATE_THREADS: 4 state elements a thread
_fn = None


class Plan(NamedTuple):
    """The tensor-core path's three grids (x, y, z) and its fp32 workspaces."""
    chunk_grid: Tuple[int, int, int]   # (a) la and dS per (chunk, head, batch row)
    state_grid: Tuple[int, int, int]   # (b) the recurrence over the chunks
    out_grid: Tuple[int, int, int]     # (c) y per (64-row tile, chunk, head, batch row)
    ds_shape: Tuple[int, ...]          # dS, then the state entering each chunk
    la_shape: Tuple[int, ...]          # the in-chunk cumsum of dt * A


def plan(B: int, H: int, T: int, Q: int, P: int, N: int) -> Plan:
    """The tensor-core path's grids and workspaces, from shapes alone.

    With nc = T / Q chunks: (a) one CTA per (chunk, head, batch row); (b)
    P N / 1024 CTAs per (head, batch row), each thread 4 elements of the
    state; (c) one CTA per (64-row tile, chunk, head, batch row), its x
    axis a chunk's row tiles from the last (the most key tiles), then the
    chunks, so the CTAs that read a chunk's tiles run together. At
    zamba2-2.7b's prefill (B=4, H=80, T=1024, Q=256, P=N=64): 1280, 1280
    and 5120 CTAs; dS is 21 MB."""
    if min(B, H, T, Q, P, N) <= 0:
        raise ValueError(f"plan needs positive shapes, got B={B} H={H} T={T} Q={Q} "
                         f"P={P} N={N}")
    if T % Q or Q % TILE_ROWS or P * N % (4 * STATE_THREADS):
        raise ValueError(f"T={T} must be a multiple of the chunk Q={Q}, Q of "
                         f"{TILE_ROWS}, and P*N={P * N} of {4 * STATE_THREADS}")
    nc = T // Q
    return Plan(chunk_grid=(nc, H, B), state_grid=(P * N // (4 * STATE_THREADS), H, B),
                out_grid=(nc * Q // TILE_ROWS, H, B), ds_shape=(B, H, nc, P, N),
                la_shape=(B, H, T))


def route(dtype, Q: int, P: int, N: int, strides, ptr_align: int) -> str:
    """The kernel for x (B,H,T,P), Bm/Cm (B,G,T,N) of `dtype` at chunk Q:
    "mma" or "simt".

    strides: the element strides of the non-last axes of x, Bm and Cm;
    ptr_align: the largest power of two (in bytes) dividing their base
    addresses. The tensor-core path takes fp32 (what the model passes) at
    P = N = 64 and a chunk that is a multiple of 64 up to 256, when TMA can
    read x, Bm and Cm: every stride a positive multiple of 16 bytes and the
    bases 16-byte aligned. The first version takes bf16 and the rest."""
    if (dtype == torch.float32 and P == TC_DIM and N == TC_DIM
            and Q % TILE_ROWS == 0 and 0 < Q <= TC_MAX_CHUNK
            and ptr_align % build.TMA_ALIGN == 0
            and all(s > 0 and 4 * s % build.TMA_ALIGN == 0 for s in strides)):
        return "mma"
    return "simt"


def route_for(x, Bm, Cm, *, chunk: int = 256) -> str:
    """`route` of these tensors at this chunk."""
    Q = min(chunk, x.shape[2])
    strides = (*x.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3])
    return route(x.dtype, Q, x.shape[3], Bm.shape[3], strides, build.alignment(x, Bm, Cm))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("ssm_scan").ssd_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 2
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, dt, A, Bm, Cm, Q):
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm and Cm must share float32 or bfloat16, got "
                         f"{x.dtype} {Bm.dtype} {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("dt and A must be float32")
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"want x (B,H,T,P), Bm/Cm (B,G,T,N); got {tuple(x.shape)} "
                         f"{tuple(Bm.shape)} {tuple(Cm.shape)}")
    B, H, T, P = x.shape
    G, N = Bm.shape[1], Bm.shape[3]
    if dt.shape != (B, H, T) or A.shape != (H,) or Bm.shape[0] != B or Bm.shape[2] != T:
        raise ValueError(f"shape mismatch x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} Bm {tuple(Bm.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"heads {H} must be a multiple of the groups {G}")
    if T % Q:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {Q}")
    if Q > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"chunk {Q}, head dim {P}, state {N} exceed "
                         f"{MAX_CHUNK}, {MAX_HEAD_DIM}, {MAX_STATE}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")
    if A.stride(0) != 1:
        raise ValueError("A must be contiguous")


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256, path: Optional[str] = None):
    """x (B,H,T,P), dt (B,H,T) fp32, A (H,) fp32, Bm/Cm (B,G,T,N) ->
    (y (B,H,T,P) in x's dtype with x's strides, final state (B,H,P,N)
    fp32). Any strides with a contiguous last axis (dt: any strides).
    `path` None takes the kernel `route` names; "simt" or "mma" names one
    (the first version takes any input; chip_smoke.py times it on the
    inputs the tensor-core path takes), and a kernel that cannot take the
    inputs raises."""
    global launches
    B, H, T, P = x.shape
    Q = min(chunk, T)
    _check(x, dt, A, Bm, Cm, Q)
    G, N = Bm.shape[1], Bm.shape[3]
    routed = route_for(x, Bm, Cm, chunk=chunk)
    path = path or routed
    if path not in PATH_CODES or (path == "mma" and routed != "mma"):
        raise ValueError(f"ssd_scan: kernel {path!r} cannot take these inputs "
                         f"(route names {routed!r})")
    y = torch.empty_like(x)   # x's strides: the model's (B,T,H,P) layout stays
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    ds = la = grids = None
    if path == "mma":
        pl = plan(B, H, T, Q, P, N)
        ds = torch.empty(pl.ds_shape, dtype=torch.float32, device=x.device)
        la = torch.empty(pl.la_shape, dtype=torch.float32, device=x.device)
        grids = (ctypes.c_int * 9)(*pl.chunk_grid, *pl.state_grid, *pl.out_grid)
    strides = (ctypes.c_int64 * 15)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
                                     *Cm.stride()[:3], *y.stride()[:3])
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                       Cm.data_ptr(), y.data_ptr(), state.data_ptr(), strides,
                       B, H, G, T, P, N, Q, DTYPE_CODES[x.dtype], PATH_CODES[path],
                       ds.data_ptr() if ds is not None else None,
                       la.data_ptr() if la is not None else None, grids,
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan {path} kernel: {build.error_text(rc)}")
    launches += 1
    launches_by_path[path] += 1
    return y, state
