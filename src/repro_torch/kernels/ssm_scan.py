"""Wrapper of the CUDA chunked SSD scan (`csrc/ssm_scan.cu`), the port of the
Pallas kernel `repro/kernels/ssm_scan.py::_ssd_kernel`. It takes CUDA tensors
only; `ops.ssd_scan` sends CPU tensors to the plain version instead."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# launches of the kernel in this process (read by chip_smoke.py)
launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's limits; at all three a CTA needs 192,768 bytes of shared memory
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 64
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("ssm_scan").ssd_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
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


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """x (B,H,T,P), dt (B,H,T) fp32, A (H,) fp32, Bm/Cm (B,G,T,N) ->
    (y (B,H,T,P) in x's dtype with x's strides, final state (B,H,P,N)
    fp32). Any strides with a contiguous last axis (dt: any strides)."""
    global launches
    B, H, T, P = x.shape
    Q = min(chunk, T)
    _check(x, dt, A, Bm, Cm, Q)
    G, N = Bm.shape[1], Bm.shape[3]
    y = torch.empty_like(x)   # x's strides: the model's (B,T,H,P) layout stays
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 15)(*x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
                                     *Cm.stride()[:3], *y.stride()[:3])
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                       Cm.data_ptr(), y.data_ptr(), state.data_ptr(), strides,
                       B, H, G, T, P, N, Q, DTYPE_CODES[x.dtype],
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (code {rc})")
    launches += 1
    return y, state
