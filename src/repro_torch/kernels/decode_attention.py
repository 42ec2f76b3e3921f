"""Wrapper of the CUDA decode attention kernels (`csrc/decode_attention.cu`),
the port of the Pallas kernel `repro/kernels/decode_attention.py::
_decode_kernel`. It takes CUDA tensors only; `ops.decode_attention` sends
CPU tensors to the plain version instead.

The source holds two kernels. `route` picks one from the dtype, shapes,
strides and alignment alone, before the launch: the split-S kernel fed by
TMA (`split`) wherever TMA can read the cache, else the first version
(`simt`). `plan` gives the split kernel's grid from shapes alone, so the
host never reads `valid_len`. A failed build, tensor-map encode or launch
raises; nothing falls back to another kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

# launches of the kernel in this process, in all and by path (read by
# chip_smoke.py)
launches = 0
launches_by_path = {"split": 0, "simt": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PATH_CODES = {"simt": 0, "split": 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
MAX_GROUP = 8   # q heads per cache head
SPLIT_TILE = 32            # cache rows per ring slot of the split kernel (csrc DS_ROWS)
SPLIT_BYTES = 128 * 1024   # bf16 K and V bytes a split aims to read
MIN_CTAS_PER_SM = 4        # below this, plan shortens the splits, empty ones included
MAX_SPLITS = 4096          # the merge kernel's limit (csrc DS_MAX_SPLITS)
_fn = None
_n_sm = {}


def plan(B: int, Hc: int, S: int, D: int, n_sm: int) -> Tuple[int, int]:
    """(rows per split, number of splits) of the split kernel's grid
    (n_splits, Hc, B), from shapes alone.

    A split reads about SPLIT_BYTES of bf16 K and V: the largest power of
    two of rows at or below that, at least 64 (two ring slots). Splits are
    halved, down to 64 rows, while the grid has fewer than MIN_CTAS_PER_SM
    CTAs per SM, and doubled while there are more than MAX_SPLITS. At
    llama3-8b's decode (B=8, Hc=16, S=2048, D=128) that is 256 rows, 8
    splits, 1024 CTAs on 132 SMs; the CTAs past a sequence's valid_len
    return at once. In chip_smoke.py's split length sweep (H100 80GB HBM3,
    700 W) 256 rows were the fastest of 64 to 1024 at llama3-8b's,
    zamba2-2.7b's and qwen1.5-32b's decode."""
    if min(B, Hc, S, D, n_sm) <= 0:
        raise ValueError(f"plan needs positive shapes, got B={B} Hc={Hc} S={S} D={D} "
                         f"n_sm={n_sm}")
    rows = max(2 * SPLIT_TILE, 1 << (SPLIT_BYTES // (4 * D)).bit_length() - 1)
    while rows > 2 * SPLIT_TILE and B * Hc * -(-S // rows) < MIN_CTAS_PER_SM * n_sm:
        rows //= 2
    while -(-S // rows) > MAX_SPLITS:
        rows *= 2
    return rows, -(-S // rows)


def route(dtype, D: int, S: int, strides, ptr_align: int) -> str:
    """The kernel for a cache k/v (B,Hc,S,D) of `dtype`: "split" or "simt".

    strides: the element strides of the non-last axes of k and v;
    ptr_align: the largest power of two (in bytes) dividing their base
    addresses. The split kernel takes any cache TMA can read: every stride
    a positive multiple of 16 bytes, the bases 16-byte aligned, and S > 0
    (a tensor map has no empty axis); a row of a head dim in HEAD_DIMS is
    whole 16 bytes in every dtype. The first version takes the rest."""
    if (D in HEAD_DIMS and S > 0 and ptr_align % build.TMA_ALIGN == 0
            and all(s > 0 and s * dtype.itemsize % build.TMA_ALIGN == 0 for s in strides)):
        return "split"
    return "simt"


def route_for(k, v) -> str:
    """`route` of this cache."""
    return route(k.dtype, k.shape[3], k.shape[2], (*k.stride()[:3], *v.stride()[:3]),
                 build.alignment(k, v))


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sm[idx]


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("decode_attention").decode_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int64)]
                       + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")


def _check_simt(q, k, v):
    """The first version's vector loads: each lane loads ceil(D/32), rounded
    up to a power of two, consecutive elements of a row in one access."""
    D = q.shape[2]
    per_lane = 1 << (-(-D // 32) - 1).bit_length()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % (per_lane * t.element_size()) or any(
                s % per_lane for s in t.stride()[:-1]):
            raise ValueError(f"{name} rows are not aligned to {per_lane} elements")


def decode_attention(q, k, v, valid_len, k_scale=None, v_scale=None,
                     path: Optional[str] = None, split_rows: Optional[int] = None):
    """q (B,Hq,D); k/v (B,Hc,S,D) [int8 + fp32 scales (B,Hc,S,1)];
    valid_len (B,) int32 -> (B,Hq,D) in q's dtype. Any strides with a
    contiguous D axis; rows at or past valid_len[b] do not count. `path`
    None takes the kernel `route` names; "split" or "simt" names one (the
    first version takes any aligned input; chip_smoke.py times it on the
    inputs the split kernel takes), and a kernel that cannot read the
    inputs raises. `split_rows` None takes `plan`'s split length; a
    multiple of SPLIT_TILE names one (chip_smoke.py's sweep)."""
    global launches
    _check(q, k, v, valid_len, k_scale, v_scale)
    B, Hq, D = q.shape
    Hc, S = k.shape[1], k.shape[2]
    routed = route_for(k, v)
    path = path or routed
    if path not in PATH_CODES or (path == "split" and routed != "split"):
        raise ValueError(f"decode_attention: kernel {path!r} cannot take these inputs "
                         f"(route names {routed!r})")
    if path == "simt":
        _check_simt(q, k, v)
        split_rows, n_splits, ws = 0, 0, None
    else:
        if split_rows is None:
            split_rows, n_splits = plan(B, Hc, S, D, _sm_count(q.device))
        elif split_rows <= 0 or split_rows % SPLIT_TILE or -(-S // split_rows) > MAX_SPLITS:
            raise ValueError(f"split_rows {split_rows} is not a positive multiple of "
                             f"{SPLIT_TILE} giving at most {MAX_SPLITS} splits of S={S}")
        n_splits = -(-S // split_rows)
        # per (batch row, q head, split): m, l and acc[D] in fp32
        ws = torch.empty(B * Hq * n_splits * (D + 2), dtype=torch.float32, device=q.device)
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
                       valid_len.data_ptr(), out.data_ptr(),
                       ws.data_ptr() if ws is not None else None, strides,
                       B, Hq, Hc, S, D, DTYPE_CODES[q.dtype], DTYPE_CODES[k.dtype],
                       1.0 / math.sqrt(D), split_rows, n_splits, PATH_CODES[path],
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention {path} kernel: {build.error_text(rc)}")
    launches += 1
    launches_by_path[path] += 1
    return out
