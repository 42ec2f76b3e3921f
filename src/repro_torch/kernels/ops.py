"""Public kernel entry points, with the names of the JAX package's
`kernels/ops.py`. A CUDA tensor goes to the hand-written kernel (a build or
launch error propagates); a CPU tensor goes to the plain PyTorch version in
`ref.py`. The tensor's device decides, and nothing else.

The CUDA kernels' outputs carry no `grad_fn`, so a gradient through one
would silently leave its inputs out. A CUDA call with grad enabled and an
input that requires grad therefore raises (`check_no_grad`). Training
differentiates each kernel through a `torch.autograd.Function` that calls
it under no_grad: attention through `models/flash_vjp.py`, the grouped
matmul through `models/moe.py::GroupedMatmul` (whose backward is the two
products `moe_gmm_dx` and `moe_gmm_dw`), the SSD scan through
`models/mamba2.py::SSDScan`. The plain versions are differentiable, so a
CPU call never raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssd


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


def _on_cuda(t) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, return_lse: bool = False):
    """q (B,Hq,Tq,D); k/v (B,Hkv,Tk,D); query row i at key position i.
    `return_lse` returns (out, fp32 (B,Hq,Tq) row log-sum-exp)."""
    if _on_cuda(q):
        check_no_grad("flash_attention", q, k, v)
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      return_lse=return_lse)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=return_lse)


def decode_attention(q, k, v, valid_len, k_scale=None, v_scale=None):
    """q (B,Hq,D); k/v cache (B,Hc,S,D) [+ int8 scales]; valid_len (B,)."""
    if _on_cuda(q):
        check_no_grad("decode_attention", q, k, v, k_scale, v_scale)
        return _decode.decode_attention(q, k, v, valid_len, k_scale, v_scale)
    return ref.decode_attention_ref(q, k, v, valid_len, k_scale, v_scale)


def moe_gmm(x, w):
    """Grouped expert matmul: (E,C,d) @ (E,d,f) -> (E,C,f)."""
    if _on_cuda(x):
        check_no_grad("moe_gmm", x, w)
        return _gmm.moe_gmm(x, w)
    return ref.moe_gmm_ref(x, w)


def moe_gmm_dx(dy, w):
    """The input gradient of moe_gmm: (E,C,f) @ (E,d,f)^T -> (E,C,d)."""
    if _on_cuda(dy):
        check_no_grad("moe_gmm", dy, w)
        return _gmm.moe_gmm_dx(dy, w)
    return ref.moe_gmm_dx_ref(dy, w)


def moe_gmm_dw(x, dy):
    """The weight gradient of moe_gmm: (E,C,d)^T @ (E,C,f) -> (E,d,f)."""
    if _on_cuda(x):
        check_no_grad("moe_gmm", x, dy)
        return _gmm.moe_gmm_dw(x, dy)
    return ref.moe_gmm_dw_ref(x, dy)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """Mamba2 SSD: x (B,H,T,P), dt (B,H,T), A (H,), Bm/Cm (B,G,T,N)."""
    if _on_cuda(x):
        check_no_grad("ssd_scan", x, dt, A, Bm, Cm)
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)


__all__ = ["flash_attention", "decode_attention", "moe_gmm", "moe_gmm_dx", "moe_gmm_dw",
           "ssd_scan", "ref"]
