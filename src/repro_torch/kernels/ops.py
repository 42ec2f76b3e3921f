"""Public kernel entry points, with the names of the JAX package's
`kernels/ops.py`. A CUDA tensor goes to the hand-written kernel (a build or
launch error propagates); a CPU tensor goes to the plain PyTorch version in
`ref.py`. The tensor's device decides, and nothing else."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssd


def _on_cuda(t) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """q (B,Hq,Tq,D); k/v (B,Hkv,Tk,D); query row i at key position i."""
    if _on_cuda(q):
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, valid_len, k_scale=None, v_scale=None):
    """q (B,Hq,D); k/v cache (B,Hc,S,D) [+ int8 scales]; valid_len (B,)."""
    if _on_cuda(q):
        return _decode.decode_attention(q, k, v, valid_len, k_scale, v_scale)
    return ref.decode_attention_ref(q, k, v, valid_len, k_scale, v_scale)


def moe_gmm(x, w):
    """Grouped expert matmul: (E,C,d) @ (E,d,f) -> (E,C,f)."""
    if _on_cuda(x):
        return _gmm.moe_gmm(x, w)
    return ref.moe_gmm_ref(x, w)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """Mamba2 SSD: x (B,H,T,P), dt (B,H,T), A (H,), Bm/Cm (B,G,T,N)."""
    if _on_cuda(x):
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)


__all__ = ["flash_attention", "decode_attention", "moe_gmm", "ssd_scan", "ref"]
