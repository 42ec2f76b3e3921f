"""The port's kernels (src/repro_torch/kernels) against the JAX package.

On the CPU the port's entry points run the plain PyTorch versions; they are
held to the Pallas kernels in interpret mode (`repro.kernels.ops`) and to
the jnp oracles (`repro.kernels.ref`) at the shapes and tolerances of
tests/test_kernels.py: attention fp32 2e-5, bf16 2e-2, int8 1e-4; grouped
matmul fp32 1e-4, bf16 5e-2; SSD scan fp32 1e-5 against the Pallas kernel
(the same chunked algorithm) and 2e-4 against the sequential recurrence (as
tests/test_kernels.py holds the Pallas kernel to it). The CUDA kernels have
no CPU mode; tests/test_torch_cuda.py holds them to the plain versions on
the card.

Inputs are drawn with numpy from a seed and handed to both sides; bf16
inputs are rounded from the same fp32 values on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import moe_gmm as gk
from repro_torch.kernels import ssm_scan as sk

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def _pair(rng, shape, dtype="float32"):
    """The same random values as a JAX array and a torch tensor."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------- flash attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,D,bq,bk", [
    (1, 2, 2, 64, 32, 32, 32),        # MHA
    (2, 4, 2, 128, 64, 64, 32),       # GQA 2:1
    (1, 8, 2, 128, 32, 32, 64),       # GQA 4:1, uneven blocks
    (2, 2, 1, 256, 16, 128, 128),     # long-ish
])
def test_flash_plain_matches_jax(B, Hq, Hkv, T, D, bq, bk, dtype):
    rng = np.random.default_rng(B * T + Hq)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, (B, H, T, D), dtype)
                                 for H in (Hq, Hkv, Hkv))
    got = ops.flash_attention(q, k, v, causal=True)
    _close(got, jops.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                     block_k=bk), **_tol(dtype))
    _close(got, jref.attention_ref(jq, jk, jv, causal=True), **_tol(dtype))
    assert got.dtype == q.dtype and got.shape == q.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,bq", [(1, 4, 4, 64, 32), (2, 4, 2, 96, 32)])
def test_flash_plain_matches_jax_at_head_dim_80(B, Hq, Hkv, T, bq, dtype):
    """zamba2's attention head dim, 2560 / 32 = 80."""
    rng = np.random.default_rng(T + 80)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, (B, H, T, 80), dtype) for H in (Hq, Hkv, Hkv))
    got = ops.flash_attention(q, k, v, causal=True)
    _close(got, jops.flash_attention(jq, jk, jv, causal=True, block_q=bq, block_k=bq),
           **_tol(dtype))
    _close(got, jref.attention_ref(jq, jk, jv, causal=True), **_tol(dtype))


@pytest.mark.parametrize("causal,window", [(True, 32), (False, None)])
def test_flash_plain_window_and_noncausal(causal, window):
    rng = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, (2, 2, 128, 32)) for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    _close(got, jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                     block_q=32, block_k=32), atol=2e-5, rtol=2e-5)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal, window=window),
           atol=2e-5, rtol=2e-5)


def test_flash_plain_q_offset_conventions():
    """Tq != Tk: flash attention lines up the starts (the Pallas kernel's
    convention), attention_ref the ends (the jnp oracle's)."""
    rng = np.random.default_rng(1)
    jq, q = _pair(rng, (1, 4, 64, 32))
    (jk, k), (jv, v) = (_pair(rng, (1, 2, 128, 32)) for _ in range(2))
    _close(ops.flash_attention(q, k, v),
           jops.flash_attention(jq, jk, jv, block_q=32, block_k=32),
           atol=2e-5, rtol=2e-5)
    _close(ref.attention_ref(q, k, v), jref.attention_ref(jq, jk, jv),
           atol=2e-5, rtol=2e-5)


def test_flash_plain_reads_model_layout_through_strides():
    """The model hands (B,T,H,D) tensors over as (B,H,T,D) views."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 48, H, 32)).astype(np.float32))
               for H in (4, 2, 2))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = ops.flash_attention(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# ------------------------------------------------------------- decode attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (2, 4, 2, 128, 32),
    (1, 8, 8, 256, 64),
    (3, 2, 1, 64, 16),
])
def test_decode_plain_matches_jax(B, Hq, Hkv, S, D, dtype):
    rng = np.random.default_rng(S + Hq)
    jq, q = _pair(rng, (B, Hq, D), dtype)
    (jk, k), (jv, v) = (_pair(rng, (B, Hkv, S, D), dtype) for _ in range(2))
    vl = np.arange(1, B + 1, dtype=np.int32) * (S // (B + 1)) + 1
    got = ops.decode_attention(q, k, v, torch.from_numpy(vl))
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(vl), block_k=S // 2),
           **_tol(dtype))
    _close(got, jref.attention_ref(jq[:, :, None], jk, jv, causal=False,
                                   valid_len=jnp.asarray(vl))[:, :, 0], **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S", [(2, 4, 4, 64), (3, 8, 2, 128)])
def test_decode_plain_matches_jax_at_head_dim_80(B, Hq, Hkv, S, dtype):
    rng = np.random.default_rng(S + 80)
    jq, q = _pair(rng, (B, Hq, 80), dtype)
    (jk, k), (jv, v) = (_pair(rng, (B, Hkv, S, 80), dtype) for _ in range(2))
    vl = np.arange(1, B + 1, dtype=np.int32) * (S // (B + 1)) + 1
    got = ops.decode_attention(q, k, v, torch.from_numpy(vl))
    _close(got, jops.decode_attention(jq, jk, jv, jnp.asarray(vl), block_k=S // 2),
           **_tol(dtype))


def test_decode_plain_int8_cache_matches_jax():
    B, Hq, Hkv, S, D = 2, 4, 2, 128, 32
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kf = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    vf = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    ksc = np.abs(kf).max(-1, keepdims=True) / 127.0
    vsc = np.abs(vf).max(-1, keepdims=True) / 127.0
    k8 = np.round(kf / ksc).astype(np.int8)
    v8 = np.round(vf / vsc).astype(np.int8)
    vl = np.array([64, 128], np.int32)
    t = torch.from_numpy
    got = ops.decode_attention(t(q), t(k8), t(v8), t(vl), t(ksc), t(vsc))
    j = jnp.asarray
    _close(got, jops.decode_attention(j(q), j(k8), j(v8), j(vl), k_scale=j(ksc),
                                      v_scale=j(vsc), block_k=64), atol=1e-4, rtol=1e-4)
    _close(got, jref.attention_ref(j(q)[:, :, None], j(k8), j(v8), causal=False,
                                   valid_len=j(vl), kv_scale=j(ksc),
                                   v_scale=j(vsc))[:, :, 0], atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- grouped matmul

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f,bc,bd,bf", [
    (2, 64, 128, 64, 32, 64, 32),
    (4, 32, 64, 128, 32, 32, 64),
    (8, 16, 32, 32, 16, 32, 32),
])
def test_moe_gmm_plain_matches_jax(E, C, d, f, bc, bd, bf, dtype):
    """The shapes of tests/test_kernels.py::test_moe_gmm_sweep."""
    rng = np.random.default_rng(E + C)
    (jx, x), (jw, w) = _pair(rng, (E, C, d), dtype), _pair(rng, (E, d, f), dtype)
    got = ops.moe_gmm(x, w)
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    assert got.dtype == x.dtype and got.shape == (E, C, f)
    _close(got, jops.moe_gmm(jx, jw, block_c=bc, block_d=bd, block_f=bf), **tol)
    _close(got, jref.moe_gmm_ref(jx, jw), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_takes_a_ragged_capacity(dtype):
    """C=20 does not divide any Pallas block; the port takes it (and d, f
    off any tile), held to the JAX oracle."""
    rng = np.random.default_rng(20)
    (jx, x), (jw, w) = _pair(rng, (3, 20, 40), dtype), _pair(rng, (3, 40, 24), dtype)
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    _close(ops.moe_gmm(x, w), jref.moe_gmm_ref(jx, jw), **tol)


# ------------------------------------------------------------- SSD scan

def _ssd_inputs(rng, B, H, T, P, G, N):
    """The distributions of tests/test_kernels.py::test_ssd_scan_vs_sequential,
    in the kernel's (B,H,T,P) / (B,G,T,N) layout."""
    x = rng.standard_normal((B, H, T, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, H, T)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, G, T, N)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((B, G, T, N)).astype(np.float32) * 0.5
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,H,T,P,G,N,chunk", [
    (1, 2, 64, 16, 1, 8, 16),
    (2, 4, 64, 32, 2, 16, 32),
    (1, 2, 128, 16, 2, 8, 16),
])
def test_ssd_scan_plain_matches_jax(B, H, T, P, G, N, chunk):
    """The shapes of tests/test_kernels.py::test_ssd_scan_vs_sequential:
    y and the final state against the Pallas kernel, y against the
    sequential recurrence of both packages."""
    args = _ssd_inputs(np.random.default_rng(T + P), B, H, T, P, G, N)
    t = [torch.from_numpy(a) for a in args]
    y, s = ops.ssd_scan(*t, chunk=chunk)
    jy, js = jops.ssd_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    assert y.dtype == torch.float32 and s.shape == (B, H, P, N)
    _close(y, jy, atol=1e-5, rtol=1e-5)
    _close(s, js, atol=1e-5, rtol=1e-5)
    x, dt, A, Bm, Cm = args
    seq = ref.ssd_chunk_ref(*(torch.from_numpy(a) for a in (
        x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), A, Bm.transpose(0, 2, 1, 3),
        Cm.transpose(0, 2, 1, 3))))
    jseq = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in (
        x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), A, Bm.transpose(0, 2, 1, 3),
        Cm.transpose(0, 2, 1, 3))), chunk)
    _close(seq, jseq, atol=1e-5, rtol=1e-5)
    _close(y.transpose(1, 2), seq.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("chunk,T", [(16, 16), (16, 32), (16, 64), (32, 32), (32, 64)])
def test_ssd_scan_plain_chunk_invariance(chunk, T):
    """The port of tests/test_kernels.py::test_ssd_chunk_invariance: the
    chunked result does not depend on the chunk size."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(
        np.random.default_rng(chunk * T), 1, 2, T, 16, 1, 8)]
    y1, s1 = ops.ssd_scan(*args, chunk=chunk)
    y2, s2 = ops.ssd_scan(*args, chunk=T)
    _close(y1, y2.numpy(), atol=2e-4, rtol=2e-4)
    _close(s1, s2.numpy(), atol=2e-4, rtol=2e-4)


def test_ssd_scan_plain_bf16_returns_y_in_x_dtype():
    """bf16 x, B, C: y comes back in bf16 and the state in fp32, as from the
    Pallas kernel; both agree with it to bf16 rounding."""
    args = _ssd_inputs(np.random.default_rng(5), 1, 2, 64, 16, 1, 8)
    bf = [1, 0, 0, 1, 1]   # x, B, C in bf16; dt and A stay fp32
    t = [torch.from_numpy(a).to(torch.bfloat16) if b else torch.from_numpy(a)
         for a, b in zip(args, bf)]
    j = [jnp.asarray(a).astype(jnp.bfloat16) if b else jnp.asarray(a)
         for a, b in zip(args, bf)]
    y, s = ops.ssd_scan(*t, chunk=16)
    jy, js = jops.ssd_scan(*j, chunk=16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close(y, jy, atol=2e-2, rtol=2e-2)
    _close(s, js, atol=2e-2, rtol=2e-2)


# ------------------------------------------------------------- dispatch and build

def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 16, 16)).astype(np.float32))
               for _ in range(3))
    before = (fk.launches, dk.launches)
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ref.flash_attention_ref(q, k, v), atol=0, rtol=0)
    vl = torch.tensor([7], dtype=torch.int32)
    torch.testing.assert_close(ops.decode_attention(q[:, :, 0], k, v, vl),
                               ref.decode_attention_ref(q[:, :, 0], k, v, vl),
                               atol=0, rtol=0)
    assert (fk.launches, dk.launches) == before


def test_cpu_tensors_take_the_plain_gmm_and_scan_without_a_launch():
    rng = np.random.default_rng(4)
    x, w = torch.randn(2, 4, 8), torch.randn(2, 8, 16)
    args = [torch.from_numpy(a) for a in _ssd_inputs(rng, 1, 2, 16, 8, 1, 4)]
    before = (gk.launches, sk.launches)
    torch.testing.assert_close(ops.moe_gmm(x, w), ref.moe_gmm_ref(x, w), atol=0, rtol=0)
    for got, want in zip(ops.ssd_scan(*args, chunk=8), ref.ssd_scan_ref(*args, chunk=8)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (gk.launches, sk.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch on CUDA tensors or raise; they never run the plain
    version themselves."""
    x = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        dk.decode_attention(x[:, :, 0], x, x, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        gk.moe_gmm(x[0], x[0])
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_scan(x, x[..., 0], x[0, 0, 0], x, x)


def test_build_targets_hopper_and_names_libraries_by_source():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    paths = {n: build.library_path(n) for n in build.SOURCES}
    assert all(p.parent == build.BUILD_DIR for p in paths.values())
    assert len(set(paths.values())) == len(build.SOURCES)
    assert all((build.CSRC / f"{n}.cu").exists() for n in build.SOURCES)
