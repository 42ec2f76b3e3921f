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


def _contiguous_strides(E, C, d, f):
    """The non-last strides of contiguous x (E, C, d), w (E, d, f), out (E, C, f)."""
    return (C * d, d, d * f, f, C * f, f)


@pytest.mark.parametrize("dtype,E,C,d,f,align,want", [
    # phi3.5-moe's prefill capacity of a 1024-token prompt, both directions
    ("bfloat16", 16, 160, 4096, 6400, 256, "wgmma"),
    ("bfloat16", 16, 160, 6400, 4096, 256, "wgmma"),
    ("bfloat16", 8, 160, 7168, 4864, 256, "wgmma"),      # arctic's width
    ("bfloat16", 16, 33, 4096, 6400, 16, "wgmma"),       # bases just aligned enough
    ("bfloat16", 16, 4, 4096, 6400, 256, "wgmma"),       # the decode capacity
    # fp32 stays on the CUDA cores: the row kernel up to ROWS_MAX_C, tiled above
    ("float32", 16, 4, 4096, 6400, 256, "rows"),
    ("float32", 16, 32, 4096, 6400, 256, "rows"),
    ("float32", 16, 160, 4096, 6400, 256, "tiled"),
    # bf16 whose rows TMA cannot stride (not a multiple of 16 bytes)
    ("bfloat16", 3, 20, 200, 36, 256, "rows"),           # w and out rows of 72 bytes
    ("bfloat16", 3, 160, 300, 264, 256, "tiled"),        # x rows of 600 bytes
    ("bfloat16", 16, 160, 4096, 6400, 8, "tiled"),       # a base 8-byte aligned
])
def test_moe_gmm_route_picks_the_kernel_from_shapes(dtype, E, C, d, f, align, want):
    """`route` decides before the launch, from dtype, C, strides and
    alignment: the tensor-core kernel for bf16 that TMA can read, the
    CUDA-core kernels for fp32 and for strides TMA cannot take."""
    td = DTYPES[dtype][1]
    assert gk.route(td, C, d, _contiguous_strides(E, C, d, f), align) == want


def test_moe_gmm_route_of_the_moe_layers_expert_major_view():
    """The (E, G*C, d) view the MoE layer hands over (models/moe.py) and its
    contiguous expert weights go to the tensor-core kernel in bf16 and to
    the tiled kernel in fp32."""
    G, E, C, d, f = 2, 4, 40, 64, 96
    for td, want in ((torch.bfloat16, "wgmma"), (torch.float32, "tiled")):
        slots = torch.zeros((G, E * C, d), dtype=td)
        xe = slots.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
        w = torch.zeros((E, d, f), dtype=td)
        out = torch.empty((E, G * C, f), dtype=td)
        assert gk.route_for(xe, w, out) == want


def _flash_inputs(dtype, B, T, Hq, Hkv, D, layout):
    """q, k, v as `layout` lays them out: "model" is the (B,T,H,D)
    projections read as (B,H,T,D) views (models/layers.py::attention);
    "offset" the same with every base one element past an aligned address;
    "padded" a head stride of D + 4 elements, 8 bytes past a multiple of 16."""
    def one(H):
        if layout == "padded":
            return torch.zeros((B, T, H, D + 4), dtype=dtype)[..., :D].transpose(1, 2)
        skip = 1 if layout == "offset" else 0
        buf = torch.zeros(B * T * H * D + skip, dtype=dtype)[skip:]
        return buf.view(B, T, H, D).transpose(1, 2)
    return one(Hq), one(Hkv), one(Hkv)


@pytest.mark.parametrize("dtype,B,T,Hq,Hkv,D,layout,want", [
    ("bfloat16", 1, 1024, 32, 8, 128, "model", "wgmma"),    # llama3-8b
    ("bfloat16", 4, 1024, 32, 32, 80, "model", "wgmma"),    # zamba2-2.7b
    ("bfloat16", 1, 77, 32, 8, 160, "model", "wgmma"),      # stablelm-12b
    ("bfloat16", 2, 1, 4, 2, 16, "model", "wgmma"),         # the smallest head dim, T = 1
    ("float32", 1, 1024, 32, 8, 128, "model", "simt"),      # fp32 stays on the CUDA cores
    ("bfloat16", 1, 64, 32, 8, 128, "offset", "simt"),      # bases 2 bytes off alignment
    ("bfloat16", 1, 64, 32, 8, 128, "padded", "simt"),      # strides TMA cannot take
])
def test_flash_route_picks_the_kernel(dtype, B, T, Hq, Hkv, D, layout, want):
    """`route` decides before the launch, from dtype, head dim, strides and
    alignment: the tensor-core kernel for bf16 that TMA can read, the
    CUDA-core kernel for fp32 and for what TMA cannot read."""
    q, k, v = _flash_inputs(DTYPES[dtype][1], B, T, Hq, Hkv, D, layout)
    assert fk.route_for(q, k, v) == want
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    align = 256 if layout == "model" else 2 if layout == "offset" else 16
    assert fk.route(q.dtype, D, strides, align) == want


# ------------------------------------------------------------- decode's split grid

H100_SMS = 132
# (B, Hc, S, D) of the serving paths' decode calls (chip_smoke.py phases 3-7)
DECODE_PATH_SHAPES = [
    (8, 16, 2048, 128),   # llama3-8b and phi3.5-moe: 8 slots, cache replicated to 16
    (4, 16, 2048, 128),   # phase 5's int8 cache
    (4, 32, 1056, 80),    # zamba2-2.7b's rolling cache
    (8, 48, 2048, 128),   # qwen1.5-32b's padded heads
    (8, 16, 2048, 160),   # stablelm-12b's head dim
]


@pytest.mark.parametrize("B,Hc,S,D", DECODE_PATH_SHAPES)
def test_decode_plan_gives_several_ctas_per_sm_at_the_paths_shapes(B, Hc, S, D):
    rows, n = dk.plan(B, Hc, S, D, H100_SMS)
    assert B * Hc * n >= 4 * H100_SMS
    assert rows % dk.SPLIT_TILE == 0 and rows >= 2 * dk.SPLIT_TILE


@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 65, 127, 1056, 2048, 4097, 100_000])
@pytest.mark.parametrize("B,Hc,D", [(1, 1, 16), (8, 16, 128), (4, 32, 80), (2, 3, 160)])
def test_decode_plan_splits_cover_s_exactly_once(B, Hc, S, D):
    """Split i holds rows [i * rows, (i + 1) * rows): every row of S lies in
    one split, and no split starts at or past S."""
    rows, n = dk.plan(B, Hc, S, D, H100_SMS)
    assert rows % dk.SPLIT_TILE == 0
    assert (n - 1) * rows < S <= n * rows


def test_decode_plan_depends_on_shapes_only():
    """plan takes the shapes and the SM count, and nothing of valid_len."""
    import inspect
    assert list(inspect.signature(dk.plan).parameters) == ["B", "Hc", "S", "D", "n_sm"]
    assert dk.plan(8, 16, 2048, 128, H100_SMS) == (256, 8)
    with pytest.raises(ValueError, match="positive"):
        dk.plan(8, 16, 0, 128, H100_SMS)


@pytest.mark.parametrize("vl_a,vl_b", [(1, 2048), (0, 777)])
def test_decode_wrapper_launches_the_same_grid_whatever_valid_len(monkeypatch, vl_a, vl_b):
    """The wrapper hands the kernel plan's grid and valid_len's device
    pointer, never its values: two batches at different lengths get the
    same launch, so a decode step can be captured in a graph."""
    import contextlib
    import types
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(dk, "_check", lambda *a: None)
    monkeypatch.setattr(dk, "_kernel", lambda: fake_kernel)
    monkeypatch.setattr(dk, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(dk, "launches", dk.launches)
    monkeypatch.setattr(dk, "launches_by_path", dict(dk.launches_by_path))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    B, Hq, Hc, S, D = 8, 32, 16, 2048, 128
    q = torch.zeros((B, Hq, D), dtype=torch.bfloat16)
    k, v = (torch.zeros((B, S, Hc, D), dtype=torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    for n in (vl_a, vl_b):
        dk.decode_attention(q, k, v, torch.full((B,), n, dtype=torch.int32))
    # (split_rows, n_splits, path) of each launch
    grids = [c[17:20] for c in calls]
    assert grids == [(*dk.plan(B, Hc, S, D, H100_SMS), dk.PATH_CODES["split"])] * 2
    assert dk.launches_by_path == {"split": 2, "simt": 0}
    # a named split length replaces plan's; one that is no multiple of the
    # tile raises before a launch
    dk.decode_attention(q, k, v, torch.full((B,), vl_a, dtype=torch.int32), split_rows=512)
    assert calls[-1][17:20] == (512, 4, dk.PATH_CODES["split"])
    with pytest.raises(ValueError, match="split_rows"):
        dk.decode_attention(q, k, v, torch.full((B,), vl_a, dtype=torch.int32), split_rows=100)
    assert len(calls) == 3


def _cache_views(dtype, B, S, Hc, D, layout):
    """A cache k/v as `layout` lays it out: "model" is layer 1 of an (L, B,
    S, Hc, D) buffer read as (B, Hc, S, D) (models/dense.py::_decode_attend);
    "offset" the same view of a buffer one element past an aligned address;
    "padded" a head stride of D + 4 elements."""
    def one():
        if layout == "padded":
            return torch.zeros((B, S, Hc, D + 4), dtype=dtype)[..., :D].transpose(1, 2)
        skip = 1 if layout == "offset" else 0
        buf = torch.zeros(2 * B * S * Hc * D + skip, dtype=dtype)[skip:]
        return buf.view(2, B, S, Hc, D)[1].transpose(1, 2)
    return one(), one()


@pytest.mark.parametrize("dtype,B,S,Hc,D,layout,want", [
    (torch.bfloat16, 8, 2048, 16, 128, "model", "split"),   # llama3-8b, phi3.5-moe
    (torch.bfloat16, 4, 1056, 32, 80, "model", "split"),    # zamba2-2.7b
    (torch.int8, 8, 2048, 48, 128, "model", "split"),       # qwen1.5-32b's int8 cache
    (torch.int8, 2, 64, 1, 16, "model", "split"),           # int8 rows of 16 bytes
    (torch.float32, 3, 200, 16, 160, "model", "split"),
    (torch.bfloat16, 2, 64, 4, 128, "offset", "simt"),      # bases 2 bytes off
    (torch.int8, 2, 64, 4, 128, "offset", "simt"),          # bases 1 byte off
    (torch.bfloat16, 2, 64, 4, 128, "padded", "simt"),      # rows of 264 bytes
    (torch.int8, 2, 64, 3, 16, "padded", "simt"),           # rows of 20 bytes
    (torch.bfloat16, 2, 0, 4, 128, "model", "simt"),        # S = 0: no tensor map
])
def test_decode_route_picks_the_kernel(dtype, B, S, Hc, D, layout, want):
    """`route` decides before the launch, from dtype, shapes, strides and
    alignment: the split kernel wherever TMA can read the cache, the first
    version for the rest."""
    k, v = _cache_views(dtype, B, S, Hc, D, layout)
    assert dk.route_for(k, v) == want
    strides = (*k.stride()[:3], *v.stride()[:3])
    align = {"model": 256, "offset": dtype.itemsize, "padded": 16}[layout]
    assert dk.route(dtype, D, S, strides, align) == want


# ------------------------------------------------------------- the SSD scan's route and plan

def _ssd_views(dtype, B, T, H, P, G, N, layout):
    """x, Bm, Cm as `layout` lays them out: "model" is the bf16 model's fp32
    copies (B,T,H,P) and (B,T,G,N) read as (B,H,T,P) / (B,G,T,N) views
    (models/mamba2.py::mamba_fwd); "model32" the fp32 model's, slices of one
    (B,T,d_in + 2GN) conv output; "offset" the "model" views of buffers one
    element past an aligned address; "padded" a head stride of P + 1
    elements."""
    if layout == "model32":
        xbc = torch.zeros((B, T, H * P + 2 * G * N), dtype=dtype)
        x = xbc[..., :H * P].reshape(B, T, H, P)
        Bm, Cm = xbc[..., H * P:].reshape(B, T, 2 * G, N).split(G, dim=2)
        return x.transpose(1, 2), Bm.transpose(1, 2), Cm.transpose(1, 2)
    skip = 1 if layout == "offset" else 0

    def one(*shape):
        n = int(np.prod(shape))
        return torch.zeros(n + skip, dtype=dtype)[skip:].view(*shape).transpose(1, 2)
    if layout == "padded":
        x = torch.zeros((B, T, H, P + 1), dtype=dtype)[..., :P].transpose(1, 2)
    else:
        x = one(B, T, H, P)
    return x, one(B, T, G, N), one(B, T, G, N)


@pytest.mark.parametrize("dtype,B,T,H,P,G,N,chunk,layout,want", [
    ("float32", 4, 1024, 80, 64, 1, 64, 256, "model", "mma"),     # zamba2-2.7b's prefill
    ("float32", 1, 256, 80, 64, 1, 64, 256, "model", "mma"),      # one chunk
    ("float32", 4, 4096, 80, 64, 1, 64, 256, "model", "mma"),
    ("float32", 2, 1024, 80, 64, 1, 64, 256, "model32", "mma"),   # the fp32 model's slices
    ("float32", 2, 512, 8, 64, 2, 64, 64, "model", "mma"),        # G = 2, the smallest chunk
    ("float32", 2, 384, 8, 64, 2, 64, 128, "model", "mma"),
    ("bfloat16", 4, 1024, 80, 64, 1, 64, 256, "model", "simt"),   # bf16 stays on the CUDA cores
    ("float32", 2, 256, 4, 16, 1, 16, 32, "model", "simt"),       # zamba2 SMOKE: P = N = 16, chunk 32
    ("float32", 2, 256, 4, 64, 1, 64, 32, "model", "simt"),       # a chunk of 32 at P = N = 64
    ("float32", 2, 96, 4, 64, 1, 64, 96, "model", "simt"),        # a chunk of 96
    ("float32", 1, 48, 4, 64, 1, 64, 256, "model", "simt"),       # T < 64: the chunk is T
    ("float32", 2, 256, 4, 32, 1, 64, 256, "model", "simt"),      # P = 32
    ("float32", 2, 256, 4, 64, 1, 32, 256, "model", "simt"),      # N = 32
    ("float32", 2, 256, 4, 64, 1, 64, 256, "offset", "simt"),     # bases 4 bytes off
    ("float32", 2, 256, 4, 64, 1, 64, 256, "padded", "simt"),     # rows of 260 bytes
])
def test_ssd_route_picks_the_kernel(dtype, B, T, H, P, G, N, chunk, layout, want):
    """`route` decides before the launch, from dtype, chunk, widths,
    strides and alignment: the tensor-core path for fp32 that TMA can read
    at P = N = 64 and a chunk that is a multiple of 64 up to 256, the first
    version for the rest."""
    x, Bm, Cm = _ssd_views(DTYPES[dtype][1], B, T, H, P, G, N, layout)
    assert sk.route_for(x, Bm, Cm, chunk=chunk) == want
    strides = (*x.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3])
    align = 4 if layout == "offset" else 256
    assert sk.route(x.dtype, min(chunk, T), P, N, strides, align) == want


@pytest.mark.parametrize("T,nc", [(256, 1), (1024, 4), (4096, 16)])
def test_ssd_plan_gives_grids_and_workspaces_from_shapes(T, nc):
    """zamba2-2.7b's prefill widths (B=4, H=80, P=N=64, chunk 256): (a) one
    CTA per (chunk, head, batch row), (b) 4 per (head, batch row), (c) one
    per (64-row tile, chunk, head, batch row); dS (B,H,nc,P,N) and la
    (B,H,T) in fp32."""
    pl = sk.plan(4, 80, T, 256, 64, 64)
    assert pl.chunk_grid == (nc, 80, 4)
    assert pl.state_grid == (4, 80, 4)
    assert pl.out_grid == (4 * nc, 80, 4)
    assert pl.ds_shape == (4, 80, nc, 64, 64) and pl.la_shape == (4, 80, T)
    assert np.prod(pl.out_grid) == 4 * nc * 80 * 4   # 5120 CTAs at T = 1024


def test_ssd_plan_depends_on_shapes_only():
    import inspect
    assert list(inspect.signature(sk.plan).parameters) == ["B", "H", "T", "Q", "P", "N"]
    assert sk.plan(1, 2, 128, 64, 64, 64).out_grid == (2, 2, 1)
    assert sk.plan(2, 8, 512, 128, 64, 64).out_grid == (8, 8, 2)
    with pytest.raises(ValueError, match="positive"):
        sk.plan(4, 80, 0, 256, 64, 64)
    with pytest.raises(ValueError, match="multiple"):
        sk.plan(4, 80, 1000, 256, 64, 64)
    with pytest.raises(ValueError, match="multiple"):
        sk.plan(4, 80, 960, 96, 64, 64)


def test_ssd_wrapper_hands_the_kernel_plans_grids(monkeypatch):
    """The wrapper hands the C entry the path route names, plan's grids and
    workspaces of plan's shapes, and counts one launch a call by path;
    naming the tensor-core path for bf16 raises before a launch."""
    import contextlib
    import types
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(sk, "_check", lambda *a: None)
    monkeypatch.setattr(sk, "_kernel", lambda: fake_kernel)
    monkeypatch.setattr(sk, "launches", sk.launches)
    monkeypatch.setattr(sk, "launches_by_path", dict(sk.launches_by_path))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    B, T, H, P, G, N = 2, 512, 8, 64, 2, 64
    x, Bm, Cm = _ssd_views(torch.float32, B, T, H, P, G, N, "model")
    dt, A = torch.zeros((B, T, H)).transpose(1, 2), torch.zeros(H)
    y, s = sk.ssd_scan(x, dt, A, Bm, Cm, chunk=256)
    assert y.shape == x.shape and y.stride() == x.stride() and s.shape == (B, H, P, N)
    args = calls[-1]
    assert args[16] == sk.PATH_CODES["mma"]
    assert args[17] and args[18]   # the dS and la workspaces
    pl = sk.plan(B, H, T, 256, P, N)
    assert tuple(args[19]) == (*pl.chunk_grid, *pl.state_grid, *pl.out_grid)
    sk.ssd_scan(x, dt, A, Bm, Cm, chunk=256, path="simt")
    assert calls[-1][16] == sk.PATH_CODES["simt"] and calls[-1][17] is None
    assert sk.launches_by_path == {"mma": 1, "simt": 1}
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    with pytest.raises(ValueError, match="cannot take"):
        sk.ssd_scan(xb, dt, A, Bb, Cb, chunk=256, path="mma")
    assert len(calls) == 2
