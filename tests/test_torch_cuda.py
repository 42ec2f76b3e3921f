"""The port's CUDA kernels and its serving path on the card.

The kernels have no CPU mode, so every test here is marked `cuda` and skips
without an NVIDIA GPU. This file imports no JAX: it runs on a machine with
the card and PyTorch alone,

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version (kernels/ref.py, itself held
to the JAX package by tests/test_torch_kernels.py) at the shapes of
tests/test_kernels.py and the main paths', with its tolerances: attention
fp32 2e-5, bf16 2e-2, int8 1e-4; grouped matmul fp32 1e-4, bf16 5e-2 (as
tests/test_kernels.py); SSD scan fp32 1e-4 (sums of up to 256 products in
another order, with exp of the summed decays), bf16 2e-2. The flash
tensor-core kernel is also held to the CUDA-core kernel's distance from an
fp32 run (within 5%), which fails if P is rounded to bf16 before P.V; the
SSD scan's tensor-core path to 2x the first version's distance from fp64.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import moe_gmm as gk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as sk
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="session")
def cuda():
    """The card, with its context started and the kernels built once per
    session (starting the context opens a socket that lives as long as the
    process, which tests/conftest.py would otherwise charge to a test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    build.build()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,D,causal,window", [
    (1, 2, 2, 64, 32, True, None),
    (2, 4, 2, 128, 64, True, None),
    (1, 8, 2, 100, 32, True, None),     # tail: T does not divide the tile
    (2, 2, 1, 256, 16, True, None),
    (1, 2, 2, 128, 32, True, 32),
    (2, 2, 2, 64, 32, False, None),
    (1, 32, 8, 17, 128, True, None),
    (2, 32, 32, 100, 80, True, None),   # zamba2's head dim
    (1, 32, 8, 70, 160, True, None),    # stablelm-12b's head dim
    (1, 32, 8, 1, 128, True, None),     # one query: one q tile, one key tile
    (1, 32, 8, 2048, 128, True, None),  # 32 key tiles, many laps of the ring
    (2, 4, 2, (100, 300), 64, True, None),   # Tq != Tk, starts lined up
    (2, 4, 2, (300, 100), 64, True, None),
    (2, 4, 2, (200, 330), 64, False, None),
    (1, 4, 2, 300, 64, True, 100),      # a window that starts mid-tile and spans tiles
    (1, 4, 2, 300, 64, False, 70),
    (2, 4, 4, 150, 16, True, None),     # every head dim of the wrapper
    (2, 4, 4, 150, 32, True, None),
    (2, 4, 4, 150, 64, True, None),
    (2, 4, 4, 150, 80, True, None),
    (2, 4, 4, 150, 128, True, None),
    (2, 4, 4, 150, 160, True, None),
    (4, 32, 32, 1024, 80, True, None),  # zamba2's prefill: B = 4
])
def test_flash_kernel_matches_plain_on_cuda(cuda, B, Hq, Hkv, T, D, causal,
                                            window, dtype):
    """The model's (B,T,H,D) views, read as (B,H,T,D): bf16 goes through the
    tensor-core kernel, fp32 through the CUDA-core one. T is one length or
    (Tq, Tk)."""
    Tq, Tk = T if isinstance(T, tuple) else (T, T)
    g = torch.Generator(device=cuda).manual_seed(Tq + Tk + Hq)
    td = DTYPES[dtype]
    q, k, v = (torch.randn((B, n, H, D), generator=g, device=cuda).to(td).transpose(1, 2)
               for n, H in ((Tq, Hq), (Tk, Hkv), (Tk, Hkv)))
    want_path = "wgmma" if td == torch.bfloat16 else "simt"
    n, by_path = fk.launches, dict(fk.launches_by_path)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fk.launches == n + 1
    assert fk.launches_by_path == dict(by_path, **{want_path: by_path[want_path] + 1})
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,T,D", [
    (1, 32, 8, 1024, 128),    # llama3-8b's prefill
    (4, 32, 32, 1024, 80),    # zamba2-2.7b's
    (1, 32, 8, 1024, 160),    # stablelm-12b's
])
def test_flash_tensor_core_kernel_keeps_p_in_fp32_precision(cuda, B, Hq, Hkv, T, D):
    """The tensor-core kernel's output is no further (relative L2, within
    5%) from the plain version run in fp32 on the same bf16 inputs than the
    CUDA-core kernel's, which keeps P in fp32: both round only the output
    to bf16. A kernel that rounds P to bf16 before P.V lands about 1.4x
    further."""
    g = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=cuda).bfloat16().transpose(1, 2)
               for H in (Hq, Hkv, Hkv))
    assert fk.route_for(q, k, v) == "wgmma"
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    d_wgmma = _rel_l2(fk.flash_attention(q, k, v, path="wgmma"), want)
    d_simt = _rel_l2(fk.flash_attention(q, k, v, path="simt"), want)
    assert d_wgmma <= 1.05 * d_simt, (d_wgmma, d_simt)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["offset", "padded", "model"])
def test_flash_cuda_core_kernel_takes_bf16_on_cuda(cuda, layout):
    """bf16 that TMA cannot read (bases one element off alignment, or a head
    stride of D + 4) goes to the CUDA-core kernel, which also runs the
    model's own layout when a caller names it (chip_smoke.py times it so)."""
    B, T, Hq, Hkv, D = 2, 130, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(5)

    def one(H):
        x = torch.randn((B, T, H, D + 4), generator=g, device=cuda).bfloat16()
        if layout == "padded":
            return x[..., :D].transpose(1, 2)
        x = x[..., :D].contiguous().flatten()
        if layout == "offset":
            x = torch.cat([x[:1], x])[1:]
        return x.view(B, T, H, D).transpose(1, 2)
    q, k, v = one(Hq), one(Hkv), one(Hkv)
    path = None if layout != "model" else "simt"
    assert fk.route_for(q, k, v) == ("wgmma" if layout == "model" else "simt")
    before = fk.launches_by_path["simt"]
    got = fk.flash_attention(q, k, v, causal=True, path=path)
    torch.cuda.synchronize()
    assert fk.launches_by_path["simt"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    if layout != "model":
        with pytest.raises(ValueError, match="cannot take"):
            fk.flash_attention(q, k, v, path="wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int8-bf16q"])
@pytest.mark.parametrize("B,Hq,Hc,S,D", [
    (2, 4, 2, 128, 32), (1, 8, 8, 256, 64), (3, 2, 1, 64, 16), (8, 32, 16, 512, 128),
    (4, 32, 32, 300, 80), (3, 32, 16, 200, 160),
])
def test_decode_kernel_matches_plain_on_cuda(cuda, B, Hq, Hc, S, D, dtype):
    """dtype names the cache; an int8 cache is read by an fp32 q ("int8")
    or by a bf16 q ("int8-bf16q", the serving path's)."""
    g = torch.Generator(device=cuda).manual_seed(S + Hq)
    td = {"int8": torch.float32, "int8-bf16q": torch.bfloat16}.get(dtype) or DTYPES[dtype]
    q = torch.randn((B, Hq, D), generator=g, device=cuda).to(td)
    kf, vf = (torch.randn((B, S, Hc, D), generator=g, device=cuda) for _ in range(2))
    scales = (None, None)
    if dtype.startswith("int8"):
        ks, vs = (x.abs().amax(-1, keepdim=True) / 127.0 for x in (kf, vf))
        kc, vc = torch.round(kf / ks).to(torch.int8), torch.round(vf / vs).to(torch.int8)
        scales = (ks.transpose(1, 2), vs.transpose(1, 2))
    else:
        kc, vc = kf.to(td), vf.to(td)
    kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)   # cache layer view
    vl = torch.randint(1, S + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    vl[0] = 1
    before = dk.launches_by_path["split"]
    got = ops.decode_attention(q, kc, vc, vl, *scales)
    torch.cuda.synchronize()
    assert dk.launches_by_path["split"] == before + 1
    want = ref.decode_attention_ref(q, kc, vc, vl, *scales)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "int8" else _tol(str(td)[6:])
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _decode_inputs(g, B, Hq, Hc, S, D, dtype, dev):
    """q and the cache as the model lays it out, (B, S, Hc, D) read as
    (B, Hc, S, D); dtype names the cache as in the test above. Returns (q,
    k, v, scales, tolerance)."""
    td = {"int8": torch.float32, "int8-bf16q": torch.bfloat16}.get(dtype) or DTYPES[dtype]
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(td)
    kf, vf = (torch.randn((B, S, Hc, D), generator=g, device=dev) for _ in range(2))
    scales = (None, None)
    if dtype.startswith("int8"):
        ks, vs = (x.abs().amax(-1, keepdim=True) / 127.0 for x in (kf, vf))
        kc, vc = torch.round(kf / ks).to(torch.int8), torch.round(vf / vs).to(torch.int8)
        scales = (ks.transpose(1, 2), vs.transpose(1, 2))
    else:
        kc, vc = kf.to(td), vf.to(td)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "int8" else _tol(str(td)[6:])
    return q, kc.transpose(1, 2), vc.transpose(1, 2), scales, tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int8-bf16q"])
@pytest.mark.parametrize("D", [16, 80, 128, 160])
@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_decode_split_kernel_at_every_split_edge(cuda, R, D, dtype):
    """One batch row per edge of the split grid (kernels/decode_attention.py::
    plan): valid_len 0, 1, one split less a row, exactly one split, one
    split and a row, two splits and S, over three splits and a tail; each
    call goes through the split kernel."""
    Hc, B = 2, 7
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, _ = dk.plan(B, Hc, 1, D, n_sm)   # the shortest split at this grid
    S = 3 * rows + 17
    assert dk.plan(B, Hc, S, D, n_sm) == (rows, 4)
    g = torch.Generator(device=cuda).manual_seed(R * 1000 + D)
    q, kc, vc, scales, tol = _decode_inputs(g, B, R * Hc, Hc, S, D, dtype, cuda)
    vl = torch.tensor([0, 1, rows - 1, rows, rows + 1, 2 * rows, S], dtype=torch.int32,
                      device=cuda)
    assert dk.route_for(kc, vc) == "split"
    before = dk.launches_by_path["split"]
    got = ops.decode_attention(q, kc, vc, vl, *scales)
    torch.cuda.synchronize()
    assert dk.launches_by_path["split"] == before + 1
    want = ref.decode_attention_ref(q, kc, vc, vl, *scales)
    assert not got[0].any(), "valid_len = 0 gives 0"
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8-bf16q", "bfloat16"])
@pytest.mark.parametrize("D,S,split_rows", [(128, 2048, None), (16, 4096, 2048),
                                            (160, 2048, 1024)])
def test_decode_split_kernel_with_long_splits(cuda, D, S, split_rows, dtype):
    """qwen1.5-32b's 48 q heads on 48 cache heads (R = 1), at plan's split
    length (256 rows at D = 128: 8 tiles, two laps of each warp's ring
    slot) and at longer ones named (up to 64 tiles, 16 laps)."""
    B, H = 8, 48
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = split_rows or dk.plan(B, H, S, D, n_sm)[0]
    assert rows >= 8 * dk.SPLIT_TILE
    g = torch.Generator(device=cuda).manual_seed(48 + D)
    q, kc, vc, scales, tol = _decode_inputs(g, B, H, H, S, D, dtype, cuda)
    vl = torch.tensor([0, 1, rows - 1, rows, rows + 1, S // 2, S, S - 1],
                      dtype=torch.int32, device=cuda)
    before = dk.launches_by_path["split"]
    got = dk.decode_attention(q, kc, vc, vl, *scales, split_rows=split_rows)
    torch.cuda.synchronize()
    assert dk.launches_by_path["split"] == before + 1
    torch.testing.assert_close(got.float(),
                               ref.decode_attention_ref(q, kc, vc, vl, *scales).float(), **tol)


@pytest.mark.cuda
def test_decode_first_version_takes_what_tma_cannot_read(cuda):
    """A cache whose head stride (D + 4 elements, 264 bytes) TMA cannot take
    goes to the first version; naming the split kernel for it raises, and
    the first version still runs the split kernel's inputs when named."""
    B, Hq, Hc, S, D = 3, 8, 4, 200, 128
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((B, Hq, D), generator=g, device=cuda).bfloat16()
    kc, vc = (torch.randn((B, S, Hc, D + 4), generator=g, device=cuda).bfloat16()[..., :D]
              .transpose(1, 2) for _ in range(2))
    vl = torch.tensor([0, 77, S], dtype=torch.int32, device=cuda)
    assert dk.route_for(kc, vc) == "simt"
    before = dict(dk.launches_by_path)
    got = ops.decode_attention(q, kc, vc, vl)
    torch.cuda.synchronize()
    assert dk.launches_by_path == dict(before, simt=before["simt"] + 1)
    want = ref.decode_attention_ref(q, kc, vc, vl)
    torch.testing.assert_close(got.float(), want.float(), **_tol("bfloat16"))
    with pytest.raises(ValueError, match="cannot take"):
        dk.decode_attention(q, kc, vc, vl, path="split")
    kd, vd = kc.contiguous(), vc.contiguous()
    assert dk.route_for(kd, vd) == "split"
    got = dk.decode_attention(q, kd, vd, vl, path="simt")
    torch.testing.assert_close(got.float(), want.float(), **_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", [
    (2, 64, 128, 64), (4, 32, 64, 128), (8, 16, 32, 32),   # tests/test_kernels.py
    (4, 4, 512, 640),      # decode capacity: one row tile, rows padded to 4
    (3, 12, 300, 264),     # one row tile padded to 16, d off the x chunk; at
                           # bf16 a row of x is 600 bytes, which TMA cannot stride
    (3, 20, 200, 36),      # two row tiles, the second ragged; f not a multiple
                           # of 8: scalar loads, and no TMA at bf16
    (2, 160, 256, 320),    # the prefill capacity of a 1024-token prompt
    # TMA-eligible at bf16, for the tensor-core kernel:
    (1, 64, 64, 128),      # one CTA, one k step
    (2, 33, 128, 256),     # a K loop shorter than the ring; a ragged last row tile
    (3, 160, 4096, 200),   # a long K loop; ragged last row and column tiles
    (1, 20, 6400, 128),    # C under one row tile, d = 6400; E = 1
    (2, 4, 200, 64),       # the decode capacity; d off the 64-deep k step
])
def test_moe_gmm_kernel_matches_plain_on_cuda(cuda, E, C, d, f, dtype):
    """Each case goes through the kernel `route` names: the tensor-core one
    for bf16 whose rows TMA can stride (d and f multiples of 8 elements),
    else the row kernel up to ROWS_MAX_C and the tiled one above."""
    g = torch.Generator(device=cuda).manual_seed(E + C + d)
    td = DTYPES[dtype]
    x = torch.randn((E, C, d), generator=g, device=cuda).to(td)
    w = (torch.randn((E, d, f), generator=g, device=cuda) * d ** -0.5).to(td)
    tma = d % 8 == 0 and f % 8 == 0
    want = ("wgmma" if td == torch.bfloat16 and tma
            else "rows" if C <= gk.ROWS_MAX_C else "tiled")
    n, by_path = gk.launches, dict(gk.launches_by_path)
    got = ops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert gk.launches == n + 1 and got.dtype == td and got.shape == (E, C, f)
    assert gk.launches_by_path == dict(by_path, **{want: by_path[want] + 1})
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.float(), ref.moe_gmm_ref(x, w).float(), **tol)


def _ssd_inputs(dev, B, H, T, P, G, N, dtype, seed):
    """Inputs in the model's (B,T,H,P) layout, read as (B,H,T,P) views; the
    distributions of tests/test_kernels.py."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((B, T, H, P), generator=g, device=dev) * 0.5).to(dtype).transpose(1, 2)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=g, device=dev)).transpose(1, 2)
    A = -torch.exp(torch.randn(H, generator=g, device=dev) * 0.3)
    Bm, Cm = ((torch.randn((B, T, G, N), generator=g, device=dev) * 0.5).to(dtype)
              .transpose(1, 2) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,P,G,N,chunk", [
    (1, 2, 64, 16, 1, 8, 16), (2, 4, 64, 32, 2, 16, 32), (1, 2, 128, 16, 2, 8, 16),
    (2, 8, 512, 64, 1, 64, 256),    # zamba2's heads, state and chunk
    (1, 80, 256, 64, 1, 64, 256),   # one chunk
    (1, 8, 2048, 64, 1, 64, 256),   # 8 chunks
    (2, 8, 512, 64, 2, 64, 256),    # G = 2
    (4, 80, 1024, 64, 1, 64, 256),  # zamba2-2.7b's prefill, B = 4
    (2, 4, 256, 64, 1, 64, 64),     # chunks of one and two row tiles
    (2, 4, 512, 64, 2, 64, 128),
    (1, 4, 64, 64, 1, 64, 256),     # T = 64: one tile, one chunk
])
def test_ssd_scan_kernel_matches_plain_on_cuda(cuda, B, H, T, P, G, N, chunk, dtype):
    """Inputs in the model's (B,T,H,P) layout, read as (B,H,T,P) views. Each
    case goes through the kernel `route` names: the tensor-core path for
    fp32 at P = N = 64 and a chunk that is a multiple of 64, else the first
    version."""
    td = DTYPES[dtype]
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, H, T, P, G, N, td, T + P)
    Q = min(chunk, T)
    want = "mma" if td == torch.float32 and P == N == 64 and Q % 64 == 0 else "simt"
    n, by_path = sk.launches, dict(sk.launches_by_path)
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.launches == n + 1 and y.dtype == td and s.dtype == torch.float32
    assert sk.launches_by_path == dict(by_path, **{want: by_path[want] + 1})
    want_y, want_s = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(s, want_s, **tol)


def _rel_l2(a, b):
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


@pytest.mark.cuda
def test_ssd_tensor_core_kernel_keeps_fp32_precision(cuda):
    """At zamba2-2.7b's prefill shape (B=4, H=80, T=1024, P=N=64, chunk
    256), y and the final state of the tensor-core path (3xTF32 products)
    are each no further from an fp64 run of the plain version than 2x the
    first version's (fp32 products on the CUDA cores); one TF32 pass would
    be about a thousand times further."""
    args = _ssd_inputs(cuda, 4, 80, 1024, 64, 1, 64, torch.float32, 1024)
    assert sk.route_for(args[0], args[3], args[4]) == "mma"
    exact_y, exact_s = ref.ssd_scan_ref(*(t.double() for t in args), chunk=256)
    dist = {}
    for path in ("mma", "simt"):
        y, s = sk.ssd_scan(*args, chunk=256, path=path)
        torch.cuda.synchronize()
        dist[path] = (_rel_l2(y, exact_y), _rel_l2(s, exact_s))
    assert dist["mma"][0] <= 2 * dist["simt"][0], dist
    assert dist["mma"][1] <= 2 * dist["simt"][1], dist


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["offset", "padded"])
def test_ssd_first_version_takes_what_tma_cannot_read(cuda, layout):
    """fp32 at zamba2's widths whose bases ("offset", one element off an
    aligned address) or rows ("padded", a head stride of P + 1) TMA cannot
    read goes to the first version and still matches the plain version;
    naming the tensor-core path for it raises."""
    B, H, T, P, G, N = 2, 8, 512, 64, 1, 64
    x, dt, A, Bm, Cm = _ssd_inputs(cuda, B, H, T, P, G, N, torch.float32, 7)
    if layout == "offset":
        x, Bm, Cm = (torch.empty(t.numel() + 1, device=cuda)[1:].view(
            t.transpose(1, 2).shape).copy_(t.transpose(1, 2)).transpose(1, 2)
            for t in (x, Bm, Cm))
    else:
        x = torch.zeros((B, T, H, P + 1), device=cuda)[..., :P].copy_(
            x.transpose(1, 2)).transpose(1, 2)
    assert sk.route_for(x, Bm, Cm) == "simt"
    n = sk.launches_by_path["simt"]
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert sk.launches_by_path["simt"] == n + 1
    want_y, want_s = ref.ssd_scan_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, want_s, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="cannot take"):
        sk.ssd_scan(x, dt, A, Bm, Cm, path="mma")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_engine_on_the_card_goes_through_the_kernels(cuda):
    cfg = get_config("llama3-8b", smoke=True).replace(param_dtype="float32")
    specs = [([1 + i, 2, 3], 4, -1) for i in range(5)]
    cpu_params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    outs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        params = _to(cpu_params, dev)
        eng = ServeEngine(model, params, batch_slots=2, max_len=32, device=dev)
        before = (fk.launches, dk.launches)
        reqs = [Request(id=i, prompt=list(p), max_new_tokens=n, eos_id=eos)
                for i, (p, n, eos) in enumerate(specs)]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_drained()
        outs[dev] = [r.output for r in reqs]
        launched = (fk.launches - before[0], dk.launches - before[1])
        if dev == "cuda":
            assert launched == (cfg.n_layers * eng.stats["prefills"],
                                cfg.n_layers * eng.stats["ticks"])
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_moe_engine_on_the_card_goes_through_the_kernels(cuda):
    """phi3.5-moe SMOKE at fp32: the card's engine emits the CPU engine's
    tokens, with 3 moe_gmm launches per layer in every prefill and step."""
    cfg = get_config("phi3.5-moe-42b-a6.6b", smoke=True).replace(param_dtype="float32")
    specs = [([1 + i, 2, 3], 4, -1) for i in range(5)]
    cpu_params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(build_model(cfg, device=dev), _to(cpu_params, dev),
                          batch_slots=2, max_len=32, device=dev)
        before = gk.launches
        reqs = [Request(id=i, prompt=list(p), max_new_tokens=n, eos_id=eos)
                for i, (p, n, eos) in enumerate(specs)]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_drained()
        outs[dev] = [r.output for r in reqs]
        if dev == "cuda":
            calls = eng.stats["prefills"] + eng.stats["ticks"]
            assert gk.launches - before == 3 * cfg.n_layers * calls
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_hybrid_on_the_card_goes_through_the_kernels(cuda):
    """zamba2 SMOKE at fp32: prefill and a decode step on the card agree with
    the CPU, through one ssd_scan per mamba2 block and one flash (prefill) or
    decode (step) launch per application of the shared block."""
    cfg = get_config("zamba2-2.7b", smoke=True).replace(param_dtype="float32")
    nb = cfg.n_layers // cfg.hybrid.attn_every
    cpu_params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    got = {}
    for dev in ("cpu", "cuda"):
        m = build_model(cfg, device=dev)
        p = _to(cpu_params, dev)
        before = (sk.launches, fk.launches, dk.launches)
        logits, pc = m.prefill(p, {"tokens": toks.to(dev)})
        cache = m.init_cache(2, 70)
        cache["k"][:, :, :64], cache["v"][:, :, :64] = pc["k"], pc["v"]
        cache["conv"][:], cache["ssm"][:] = pc["conv"], pc["ssm"]
        step = {"tokens": logits[:, -1].argmax(-1).to(torch.int32)[:, None],
                "positions": torch.full((2,), 64, dtype=torch.int32, device=dev)}
        dec, _ = m.decode_step(p, cache, step)
        got[dev] = (logits.cpu(), dec.cpu())
        if dev == "cuda":
            assert (sk.launches - before[0], fk.launches - before[1],
                    dk.launches - before[2]) == (cfg.n_layers, nb, nb)
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- training

@pytest.mark.cuda
@pytest.mark.parametrize("path", ["wgmma", "simt"])
@pytest.mark.parametrize("B,Hq,Hkv,T,D,causal,window", [
    (1, 32, 8, 1024, 128, True, None),   # llama3-8b's training shape
    (1, 32, 8, 1024, 128, True, 256),
    (2, 32, 32, 256, 80, True, None),    # zamba2's head dim
    (1, 32, 8, 200, 160, True, None),    # stablelm's; a tail tile
    (2, 4, 2, 100, 64, False, None),
    (1, 4, 2, 300, 64, False, 70),
])
def test_flash_lse_matches_plain_on_cuda(cuda, path, B, Hq, Hkv, T, D, causal, window):
    """Both kernels' lse (fp32 (B,Hq,T)) against the plain version's, to
    1e-4 (sums of up to T exps in another order; the tensor-core kernel's m
    is in log2 units), and the output unchanged beside it."""
    g = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=cuda).bfloat16().transpose(1, 2)
               for H in (Hq, Hkv, Hkv))
    n = fk.lse_launches
    out, lse = fk.flash_attention(q, k, v, causal=causal, window=window, path=path,
                                  return_lse=True)
    torch.cuda.synchronize()
    assert fk.lse_launches == n + 1
    want_out, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                                 return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, T)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(out.float(), want_out.float(), **_tol("bfloat16"))
    assert torch.equal(out, fk.flash_attention(q, k, v, causal=causal, window=window, path=path))


def _vjp_grads(q, k, v, do, window=None):
    from repro_torch.models.flash_vjp import flash_attention_vjp
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    flash_attention_vjp(q, k, v, causal=True, window=window, block_q=256,
                        block_k=256).backward(do)
    return q.grad, k.grad, v.grad


def _exact_grads(q, k, v, do, window=None):
    q, k, v = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      window=window).transpose(1, 2).backward(do.float())
    return q.grad, k.grad, v.grad


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_vjp_on_cuda_matches_autograd_through_the_reference(cuda, dtype, window):
    """flash_attention_vjp on the card (the kernel's forward and lse, the
    plain tiled backward) against autograd through ref.attention_ref. fp32
    (the CUDA-core kernel): to 1e-4. bf16 (the tensor-core kernel): no
    further from the fp32 gradients (relative L2) than 2x the same function
    with the plain forward."""
    B, T, Hq, Hkv, D = 2, 512, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(7)
    td = DTYPES[dtype]
    q, k, v, do = (torch.randn((B, T, H, D), generator=g, device=cuda).to(td)
                   for H in (Hq, Hkv, Hkv, Hq))
    n = fk.lse_launches
    got = _vjp_grads(q, k, v, do, window)
    assert fk.lse_launches == n + 1
    exact = _exact_grads(q, k, v, do, window)
    if dtype == "float32":
        for a, b in zip(got, exact):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        return
    with pytest.MonkeyPatch.context() as mp:
        from repro_torch.models import flash_vjp
        mp.setattr(flash_vjp, "ops", ref_ops())
        plain = _vjp_grads(q, k, v, do, window)
    for a, p, e in zip(got, plain, exact):
        assert a.dtype == torch.bfloat16
        assert _rel_l2(a, e) <= 2 * _rel_l2(p, e), (_rel_l2(a, e), _rel_l2(p, e))


def ref_ops():
    """A stand-in for kernels/ops.py that calls the plain versions."""
    import types
    return types.SimpleNamespace(flash_attention=ref.flash_attention_ref,
                                 decode_attention=ref.decode_attention_ref,
                                 moe_gmm=ref.moe_gmm_ref, ssd_scan=ref.ssd_scan_ref)


@pytest.mark.cuda
def test_every_kernel_wrapper_raises_under_grad(cuda):
    """A CUDA input that requires grad, with grad enabled: the kernels have
    no backward, so each op raises instead of returning an output that
    autograd would silently cut off. Under no_grad the same call runs."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    q, k = rnd(1, 4, 64, 64), rnd(1, 2, 64, 64)
    dq, dc = rnd(2, 4, 64), rnd(2, 2, 128, 64)
    valid = torch.tensor([100, 128], dtype=torch.int32, device=cuda)
    x, w = rnd(2, 8, 64), rnd(2, 64, 128)
    sx, sdt = rnd(1, 2, 64, 16, dtype=torch.float32), rnd(1, 2, 64, dtype=torch.float32).abs()
    sA, sb = -rnd(2, dtype=torch.float32).abs(), rnd(1, 1, 64, 16, dtype=torch.float32)
    calls = {
        "flash_attention": (lambda a: ops.flash_attention(a, k, k), q),
        "decode_attention": (lambda a: ops.decode_attention(a, dc, dc, valid), dq),
        "moe_gmm": (lambda a: ops.moe_gmm(a, w), x),
        "ssd_scan": (lambda a: ops.ssd_scan(a, sdt, sA, sb, sb, chunk=32), sx),
    }
    for name, (call, arg) in calls.items():
        live = arg.clone().requires_grad_()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call(live)
        with torch.no_grad():
            call(live)
        call(arg)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_plain_kernels(cuda, monkeypatch):
    """One AdamW step of llama3 SMOKE at fp32 (2 microbatches) on the card:
    through the flash kernel with the lse (forward and remat, per layer and
    microbatch), and against the same step with the plain kernels: loss and
    grad norm to 1e-4; the new params within 2 lr + 1e-6 everywhere (AdamW's
    first step moves an entry by lr * g / (|g| + 1e-8), which a gradient
    near 0 can flip) and within 1e-6 on at least 99% of the entries."""
    from repro_torch.models import flash_vjp, layers
    from repro_torch.optim.optimizers import make_optimizer, warmup_cosine
    from repro_torch.train.steps import make_init_state, make_train_step
    from repro_torch.tree import leaves

    cfg = get_config("llama3-8b", smoke=True).replace(param_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (4, 65), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].to(cuda), "targets": toks[:, 1:].to(cuda)}
    lr_fn = warmup_cosine(1e-3, 0, 10)   # lr 1e-3 at step 1
    out = {}
    for name in ("kernel", "plain"):
        model = build_model(cfg, device=cuda)
        opt = make_optimizer("adamw")
        state = make_init_state(model, opt)(torch.Generator(device=cuda).manual_seed(0))
        state["step"].fill_(1)
        with pytest.MonkeyPatch.context() as mp:
            if name == "plain":
                mp.setattr(layers, "ops", ref_ops())
                mp.setattr(flash_vjp, "ops", ref_ops())
            n = (fk.launches, fk.lse_launches)
            state, metrics = make_train_step(model, opt, lr_fn, n_microbatches=2)(state, batch)
            torch.cuda.synchronize()
            launched = (fk.launches - n[0], fk.lse_launches - n[1])
        want = 2 * cfg.n_layers * 2 if name == "kernel" else 0
        assert launched == (want, want), (name, launched)
        out[name] = (metrics, leaves(state["params"]))
    (mk, pk), (mp_, pp) = out["kernel"], out["plain"]
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(mk[key], mp_[key], atol=0, rtol=1e-4)
    lr = float(mk["lr"])
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pk, pp)])
    assert float(diffs.max()) <= 2 * lr + 1e-6
    assert float((diffs <= 1e-6).float().mean()) >= 0.99
