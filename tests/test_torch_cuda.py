"""The port's CUDA kernels, and its serving, training and RL rollout paths,
on the card.

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
The multi-rank paths (the int8 ring all-reduce, the ZeRO-2 step) run their
ranks on the cards present (`repro_torch.distributed.spawn`; on one card
they share it over gloo) against the same ranks on the CPU.
"""
import dataclasses

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


GMM_BWD_CASES = [   # (E, C, d, f)
    (2, 4, 200, 64),       # the decode capacity; d off the 64-deep k step
    (3, 12, 136, 264),     # C, d and f each off a tile
    (2, 160, 256, 320),    # the prefill capacity of a 1024-token prompt
    (2, 320, 328, 200),    # phi3.5-moe's training capacity; d and f off a tile
    (1, 320, 4096, 640),   # a long contraction over d for dx, a tall dw
    # bf16 that TMA cannot stride: the CUDA-core kernels
    (3, 20, 200, 36),      # f not a multiple of 8
    (3, 12, 300, 264),     # rows of x and dx of 600 bytes
    (2, 40, 24, 64),       # d <= 32: fp32 dw on the row kernel, contracting over C
    (2, 40, 24, 36),       # and bf16 dw there too (f off TMA's stride)
]


def _gmm_bwd_want(kind, td, E, C, d, f):
    """The kernel `route` names for product `kind`: the tensor-core one for
    bf16 whose rows TMA can stride, else by M (C for dx, d for dw)."""
    M = C if kind == "dx" else d
    tma = d % 8 == 0 and f % 8 == 0
    return ("wgmma" if td == torch.bfloat16 and tma
            else "rows" if M <= gk.ROWS_MAX_C else "tiled")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", GMM_BWD_CASES)
def test_moe_gmm_backward_kernels_match_plain_on_cuda(cuda, E, C, d, f, dtype):
    """dx = dy w^T and dw = x^T dy, each through the kernel `route` names and
    held to its plain version with the forward's tolerances."""
    g = torch.Generator(device=cuda).manual_seed(E + C + d + f)
    td = DTYPES[dtype]
    x = torch.randn((E, C, d), generator=g, device=cuda).to(td)
    w = (torch.randn((E, d, f), generator=g, device=cuda) * d ** -0.5).to(td)
    dy = torch.randn((E, C, f), generator=g, device=cuda).to(td)
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    for kind, call, want, shape in (
            ("dx", lambda: ops.moe_gmm_dx(dy, w), lambda: ref.moe_gmm_dx_ref(dy, w), (E, C, d)),
            ("dw", lambda: ops.moe_gmm_dw(x, dy), lambda: ref.moe_gmm_dw_ref(x, dy), (E, d, f))):
        counts = getattr(gk, f"{kind}_launches_by_path")
        path = _gmm_bwd_want(kind, td, E, C, d, f)
        n, by_path = getattr(gk, f"{kind}_launches"), dict(counts)
        got = call()
        torch.cuda.synchronize()
        assert getattr(gk, f"{kind}_launches") == n + 1 and got.dtype == td
        assert got.shape == shape and counts == dict(by_path, **{path: by_path[path] + 1})
        torch.testing.assert_close(got.float(), want().float(), **tol, msg=kind)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,d,f", [(2, 4, 200, 64), (2, 320, 328, 200), (3, 100, 64, 136),
                                     (2, 129, 136, 264)])
def test_moe_gmm_tensor_core_tiles(cuda, E, C, d, f):
    """The tensor-core kernel in each of its three layouts, each with its
    own tile (64 rows a CTA for the forward and dx, 128 for dw, the output
    staged through shared memory), against the plain versions; the shapes
    leave ragged row and column tiles of both sizes."""
    g = torch.Generator(device=cuda).manual_seed(C)
    x = torch.randn((E, C, d), generator=g, device=cuda).bfloat16()
    w = (torch.randn((E, d, f), generator=g, device=cuda) * d ** -0.5).bfloat16()
    dy = torch.randn((E, C, f), generator=g, device=cuda).bfloat16()
    tol = dict(atol=5e-2, rtol=5e-2)
    n = dict(gk.launches_by_path), dict(gk.dx_launches_by_path), dict(gk.dw_launches_by_path)
    for got, want in ((gk.moe_gmm(x, w), ref.moe_gmm_ref(x, w)),
                      (gk.moe_gmm_dx(dy, w), ref.moe_gmm_dx_ref(dy, w)),
                      (gk.moe_gmm_dw(x, dy), ref.moe_gmm_dw_ref(x, dy))):
        torch.testing.assert_close(got.float(), want.float(), **tol)
    for before, after in zip(n, (gk.launches_by_path, gk.dx_launches_by_path,
                                 gk.dw_launches_by_path)):
        assert after == dict(before, wgmma=before["wgmma"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_gradients_on_cuda(cuda, dtype):
    """GroupedMatmul's forward and gradients on the card (the kernels)
    against autograd through the plain einsum on the same inputs. The loss
    is a sum, so autograd hands the backward an expanded (stride-0)
    gradient: the Function makes it contiguous, and the products still go
    through the tensor-core kernel at bf16."""
    from repro_torch.models.moe import GroupedMatmul
    E, C, d, f = 4, 160, 256, 320
    g = torch.Generator(device=cuda).manual_seed(11)
    td = DTYPES[dtype]
    x0 = torch.randn((E, C, d), generator=g, device=cuda).to(td)
    w0 = (torch.randn((E, d, f), generator=g, device=cuda) * d ** -0.5).to(td)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    n = (gk.dx_launches_by_path["wgmma"], gk.dw_launches_by_path["wgmma"])
    out = GroupedMatmul.apply(x, w)
    out.sum().backward()
    torch.cuda.synchronize()
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    ref.moe_gmm_ref(xr, wr).sum().backward()
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    for got, want in ((x.grad, xr.grad), (w.grad, wr.grad)):
        assert got.dtype == td
        torch.testing.assert_close(got.float(), want.float(), **tol)
    wgmma = (gk.dx_launches_by_path["wgmma"] - n[0], gk.dw_launches_by_path["wgmma"] - n[1])
    assert wgmma == ((1, 1) if dtype == "bfloat16" else (0, 0))


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
@pytest.mark.parametrize("with_state_grad", [False, True])
def test_ssd_scan_function_gradients_on_cuda(cuda, with_state_grad):
    """SSDScan on the card: the forward through the tensor-core path (the
    model's fp32 views at P = N = 64), the gradients of every input equal
    (to 1e-6) to autograd through the model's chunked scan on the same
    device, which its backward differentiates, and within 1e-4 (relative L2)
    of an fp64 run of the plain version."""
    from repro_torch.models import mamba2 as M2
    args = _ssd_inputs(cuda, 2, 8, 512, 64, 1, 64, torch.float32, 5)
    g = torch.Generator(device=cuda).manual_seed(6)
    dy = torch.randn(args[0].shape, generator=g, device=cuda)
    dS = torch.randn((2, 8, 64, 64), generator=g, device=cuda) if with_state_grad else None
    assert sk.route_for(args[0], args[3], args[4]) == "mma"

    def grads(fn):
        live = [t.detach().requires_grad_() for t in args]
        y, S = fn(*live)
        outs, cots = [y], [dy]
        if dS is not None:
            outs, cots = [y, S], [dy, dS]
        return torch.autograd.grad(outs, live, cots)
    n = sk.launches_by_path["mma"]
    got = grads(lambda *a: M2.SSDScan.apply(*a, 256))
    torch.cuda.synchronize()
    assert sk.launches_by_path["mma"] == n + 1

    def model_scan(x, dt, A, Bm, Cm):
        y, S = M2._ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2), A, Bm.transpose(1, 2),
                               Cm.transpose(1, 2), 256)
        return y.transpose(1, 2), S
    want = grads(model_scan)
    args = [t.double() for t in args]
    dy = dy.double()
    dS = None if dS is None else dS.double()
    exact = grads(lambda *a: ref.ssd_scan_ref(*a, chunk=256))
    for a, b, e in zip(got, want, exact):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
        assert _rel_l2(a, e) <= 1e-4


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
                                 moe_gmm=ref.moe_gmm_ref, moe_gmm_dx=ref.moe_gmm_dx_ref,
                                 moe_gmm_dw=ref.moe_gmm_dw_ref, ssd_scan=ref.ssd_scan_ref)


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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "zamba2-2.7b"])
def test_moe_and_hybrid_train_steps_on_the_card_match_the_plain_kernels(cuda, arch):
    """One AdamW step of phi3.5-moe SMOKE and of zamba2 SMOKE at fp32 (2
    microbatches) on the card, against the same step with the plain
    kernels, with test_train_step_on_the_card_matches_the_plain_kernels's
    bounds. Each kernel launches as the layers ask: flash with the lse twice
    per attention and microbatch (forward and remat); moe_gmm 3 times per
    MoE layer twice, with dx and dw once per expert product; ssd_scan twice
    per mamba2 block."""
    from repro_torch.models import flash_vjp, hybrid, layers, mamba2, moe
    from repro_torch.optim.optimizers import make_optimizer, warmup_cosine
    from repro_torch.train.steps import make_init_state, make_train_step
    from repro_torch.tree import leaves

    cfg = get_config(arch, smoke=True).replace(param_dtype="float32")
    toks = torch.randint(0, cfg.vocab_size, (4, 65), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].to(cuda), "targets": toks[:, 1:].to(cuda)}
    lr_fn = warmup_cosine(1e-3, 0, 10)   # lr 1e-3 at step 1
    k = 2   # microbatches
    if cfg.family == "moe":
        n_gmm = 3 * cfg.n_layers * k
        want = {"flash": 2 * cfg.n_layers * k, "gmm": 2 * n_gmm, "dx": n_gmm, "dw": n_gmm,
                "ssd": 0}
    else:
        nb = cfg.n_layers // cfg.hybrid.attn_every
        want = {"flash": 2 * nb * k, "gmm": 0, "dx": 0, "dw": 0, "ssd": 2 * cfg.n_layers * k}

    def counts():
        return {"flash": fk.lse_launches, "gmm": gk.launches, "dx": gk.dx_launches,
                "dw": gk.dw_launches, "ssd": sk.launches}
    out = {}
    for name in ("kernel", "plain"):
        model = build_model(cfg, device=cuda)
        opt = make_optimizer("adamw")
        state = make_init_state(model, opt)(torch.Generator(device=cuda).manual_seed(0))
        state["step"].fill_(1)
        with pytest.MonkeyPatch.context() as mp:
            if name == "plain":
                for module in (layers, flash_vjp, moe, mamba2, hybrid):
                    mp.setattr(module, "ops", ref_ops())
            n = counts()
            state, metrics = make_train_step(model, opt, lr_fn, n_microbatches=k)(state, batch)
            torch.cuda.synchronize()
            launched = {key: v - n[key] for key, v in counts().items()}
        assert launched == (want if name == "kernel" else dict.fromkeys(want, 0)), \
            (name, launched)
        out[name] = (metrics, leaves(state["params"]))
    (mk, pk), (mp_, pp) = out["kernel"], out["plain"]
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(mk[key], mp_[key], atol=0, rtol=1e-4)
    lr = float(mk["lr"])
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pk, pp)])
    assert float(diffs.max()) <= 2 * lr + 1e-6
    assert float((diffs <= 1e-6).float().mean()) >= 0.99


# ---------------------------------------------------------------- xLSTM, whisper, VLM

@pytest.mark.cuda
@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", [
    (8, 6, 6, 1536, 1536, 64, False),   # whisper-tiny's encoder
    (8, 6, 6, 64, 1536, 64, False),     # its cross-attention
    (8, 6, 6, 64, 64, 64, True),        # its decoder
    (4, 64, 8, 1024, 1024, 128, True),  # internvl2-76b's prefill
])
def test_flash_at_the_new_families_shapes_matches_plain_on_cuda(cuda, B, Hq, Hkv, Tq, Tk, D,
                                                                causal, lse):
    """bf16 (B,T,H,D) views through the tensor-core kernel, non-causal with
    Tq != Tk too, against the plain version; with `lse`, the row lse to 1e-4
    as test_flash_lse_matches_plain_on_cuda holds it."""
    g = torch.Generator(device=cuda).manual_seed(Tq + Tk + Hq)
    q, k, v = (torch.randn((B, n, H, D), generator=g, device=cuda).bfloat16().transpose(1, 2)
               for n, H in ((Tq, Hq), (Tk, Hkv), (Tk, Hkv)))
    assert fk.route_for(q, k, v) == "wgmma"
    before = fk.launches_by_path["wgmma"]
    got = ops.flash_attention(q, k, v, causal=causal, return_lse=lse)
    torch.cuda.synchronize()
    assert fk.launches_by_path["wgmma"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, return_lse=lse)
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        assert got_lse.shape == (B, Hq, Tq)
        torch.testing.assert_close(got_lse, want_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hc,S,D", [
    (8, 6, 6, 1536, 64),     # whisper-tiny's cross cache
    (4, 64, 16, 1536, 128),  # internvl2-76b's replicated heads
])
def test_decode_over_a_full_cross_cache_on_cuda(cuda, B, Hq, Hc, S, D):
    """Every one of the cache's S rows valid, as whisper's cross-attention
    reads its encoder cache, through the split kernel."""
    g = torch.Generator(device=cuda).manual_seed(S + Hq)
    q, kc, vc, scales, tol = _decode_inputs(g, B, Hq, Hc, S, D, "bfloat16", cuda)
    assert dk.route_for(kc, vc) == "split"
    vl = torch.full((B,), S, device=cuda, dtype=torch.int32)
    before = dk.launches_by_path["split"]
    got = ops.decode_attention(q, kc, vc, vl)
    torch.cuda.synchronize()
    assert dk.launches_by_path["split"] == before + 1
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, kc, vc, vl).float(),
                               **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-tiny", "internvl2-76b"])
def test_new_families_on_the_card_match_the_cpu(cuda, arch):
    """The SMOKE config at fp32: prefill (whisper over ENC_LEN frames,
    internvl2 with its patch embeddings) and two decode steps on the card
    agree with the CPU, through the kernels as often as the layers ask
    (xLSTM: none; whisper: a flash launch per encoder layer and two per
    decoder layer, two decode launches per decoder layer and step; internvl2:
    one of each per layer)."""
    from repro_torch.models import whisper
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    cpu_params = build_model(cfg, device="cpu").init_params(gen)
    B, T = 2, 32
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["enc_embeds"] = torch.randn((B, whisper.ENC_LEN, cfg.d_model), generator=gen)
        want = (cfg.encdec.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers)
    elif cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((B, cfg.vlm.n_patches, cfg.d_model), generator=gen)
        want = (cfg.n_layers, cfg.n_layers)
    else:
        want = (0, 0)
    got = {}
    for dev in ("cpu", "cuda"):
        m = build_model(cfg, device=dev)
        p = _to(cpu_params, dev)
        before = (fk.launches, dk.launches)
        logits, pc = m.prefill(p, {k: v.to(dev) for k, v in batch.items()})
        pre = (fk.launches - before[0], dk.launches - before[1])
        if cfg.family == "ssm":
            cache = pc
        else:
            cache = m.init_cache(B, T + 4)
            for name, buf in cache.items():
                if buf.shape == pc[name].shape:
                    buf.copy_(pc[name])
                else:
                    buf[:, :, :T] = pc[name]
        tok, outs = logits[:, -1].argmax(-1).to(torch.int32)[:, None], [logits.cpu()]
        for i in range(2):
            pos = torch.full((B,), T + i, dtype=torch.int32, device=dev)
            dec, cache = m.decode_step(p, cache, {"tokens": tok, "positions": pos})
            tok = dec[:, -1].argmax(-1).to(torch.int32)[:, None]
            outs.append(dec.cpu())
        got[dev] = outs
        if dev == "cuda":
            torch.cuda.synchronize()
            assert pre == (want[0], 0)
            assert (fk.launches - before[0], dk.launches - before[1]) == (want[0], 2 * want[1])
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-tiny", "internvl2-76b"])
def test_new_families_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One AdamW step of the SMOKE config at fp32 (2 microbatches of 2 x 64
    tokens; whisper with 64 stub frames a sequence, internvl2 with its patch
    embeddings) on the card, against the same step on the CPU with
    test_train_step_on_the_card_matches_the_plain_kernels's bounds. Flash
    launches with the lse twice per attention and microbatch (forward and
    remat): whisper's encoder layer has one attention, its decoder layer
    two (self and cross), internvl2's layer one, the xLSTM none."""
    from repro_torch.optim.optimizers import make_optimizer, warmup_cosine
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import leaves, tree_map

    cfg = get_config(arch, smoke=True).replace(param_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (4, 65), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    k = 2   # microbatches
    if cfg.family == "audio":
        batch["enc_embeds"] = torch.randn((4, 64, cfg.d_model), generator=gen)
        want = 2 * (cfg.encdec.n_enc_layers + 2 * cfg.n_layers) * k
    elif cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((4, cfg.vlm.n_patches, cfg.d_model), generator=gen)
        want = 2 * cfg.n_layers * k
    else:
        want = 0
    cpu_params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    lr_fn = warmup_cosine(1e-3, 0, 10)   # lr 1e-3 at step 1
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        opt = make_optimizer("adamw")
        # a copy: the step updates its params in place
        params = tree_map(lambda t: t.to(dev, copy=True), cpu_params)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.ones((), dtype=torch.int32, device=dev)}
        n = (fk.launches, fk.lse_launches)
        state, metrics = make_train_step(model, opt, lr_fn, n_microbatches=k)(
            state, {name: t.to(dev) for name, t in batch.items()})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (fk.launches - n[0], fk.lse_launches - n[1]) == (want, want)
        out[dev] = ({key: v.cpu() for key, v in metrics.items()},
                    [t.cpu() for t in leaves(state["params"])])
    (mk, pk), (mc, pc) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(mk[key], mc[key], atol=0, rtol=1e-4)
    lr = float(mk["lr"])
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pk, pc)])
    assert float(diffs.max()) <= 2 * lr + 1e-6
    assert float((diffs <= 1e-6).float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Pendulum", "Humanoid"])
def test_rollout_on_the_card_matches_the_cpu(cuda, name):
    """32 steps of the RL rollout on the card from the weights and initial
    state of a seed, against the CPU's from the same ones: observations and
    rewards to 1e-4 (fp32 products in another order, carried through 32
    steps); `rollout_task` of the seed reads back that same trajectory, and
    no kernel of the port launches."""
    from repro_torch.rl import rollout as R

    before = (fk.launches, dk.launches, gk.launches, sk.launches)
    fn, spec = R.make_rollout_fn(name, 32, device=cuda)
    params, state0 = fn.init(5)
    obs, rew = fn.core(params, state0)
    assert obs.is_cuda and tuple(obs.shape) == (32, spec.obs_dim)
    cpu_fn, _ = R.make_rollout_fn(name, 32, device="cpu")
    cobs, crew = cpu_fn.core({key: v.cpu() for key, v in params.items()}, state0.cpu())
    torch.testing.assert_close(obs.cpu(), cobs, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(rew.cpu(), crew, atol=1e-4, rtol=1e-4)
    task = R.rollout_task(name, 32, 5, device=cuda)
    torch.testing.assert_close(torch.from_numpy(task["obs"]), obs.cpu(), atol=0, rtol=0)
    assert (fk.launches, dk.launches, gk.launches, sk.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_mean_on_the_card_matches_the_cpu(cuda, world):
    """The int8 ring all-reduce on `world` ranks on the cards present (NCCL
    with a card a rank, else gloo, the payload through host memory) against
    the same ranks on the CPU, on the same (world, 128) input and 5 steps of
    error feedback: the mean, the residual and the fed-back mean within 1e-6
    (the same fp32 operations; expected bit for bit)."""
    import numpy as np
    from repro_torch import distributed as D
    import _torch_dist_ranks as R

    g = np.random.default_rng(world).standard_normal((world, 128)).astype(np.float32)
    card = D.spawn(R.compression_rank, world, g, 5, device="cuda", timeout=120)
    cpu = D.spawn(R.compression_rank, world, g, 5, device="cpu", timeout=120)
    for got, want in zip(card, cpu):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_zero2_step_on_the_card_matches_the_cpu(cuda):
    """Three ZeRO-2 data-parallel steps of llama3-8b SMOKE in fp32 on 2 ranks
    on the cards present against the same ranks on the CPU: losses and grad
    norms to 1e-4 relative, the params as the single-card train test holds
    them (an entry whose gradient sits near 0 may flip AdamW's first step,
    by up to 2 lr)."""
    import numpy as np
    from repro_torch import bridge, distributed as D
    import _torch_dist_ranks as R

    cfg = R.smoke_cfg("llama3-8b")
    params = bridge.params_to_numpy(build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        t = rng.integers(0, cfg.vocab_size, (8, 33)).astype(np.int32)
        batches.append({"tokens": t[:, :-1].copy(), "targets": t[:, 1:].copy()})
    card, cpu = (D.spawn(R.dp_train_rank, 2, "llama3-8b", params, batches, 2, True,
                         device=dev, timeout=120)[0] for dev in ("cuda", "cpu"))
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-4)
    np.testing.assert_allclose(card["norms"], cpu["norms"], rtol=1e-4)
    from repro_torch.tree import flatten
    diffs = np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in
                            zip(flatten(card["params"]), flatten(cpu["params"]))])
    assert diffs.max() <= 2 * R.LR + 1e-6
    assert (diffs <= 1e-6).mean() >= 0.99
    assert card["held"] == card["whole"] // 2


def _op_cases(dev):
    """Each kernel op's call at small shapes on `dev`, the wrapper's direct
    call on the same inputs, and the wrapper module whose launch counter
    the op moves."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    q, k = rnd(1, 64, 4, 64).transpose(1, 2), rnd(1, 64, 2, 64).transpose(1, 2)
    dq, dc = rnd(2, 4, 64), rnd(2, 128, 2, 64).transpose(1, 2)
    valid = torch.tensor([100, 128], dtype=torch.int32, device=dev)
    x, w, dy = rnd(2, 8, 64), rnd(2, 64, 128), rnd(2, 8, 128)
    sx = rnd(1, 64, 2, 64, dtype=torch.float32).transpose(1, 2)
    sdt = rnd(1, 2, 64, dtype=torch.float32).abs()
    sA = -rnd(2, dtype=torch.float32).abs()
    sb = rnd(1, 64, 1, 64, dtype=torch.float32).transpose(1, 2)
    return {
        "flash_attention": (lambda *a: ops.flash_attention(*a), (q, k, k),
                            lambda *a: fk.flash_attention(*a), fk),
        "flash_attention_lse": (lambda *a: ops.flash_attention(*a, return_lse=True), (q, k, k),
                                lambda *a: fk.flash_attention(*a, return_lse=True), fk),
        "decode_attention": (ops.decode_attention, (dq, dc, dc, valid), dk.decode_attention, dk),
        "moe_gmm": (ops.moe_gmm, (x, w), gk.moe_gmm, gk),
        "moe_gmm_dx": (ops.moe_gmm_dx, (dy, w), gk.moe_gmm_dx, gk),
        "moe_gmm_dw": (ops.moe_gmm_dw, (x, dy), gk.moe_gmm_dw, gk),
        "ssd_scan": (lambda *a: ops.ssd_scan(*a, chunk=64), (sx, sdt, sA, sb, sb),
                     lambda *a: sk.ssd_scan(*a, chunk=64), sk),
    }


_COUNTER = {"moe_gmm_dx": "dx_launches", "moe_gmm_dw": "dw_launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_lse", "decode_attention",
                                  "moe_gmm", "moe_gmm_dx", "moe_gmm_dw", "ssd_scan"])
def test_kernel_op_launches_its_kernel_and_is_counted_once(cuda, name, monkeypatch):
    """Each kernel op (`torch.ops.repro_torch.*`) on CUDA tensors: one
    launch of the wrapper's kernel, the wrapper's own output bit for bit;
    it raises under grad; a CostModel on the card counts it as exactly one
    op with its cost formula's FLOPs and bytes (its inputs read and outputs
    written once), as the same op on meta tensors; a launch error
    propagates."""
    from repro_torch import roofline
    call, args, direct, module = _op_cases(cuda)[name]
    counter = _COUNTER.get(name, "launches")
    before = getattr(module, counter)
    with roofline.CostModel("cuda") as cm:
        got = call(*args)
    assert getattr(module, counter) == before + 1
    want = direct(*args)
    got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for a, b in zip(got_t, want_t):
        assert a.shape == b.shape and a.stride() == b.stride() and torch.equal(a, b)
    assert cm.kernels == {name: 1} and list(cm.by_op) == [f"repro_torch::{name}"]
    io = sum(roofline.tensor_bytes(t) for t in (*args, *got_t))
    assert cm.totals.bytes == io and cm.totals.flops > 0
    meta_args = tuple(torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")
                      for t in args)
    with roofline.CostModel("meta") as mm:
        meta_out = call(*meta_args)
    meta_t = meta_out if isinstance(meta_out, tuple) else (meta_out,)
    assert [(t.shape, t.stride(), t.dtype) for t in meta_t] == \
        [(t.shape, t.stride(), t.dtype) for t in got_t]
    assert dataclasses.astuple(mm.totals) == dataclasses.astuple(cm.totals)
    live = args[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(live, *args[1:])
    monkeypatch.setattr(module, "_kernel", lambda: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="kernel"):
        call(*args)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", [("llama3-8b", "train"), ("phi3.5-moe-42b-a6.6b", "train"),
                                       ("llama3-8b", "decode"), ("zamba2-2.7b", "prefill")])
def test_meta_account_equals_the_card_account_at_smoke(cuda, arch, kind):
    """Phase 12a of chip_smoke.py at SMOKE: the dry-run's account of a step
    on the meta device equals the same step's on the card (FLOPs, bytes,
    every op, the kernel ops, the high-water mark), and the kernel ops
    equal the wrappers' launches."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import make_batch
    cfg = get_config(arch, smoke=True)
    accts = {}
    for dev in ("meta", cuda):
        gen = torch.Generator(device="cpu" if dev == "meta" else dev).manual_seed(0)
        batch = make_batch(cfg, ShapeConfig(kind, kind, 64, 4), device=dev, generator=gen)
        before = (fk.launches, dk.launches, gk.launches, gk.dx_launches, gk.dw_launches,
                  sk.launches)
        if kind == "train":
            acct, _ = dryrun.train_account(cfg, batch, n_micro=2, device=dev, generator=gen)
        elif kind == "prefill":
            acct, _ = dryrun.prefill_account(cfg, batch, device=dev, generator=gen)
        else:
            cache = build_model(cfg, device=dev).init_cache(4, 64)
            acct, _ = dryrun.decode_account(cfg, batch, cache, device=dev, generator=gen)
        after = (fk.launches, dk.launches, gk.launches, gk.dx_launches, gk.dw_launches,
                 sk.launches)
        accts[str(dev)] = (acct, [a - b for a, b in zip(after, before)])
    (meta, _), (card, launched) = accts["meta"], accts[str(cuda)]
    assert meta.cost.by_op == card.cost.by_op
    assert dataclasses.astuple(meta.cost.totals) == dataclasses.astuple(card.cost.totals)
    assert meta.cost.kernels == card.cost.kernels
    assert meta.cost.peak_bytes == card.cost.peak_bytes
    k = card.cost.kernels
    assert launched == [k.get("flash_attention", 0) + k.get("flash_attention_lse", 0),
                        k.get("decode_attention", 0), k.get("moe_gmm", 0),
                        k.get("moe_gmm_dx", 0), k.get("moe_gmm_dw", 0), k.get("ssd_scan", 0)]


# ------------------------------------------------ tensor-parallel serving's shapes

@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,T,D,heads", [
    (1, 8, 2, 1024, 128, None),        # llama3-8b's 32/8 heads on a rank of 4
    (4, 12, 12, 512, 128, None),       # qwen1.5-32b's 48 padded heads on a rank of 4
    (1, 8, 8, 1024, 128, (2, 4)),      # a rank's kv heads of a k/v every rank holds whole
    (2, 1, 2, 64, 16, (1, 2)),         # llama3-8b SMOKE's at 4 ranks: one q head, one kv head
])
def test_flash_at_the_tensor_parallel_ranks_shapes(cuda, B, Hq, Hkv, T, D, heads):
    """Phase 13's flash calls: a rank's q heads over its kv heads, or over
    its groups' heads selected from a replicated k/v (a view offset by
    whole heads, which TMA still reads): `flash_wgmma`, held to the plain
    version in bf16."""
    g = torch.Generator(device=cuda).manual_seed(T + Hq)
    q = torch.randn((B, T, Hq, D), generator=g, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((B, T, Hkv, D), generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    if heads is not None:
        k, v = k[:, :, heads[0]:heads[1]], v[:, :, heads[0]:heads[1]]
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    assert fk.route_for(q, k, v) == "wgmma"
    before = fk.launches_by_path["wgmma"]
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fk.launches_by_path["wgmma"] == before + 1
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v).float(),
                               **_tol("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,Hq,Hc,S,D,heads", [
    ("bfloat16", 8, 8, 4, 2048, 128, None),       # llama3-8b's 16 cache heads over 4 ranks
    ("int8-bf16q", 4, 12, 12, 520, 128, None),    # qwen1.5-32b's int8 cache over 4
    ("bfloat16", 2, 1, 2, 64, 16, (1, 2)),        # a rank's head of a replicated cache
    ("int8-bf16q", 2, 3, 6, 64, 16, (3, 6)),
])
def test_decode_at_the_tensor_parallel_ranks_shapes(cuda, dtype, B, Hq, Hc, S, D, heads):
    """Phase 13's decode calls over a rank's cache heads, or its groups'
    heads of a replicated cache: `decode_split`, held to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(S + Hq)
    q, kc, vc, scales, tol = _decode_inputs(g, B, Hq, Hc, S, D, dtype, cuda)
    if heads is not None:
        sel = slice(*heads)
        kc, vc = kc[:, sel], vc[:, sel]
        scales = tuple(s if s is None else s[:, sel] for s in scales)
    valid = torch.randint(1, S + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    assert dk.route_for(kc, vc) == "split"
    before = dk.launches_by_path["split"]
    got = ops.decode_attention(q, kc, vc, valid, *scales)
    torch.cuda.synchronize()
    assert dk.launches_by_path["split"] == before + 1
    torch.testing.assert_close(got.float(), ref.decode_attention_ref(q, kc, vc, valid,
                                                                      *scales).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N", [
    (16, 160, 4096, 3200),   # phi3.5-moe's w1/w3 at d_ff 6400 / 2, prefill capacity
    (16, 4, 4096, 3200),     # and decode capacity
    (16, 160, 3200, 4096),   # its w2 product, K = 3200
    (16, 160, 4096, 1600),   # at 4 ranks
    (16, 160, 1600, 4096),
])
def test_moe_gmm_at_the_tensor_parallel_ranks_shapes(cuda, E, C, K, N):
    """Phase 13b's expert products at a rank's d_ff: `gmm_wgmma`, held to
    the plain version in bf16."""
    g = torch.Generator(device=cuda).manual_seed(C + K)
    x = torch.randn((E, C, K), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((E, K, N), generator=g, device=cuda) * K ** -0.5).to(torch.bfloat16)
    before = gk.launches_by_path["wgmma"]
    got = ops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert gk.launches_by_path["wgmma"] == before + 1
    torch.testing.assert_close(got.float(), ref.moe_gmm_ref(x, w).float(), atol=5e-2, rtol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,world", [("llama3-8b", 2), ("llama3-8b", 4),
                                        ("qwen1.5-32b", 4), ("phi3.5-moe-42b-a6.6b", 2)])
def test_tensor_parallel_serving_on_the_card_matches_the_cpu(cuda, arch, world):
    """A SMOKE model in fp32 served tensor-parallel on `world` ranks on the
    cards present (one card: gloo, through host memory) against the same
    ranks on the CPU: the prefill and 3 decode steps' logits and every
    rank's cache within 1e-4 (the kernels against their plain versions in
    fp32, as the single-card engine test holds them)."""
    import numpy as np
    from repro_torch import bridge, distributed as D
    import _torch_tp_ranks as R

    cfg = R.smoke_cfg(arch)
    params = bridge.params_to_numpy(build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(3)
    case = {"arch": arch, "params": params, "S": 16,
            "batch": {"tokens": rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)},
            "steps": [rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
                      for _ in range(3)]}
    card, cpu = (D.spawn(R.parity_rank, world, {"c": case}, device=dev, timeout=120)
                 for dev in ("cuda", "cpu"))
    for got, want in zip(card, cpu):
        got, want = got["c"], want["c"]
        np.testing.assert_allclose(got["prefill"], want["prefill"], atol=1e-4, rtol=1e-4)
        for a, b in zip(got["decode"], want["decode"]):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
        for name in want["cache"]:
            a, b = got["cache"][name], want["cache"][name]
            tol = 1 if a.dtype == np.int8 else 1e-4
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                       atol=tol, rtol=1e-4)
