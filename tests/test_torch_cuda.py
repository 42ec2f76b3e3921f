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
another order, with exp of the summed decays), bf16 2e-2.
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
])
def test_flash_kernel_matches_plain_on_cuda(cuda, B, Hq, Hkv, T, D, causal,
                                            window, dtype):
    g = torch.Generator(device=cuda).manual_seed(T + Hq)
    td = DTYPES[dtype]
    q, k, v = (torch.randn((B, T, H, D), generator=g, device=cuda).to(td).transpose(1, 2)
               for H in (Hq, Hkv, Hkv))
    n = fk.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fk.launches == n + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


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
    got = ops.decode_attention(q, kc, vc, vl, *scales)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, kc, vc, vl, *scales)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "int8" else _tol(str(td)[6:])
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", [
    (2, 64, 128, 64), (4, 32, 64, 128), (8, 16, 32, 32),   # tests/test_kernels.py
    (4, 4, 512, 640),      # decode capacity: one row tile, rows padded to 4
    (3, 12, 300, 264),     # one row tile padded to 16, d off the x chunk
    (3, 20, 200, 36),      # two row tiles, the second ragged; f not a multiple
                           # of 8: scalar loads
    (2, 160, 256, 320),    # the prefill capacity of a 1024-token prompt
])
def test_moe_gmm_kernel_matches_plain_on_cuda(cuda, E, C, d, f, dtype):
    g = torch.Generator(device=cuda).manual_seed(E + C + d)
    td = DTYPES[dtype]
    x = torch.randn((E, C, d), generator=g, device=cuda).to(td)
    w = (torch.randn((E, d, f), generator=g, device=cuda) * d ** -0.5).to(td)
    n = gk.launches
    got = ops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert gk.launches == n + 1 and got.dtype == td and got.shape == (E, C, f)
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got.float(), ref.moe_gmm_ref(x, w).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,P,G,N,chunk", [
    (1, 2, 64, 16, 1, 8, 16), (2, 4, 64, 32, 2, 16, 32), (1, 2, 128, 16, 2, 8, 16),
    (2, 8, 512, 64, 1, 64, 256),    # zamba2's heads, state and chunk
])
def test_ssd_scan_kernel_matches_plain_on_cuda(cuda, B, H, T, P, G, N, chunk, dtype):
    """Inputs in the model's (B,T,H,P) layout, read as (B,H,T,P) views."""
    g = torch.Generator(device=cuda).manual_seed(T + P)
    td = DTYPES[dtype]
    x = (torch.randn((B, T, H, P), generator=g, device=cuda) * 0.5).to(td).transpose(1, 2)
    dt = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=g, device=cuda)).transpose(1, 2)
    A = -torch.exp(torch.randn(H, generator=g, device=cuda) * 0.3)
    Bm, Cm = ((torch.randn((B, T, G, N), generator=g, device=cuda) * 0.5).to(td)
              .transpose(1, 2) for _ in range(2))
    n = sk.launches
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.launches == n + 1 and y.dtype == td and s.dtype == torch.float32
    want_y, want_s = ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    tol = dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y.float(), want_y.float(), **tol)
    torch.testing.assert_close(s, want_s, **tol)


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
