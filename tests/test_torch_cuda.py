"""The port's CUDA kernels and its serving path on the card.

The kernels have no CPU mode, so every test here is marked `cuda` and skips
without an NVIDIA GPU. This file imports no JAX: it runs on a machine with
the card and PyTorch alone,

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version (kernels/ref.py, itself held
to the JAX package by tests/test_torch_kernels.py) at the shapes of
tests/test_kernels.py and the main path's, with its tolerances: fp32 2e-5,
bf16 2e-2, int8 1e-4.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops, ref
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
