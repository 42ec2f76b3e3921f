"""The port's serving engine (src/repro_torch/serve/engine.py) against the
JAX engine, and driven by the JAX package's router, on the CPU.

At fp32 the two engines must emit identical tokens: same weights (handed over
by `repro_torch.bridge`), same requests, same slot scheduling, the same
position advance for every slot and the same completion rule.
"""
import runpy
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import engine as jax_engine
from repro.serve.router import ReplicaActor, Router
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]


def _engines(arch, dtype, slots, max_len, seed=0):
    jcfg = jax_get_config(arch, smoke=True).replace(param_dtype=dtype)
    cfg = get_config(arch, smoke=True).replace(param_dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    jeng = jax_engine.ServeEngine(jm, jp, batch_slots=slots, max_len=max_len)
    eng = ServeEngine(build_model(cfg, device="cpu"), bridge.params_from_jax(jp),
                      batch_slots=slots, max_len=max_len, device="cpu")
    return jeng, eng


def _run(engine, request_cls, specs):
    reqs = [request_cls(id=i, prompt=list(p), max_new_tokens=n, eos_id=eos)
            for i, (p, n, eos) in enumerate(specs)]
    for r in reqs:
        engine.add_request(r)
    done = engine.run_until_drained()
    return reqs, done


def test_serve_engine_continuous_batching():
    """The port of test_substrate.py::test_serve_engine_continuous_batching."""
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, batch_slots=2, max_len=32, device="cpu")
    reqs, done = _run(eng, Request, [([1 + i, 2, 3], 4, -1) for i in range(5)])
    assert all(r.done for r in reqs) and len(done) == 5
    assert all(len(r.output) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.output)
    assert eng.stats["completed"] == 5
    assert eng.stats["prefills"] == 5
    assert eng.stats["ticks"] >= 2 * (5 // 2)   # never more than 2 in flight


@pytest.mark.parametrize("arch", ["llama3-8b", "granite-8b", "qwen1.5-32b", "stablelm-12b"])
def test_engine_tokens_identical_to_jax_engine_at_fp32(arch):
    jeng, eng = _engines(arch, "float32", slots=2, max_len=32)
    specs = [([1 + i, 2, 3], 4 + i % 2, -1) for i in range(5)]
    jreqs, _ = _run(jeng, jax_engine.Request, specs)
    reqs, _ = _run(eng, Request, specs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert eng.stats == jeng.stats


def test_engine_completion_rules_match_jax_engine():
    """max_len - 1 ends a request, an EOS token ends one, and free slots keep
    advancing their positions past the cache, whose writes are dropped."""
    jeng, eng = _engines("llama3-8b", "float32", slots=2, max_len=10, seed=2)
    specs = [([5, 6, 7], 20, -1), ([9, 8], 3, -1), ([4, 4, 4, 4], 20, -1)]
    jreqs, _ = _run(jeng, jax_engine.Request, specs)
    # stop the first request at its second token
    eos = jreqs[0].output[1]
    specs[0] = (specs[0][0], 20, eos)
    jeng2, eng2 = _engines("llama3-8b", "float32", slots=2, max_len=10, seed=2)
    jreqs, _ = _run(jeng2, jax_engine.Request, specs)
    reqs, _ = _run(eng2, Request, specs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert reqs[0].output[-1] == eos and len(reqs[2].output) < 20
    assert eng2.stats == jeng2.stats


def test_serve_engine_matches_direct_decode():
    """The port of test_substrate.py::test_serve_engine_matches_direct_decode."""
    cfg = get_config("granite-8b", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    prompt = [4, 7, 9]
    eng = ServeEngine(model, params, batch_slots=1, max_len=16, device="cpu")
    (req,), _ = _run(eng, Request, [(prompt, 3, -1)])
    logits, _ = model.prefill(params, {"tokens": torch.tensor([prompt], dtype=torch.int32)})
    assert req.output[0] == int(torch.argmax(logits[0, -1]))
    assert len(req.output) == 3


def test_router_drives_the_torch_engine_unchanged():
    """repro.serve.router.Router over torch engines gives every request the
    tokens a single local torch engine gives it; ReplicaActor hosts one."""
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(3))
    specs = [([2 + i, 3 + i % 3, 5], 3 + i % 3, -1) for i in range(6)]

    local = ServeEngine(model, params, batch_slots=2, max_len=24, device="cpu")
    want, _ = _run(local, Request, specs)

    router = Router(max_queue_per_replica=2)
    for rid in ("r0", "r1"):
        router.add_replica(rid, ServeEngine(model, params, batch_slots=2,
                                            max_len=24, device="cpu"))
    reqs = [Request(id=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n, _) in enumerate(specs)]
    assert all(router.submit(r) for r in reqs)
    done = router.flush()
    assert sorted(r.id for r in done) == list(range(6))
    assert [r.output for r in reqs] == [r.output for r in want]

    actor = ReplicaActor(engine=ServeEngine(model, params, batch_slots=2,
                                            max_len=24, device="cpu"))
    for i, (p, n, _) in enumerate(specs[:3]):
        assert actor.handle({"kind": "submit", "id": i, "prompt": p,
                             "max_new_tokens": n})["accepted"]
    got = dict(actor.handle({"kind": "tick"})["done"])
    got.update(dict(actor.handle({"kind": "drain"})["done"]))
    assert got == {r.id: r.output for r in want[:3]}


def test_engine_device_must_be_asked_for(monkeypatch):
    cfg = get_config("llama3-8b", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params, batch_slots=1, max_len=8)


def test_serve_torch_example_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve_torch.py", "--device", "cpu"])
    runpy.run_path(str(ROOT / "examples" / "serve_torch.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "6 requests" in out and "on cpu" in out
