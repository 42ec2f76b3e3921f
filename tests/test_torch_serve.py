"""The port's serving engine (src/repro_torch/serve/engine.py) against the
JAX engine, and driven by the JAX package's router, on the CPU.

At fp32 the two engines must emit identical tokens: same weights (handed over
by `repro_torch.bridge`), same requests, same slot scheduling, the same
position advance for every slot and the same completion rule. The model-free
StubEngine matches the JAX package's token for token and stat for stat at
every tick, and routed over K replicas completes what one local engine does.
"""
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import engine as jax_engine
from repro.serve.router import ReplicaActor, Router
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine, StubEngine

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


def _stub_stream(rng, n):
    """n random requests (prompt, budget, eos): a third end at an EOS token
    their stub output reaches before the budget, the rest at the budget."""
    specs = []
    for _ in range(n):
        prompt = rng.integers(0, 50_000, int(rng.integers(1, 6))).tolist()
        budget = int(rng.integers(1, 9))
        eos = -1
        if rng.random() < 1 / 3:
            eos = StubEngine.stub_output(prompt, budget)[int(rng.integers(0, budget))]
        specs.append((prompt, budget, eos))
    return specs


def _stub_view(engine, reqs):
    return {"stats": dict(engine.stats), "free": engine.free_slots, "queue": engine.queue_len,
            "owed": engine.outstanding_tokens,
            "slots": [None if r is None else r.id for r in engine.slot_req],
            "outputs": [list(r.output) for r in reqs], "done": [r.done for r in reqs]}


@pytest.mark.parametrize("seed", range(8))
def test_stub_engine_matches_jax_stub_engine_every_tick(seed):
    """The port's StubEngine and repro.serve.engine.StubEngine fed the same
    random stream (EOS and budgets; 1-4 slots; requests arriving between
    ticks): at every tick the same active count, stats, free slots, queue,
    owed tokens, slot assignment, outputs, done flags and completions."""
    rng = np.random.default_rng(seed)
    slots = 1 + seed % 4
    specs = _stub_stream(rng, int(rng.integers(4, 16)))
    arrivals = sorted(int(rng.integers(0, 6)) for _ in specs)
    engines = [StubEngine(slots), jax_engine.StubEngine(slots)]
    reqs = [[cls(id=i, prompt=list(p), max_new_tokens=n, eos_id=e)
             for i, (p, n, e) in enumerate(specs)] for cls in (Request, jax_engine.Request)]
    done = [[], []]
    for tick in range(200):
        for eng, rs in zip(engines, reqs):
            for r, at in zip(rs, arrivals):
                if at == tick:
                    eng.add_request(r)
        active = [eng.tick() for eng in engines]
        assert active[0] == active[1], tick
        views = [_stub_view(eng, rs) for eng, rs in zip(engines, reqs)]
        assert views[0] == views[1], tick
        for side, eng in enumerate(engines):
            done[side].append([r.id for r in eng.pop_completed()])
        assert done[0][-1] == done[1][-1], tick
    assert all(r.done for r in reqs[0]) and engines[0].stats["completed"] == len(specs)
    assert any(r.eos_id in r.output for r in reqs[0]) or all(e == -1 for *_, e in specs)


@pytest.mark.parametrize("n_replicas,slots", [(1, 1), (2, 2), (3, 4), (4, 3)])
def test_routed_stub_engines_complete_as_one_local_engine(n_replicas, slots):
    """repro.serve.router.Router over K of the port's StubEngines completes
    every request of a random stream (EOS included) with the tokens one
    local engine gives it, which are the JAX package's StubEngine's."""
    rng = np.random.default_rng(100 + n_replicas)
    specs = _stub_stream(rng, 30)
    want = {}
    for cls_engine, cls_req in ((StubEngine, Request), (jax_engine.StubEngine,
                                                        jax_engine.Request)):
        local = cls_engine(slots)
        for i, (p, n, e) in enumerate(specs):
            local.add_request(cls_req(id=i, prompt=list(p), max_new_tokens=n, eos_id=e))
        want[cls_engine] = {r.id: r.output for r in local.run_until_drained(100000)}
    assert want[StubEngine] == want[jax_engine.StubEngine] and len(want[StubEngine]) == 30
    router = Router(max_queue_per_replica=3, max_retry_backlog=1000)
    for i in range(n_replicas):
        router.add_replica(f"r{i}", StubEngine(slots))
    stream = [Request(id=i, prompt=list(p), max_new_tokens=n, eos_id=e)
              for i, (p, n, e) in enumerate(specs)]
    assert all(router.submit(r) for r in stream)
    done = router.flush(max_ticks=100000)
    assert sorted(r.id for r in done) == list(range(30))
    assert {r.id: r.output for r in done} == want[StubEngine]
