"""The port's serving router (src/repro_torch/serve/router.py: Router,
ReplicaActor, ActorReplicaHandle; its metrics, src/repro_torch/serve/
metrics.py) against the JAX package's (src/repro/serve/router.py), in
process on the CPU.

One scripted scenario runs through both routers over their own StubEngine
replicas, with an injected clock and a stats_sink: free-slot placement,
bounded queues, shedding to the retry buffer and then dropping,
`fail_replica` mid-decode, a replica added, `retire_replica` with work in
flight, `Router.recover`, and a flush. At every step the finished ids,
stats, snapshot, p99_ms, queue depth and in-flight count are equal, and so
are the outputs, every snapshot the sink saw and each histogram's counts,
sum and count. `ReplicaActor.handle` gives equal replies to equal
payloads, and `ActorReplicaHandle` over an in-process call routes as local
engines do. With models, the JAX ServeEngine under the JAX Router and the
port's under the port's give identical greedy tokens (fp32 SMOKE configs,
bridged params, 2 replicas x 2 slots).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import metrics as jax_metrics
from repro.models import build_model as jax_build_model
from repro.serve import engine as jax_engine
from repro.serve import router as jax_router
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import engine, metrics, router

SIDES = {"jax": (jax_router, jax_engine), "port": (router, engine)}
HISTOGRAMS = ("syndeo_router_queue_depth", "syndeo_router_shed_depth")


def _stream(rng, n, base=0):
    """n requests (id, prompt, budget, eos): a third end at an EOS token
    their stub output reaches before the budget."""
    out = []
    for i in range(n):
        prompt = rng.integers(0, 50_000, int(rng.integers(1, 6))).tolist()
        budget = int(rng.integers(1, 9))
        eos = -1
        if rng.random() < 1 / 3:
            eos = engine.StubEngine.stub_output(prompt, budget)[int(rng.integers(0, budget))]
        out.append((base + i, prompt, budget, eos))
    return out


def _histograms(reg):
    return {name: [(h.bounds, h.counts, h.sum, h.count) for h in reg.family(name).values()]
            for name in HISTOGRAMS}


def scenario(side, seed, n_replicas, slots=2):
    """The scripted run on one side; the trace of every step."""
    R, E = SIDES[side]
    rng = np.random.default_rng(seed)
    t = [0.0]
    sink = []
    kw = dict(max_queue_per_replica=1, max_retry_backlog=3, p99_window=16,
              clock=lambda: t[0], stats_sink=sink.append)
    rt = R.Router(**kw)
    for i in range(n_replicas):
        rt.add_replica(f"r{i}", E.StubEngine(slots))
    reqs, trace = {}, []

    def submit(specs):
        got = []
        for rid, p, n, e in specs:
            t[0] += 0.003
            reqs[rid] = E.Request(id=rid, prompt=list(p), max_new_tokens=n, eos_id=e)
            got.append(rt.submit(reqs[rid]))
        return got

    def step(label, value=None):
        t[0] += 0.011
        trace.append((label, value, dict(rt.stats), rt.snapshot(), rt.p99_ms(),
                      rt.queue_depth(), rt.inflight_count(), sorted(rt.replicas)))

    def tick(k):
        for _ in range(k):
            t[0] += 0.007
            step("tick", sorted(r.id for r in rt.tick()))

    # burst A: every free slot (queued until the next tick, so no queue has
    # room), the retry buffer, then 2 dropped
    n_a = n_replicas * slots + 3 + 2
    step("submit A", submit(_stream(rng, n_a)))
    tick(3)
    step("fail r1", rt.fail_replica("r1"))
    tick(2)
    step("submit B", submit(_stream(rng, 3, base=100)))
    rt.add_replica(f"r{n_replicas}", E.StubEngine(slots))
    step("add")
    step("retire r0", sorted(r.id for r in rt.retire_replica("r0")))
    tick(2)
    kw2 = dict(kw, stats_sink=sink.append)
    old_hist = _histograms(rt.metrics)
    rt, recovered = R.Router.recover(dict(rt.replicas), **kw2)
    step("recover", sorted((r.id, tuple(r.output)) for r in recovered))
    step("submit C", submit(_stream(rng, 5, base=200)))
    step("flush", sorted(r.id for r in rt.flush()))
    outputs = {rid: (list(r.output), r.done) for rid, r in reqs.items()}
    return {"trace": trace, "outputs": outputs, "sink": sink,
            "hist": [old_hist, _histograms(rt.metrics)]}


@pytest.mark.parametrize("seed", range(6))
def test_scripted_scenario_matches_the_jax_router(seed):
    n_replicas = 2 + seed % 2
    ref, got = scenario("jax", seed, n_replicas), scenario("port", seed, n_replicas)
    for a, b in zip(ref["trace"], got["trace"]):
        assert a == b, a[0]
    assert len(ref["trace"]) == len(got["trace"])
    assert got["outputs"] == ref["outputs"]
    assert got["sink"] == ref["sink"] and len(got["sink"]) > 0
    assert got["hist"] == ref["hist"]
    first = got["trace"][0]
    assert first[2]["shed"] == 2 and False in first[1]            # the dropped ones
    assert any(s[2]["rerouted"] for s in got["trace"])             # fail_replica took work
    # the first router's histograms: one queue depth a tick, one shed depth a drop
    old = [s[2] for s in got["trace"]][[s[0] for s in got["trace"]].index("recover") - 1]
    assert got["hist"][0]["syndeo_router_shed_depth"][0][3] == old["shed"]
    assert got["hist"][0]["syndeo_router_queue_depth"][0][3] == old["ticks"]


def test_metrics_copy_has_the_reference_bounds_and_quantiles():
    for name in HISTOGRAMS:
        ref = jax_metrics.MetricsRegistry().histogram(name)
        mine = metrics.MetricsRegistry().histogram(name)
        assert mine.bounds == ref.bounds
        for v in (0.0, 0.2, 0.25, 3.0, 1e4):
            ref.observe(v)
            mine.observe(v)
        assert (mine.counts, mine.sum, mine.count) == (ref.counts, ref.sum, ref.count)
        assert [mine.quantile(q) for q in (0.1, 0.5, 0.99)] == \
            [ref.quantile(q) for q in (0.1, 0.5, 0.99)]
    assert metrics.TIME_BUCKETS == jax_metrics.TIME_BUCKETS
    reg, jreg = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    for r in (reg, jreg):
        r.counter("c", a="1").inc(3)
        r.gauge("g").set(2.5)
    assert [(n, lb, i.value) for n, lb, i in reg.samples()] == \
        [(n, lb, i.value) for n, lb, i in jreg.samples()]


PAYLOADS = [{"kind": "stats"},
            {"kind": "submit", "id": 1, "prompt": [3, 4], "max_new_tokens": 3},
            {"kind": "submit", "id": 2, "prompt": [9], "max_new_tokens": 5, "eos_id": -1},
            {"kind": "submit", "id": 3, "prompt": [], "max_new_tokens": 2},
            {"kind": "tick"}, {"kind": "stats"}, {"kind": "tick"}, {"kind": "tick"},
            {"kind": "submit", "id": 4, "prompt": [7, 7, 7], "max_new_tokens": 4},
            {"kind": "drain"}, {"kind": "stats"}, {"kind": "tick"}]


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_replica_actor_replies_as_the_jax_actor(slots):
    actors = [S[0].ReplicaActor(batch_slots=slots) for S in SIDES.values()]
    for p in PAYLOADS:
        assert actors[1].handle(dict(p)) == actors[0].handle(dict(p)), p
    for a in actors:
        with pytest.raises(ValueError, match="unknown replica op"):
            a.handle({"kind": "nope"})


@pytest.mark.parametrize("against", ["local", "jax_handle"])
@pytest.mark.parametrize("n_replicas", [2, 3])
def test_actor_handle_routes_as_local_engines(against, n_replicas):
    """The port's Router over ActorReplicaHandle(ReplicaActor(...).handle)
    places, finishes and counts as over the engines themselves, and as the
    JAX package's handle does."""
    def run(make):
        rng = np.random.default_rng(7 + n_replicas)
        rt = make["router"].Router(max_queue_per_replica=2, max_retry_backlog=100)
        for i in range(n_replicas):
            rt.add_replica(f"r{i}", make["replica"]())
        E = make["engine"]
        reqs = [E.Request(id=i, prompt=list(p), max_new_tokens=n, eos_id=e)
                for i, p, n, e in _stream(rng, 24)]
        placed = [rt.submit(r) for r in reqs]
        ticks = [sorted(r.id for r in rt.tick()) for _ in range(4)]
        done = sorted(r.id for r in rt.flush())
        return placed, ticks, done, [list(r.output) for r in reqs], dict(rt.stats)

    def handle_of(side):
        R, E = SIDES[side]
        return lambda: R.ActorReplicaHandle(R.ReplicaActor(engine=E.StubEngine(2)).handle)

    mine = run({"router": router, "engine": engine, "replica": handle_of("port")})
    if against == "local":
        want = run({"router": router, "engine": engine,
                    "replica": lambda: engine.StubEngine(2)})
    else:
        want = run({"router": jax_router, "engine": jax_engine, "replica": handle_of("jax")})
    assert mine == want


def _engines(arch, slots=2, max_len=48, seed=0):
    jcfg = jax_get_config(arch, smoke=True).replace(param_dtype="float32")
    cfg = get_config(arch, smoke=True).replace(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    model, params = build_model(cfg, device="cpu"), bridge.params_from_jax(jp)
    return (lambda: jax_engine.ServeEngine(jm, jp, batch_slots=slots, max_len=max_len),
            lambda: engine.ServeEngine(model, params, batch_slots=slots, max_len=max_len,
                                       device="cpu"))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b"])
def test_greedy_tokens_under_both_routers(arch):
    """The JAX ServeEngine under the JAX Router and the port's under the
    port's: identical greedy tokens, completion order and stats, over 2
    replicas x 2 slots (qwen: the int8 cache)."""
    makers = _engines(arch)
    rng = np.random.default_rng(11)
    specs = [(rng.integers(1, 200, 3 + i % 3).tolist(), 3 + i % 4) for i in range(9)]
    runs = []
    for (R, E), make in zip(SIDES.values(), makers):
        rt = R.Router(max_queue_per_replica=1)
        for rid in ("r0", "r1"):
            rt.add_replica(rid, make())
        reqs = [E.Request(id=i, prompt=list(p), max_new_tokens=n) for i, (p, n) in
                enumerate(specs)]
        assert all(rt.submit(r) for r in reqs)
        order = [sorted(r.id for r in rt.tick()) for _ in range(3)]
        order.append(sorted(r.id for r in rt.flush()))
        runs.append(([list(r.output) for r in reqs], order, dict(rt.stats)))
    assert runs[1] == runs[0]
    assert all(len(out) == n for out, (_, n) in zip(runs[1][0], specs))
