"""The port's replica autoscaler (src/repro_torch/serve/autoscaler.py) held to
the JAX package's (src/repro/core/autoscaler.py), in process on the CPU.

Three kinds of case: the config's and the event's fields and defaults;
scripted decisions on an injected clock (the p99 trigger, the depth
trigger, both cooldowns, `max_step`, the `min_replicas` and `max_replicas`
caps, a `grow_fn` and a `shrink_fn` that under-deliver), each package over
its own `Router` and `StubEngine`, the events and the calls to grow and
shrink equal; and one open-loop serving run on a virtual clock in the
order of the reference's `SimCluster.run_serve` (offer the arrivals,
re-offer the shed, one router tick, then the autoscaler), written once
here and run over each package's `Router`, `StubEngine` and
`ReplicaAutoscaler`, with a ramp and then a quiet tail (the arrivals and
config of tests/test_serve_plane.py's
`test_slo_autoscaler_grows_under_ramp_and_drains_when_quiet`): the events,
the requests completed at each tick, the outputs and the router's stats
equal. The port's `launch/serve.py::drive` in its timed mode on the same
clock gives the same, and `replay` of its record the same again. The clock
advances one tick of 10 ms with each router tick, and with each turn the
loop waits for an arrival while nothing is in flight (it then ticks
nothing, as `drive` sleeps and sends no op).
"""
import collections
import dataclasses

import pytest

from repro.core import autoscaler as jax_autoscaler
from repro.serve import engine as jax_engine
from repro.serve import router as jax_router
from repro_torch.launch.serve import TimedRequest, drive, local_links, replay
from repro_torch.serve import autoscaler, engine, router
from repro_torch.serve.router import ActorReplicaHandle, ReplicaActor

PACKAGES = {
    "jax": (jax_router.Router, jax_engine.StubEngine, jax_autoscaler.ReplicaAutoscaler,
            jax_autoscaler.ReplicaScalingConfig, jax_engine.Request),
    "torch": (router.Router, engine.StubEngine, autoscaler.ReplicaAutoscaler,
              autoscaler.ReplicaScalingConfig, engine.Request),
}


@pytest.mark.parametrize("name", ["ScalingEvent", "ReplicaScalingConfig"])
def test_fields_and_defaults_are_the_reference(name):
    """The port's config and event have the reference's fields, in order,
    with its defaults."""
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(getattr(autoscaler, name)) == spec(getattr(jax_autoscaler, name))


# ------------------------------------------------------ scripted decisions


# config, then a script: ("at", t) sets the clock, ("lat", s, n) puts n
# latencies of s seconds in the router's p99 window, ("load", n) submits n
# requests, ("flush",) serves everything, ("budget", g, s) caps what grow
# and shrink deliver, ("tick",) ticks the autoscaler
SCRIPTS = {
    "p99": (dict(p99_target_ms=150.0, queue_depth_target=100.0),
            [("at", 100.0), ("lat", 0.5, 16), ("tick",)]),
    "depth": (dict(p99_target_ms=1e9, queue_depth_target=2.0),
              [("load", 12), ("tick",), ("at", 0.5), ("tick",), ("at", 1.0), ("tick",)]),
    "up_cooldown": (dict(p99_target_ms=1e9, queue_depth_target=1.0, max_step=1,
                         scale_up_cooldown_s=2.0),
                    [("load", 30), ("tick",), ("at", 1.9), ("tick",), ("at", 2.0), ("tick",),
                     ("at", 3.0), ("tick",), ("at", 4.0), ("tick",)]),
    "down_cooldown": (dict(max_step=1, scale_up_cooldown_s=0.0, scale_down_cooldown_s=10.0),
                      [("load", 40), ("tick",), ("at", 0.1), ("tick",), ("at", 0.2), ("tick",),
                       ("flush",), ("at", 1.0), ("tick",),
                       ("at", 5.0), ("tick",), ("at", 11.0), ("tick",), ("at", 20.9), ("tick",),
                       ("at", 21.0), ("tick",)]),
    "max_step_and_max": (dict(p99_target_ms=1e9, queue_depth_target=1.0, max_step=5,
                              max_replicas=3),
                         [("load", 40), ("tick",), ("at", 5.0), ("tick",)]),
    "min_replicas": (dict(min_replicas=2, max_step=4, queue_depth_target=1.0),
                     [("load", 20), ("tick",), ("flush",), ("at", 20.0), ("tick",),
                      ("at", 40.0), ("tick",)]),
    "under_delivery": (dict(p99_target_ms=1e9, queue_depth_target=1.0, max_step=2,
                            scale_down_cooldown_s=1.0),
                       [("budget", 0, 0), ("load", 20), ("tick",), ("budget", 1, 0),
                        ("at", 0.1), ("tick",), ("flush",), ("at", 5.0), ("tick",),
                        ("budget", 1, 1), ("at", 5.1), ("tick",), ("at", 5.2), ("tick",)]),
}


def scripted(pkg, name):
    """The script `name` on one package: each tick's event, the events, and
    every call of grow and shrink with what it delivered."""
    Router, StubEngine, Autoscaler, Config, Request = PACKAGES[pkg]
    cfg, script = SCRIPTS[name]
    now = [0.0]
    r = Router(max_queue_per_replica=64, max_retry_backlog=64, p99_window=16,
               clock=lambda: now[0])
    r.add_replica("r00", StubEngine(2))
    budget, calls, made = [99, 99], [], iter(range(1, 100))

    def grow(n):
        k = min(n, budget[0])
        for _ in range(k):
            r.add_replica(f"r{next(made):02d}", StubEngine(2))
        calls.append(("grow", n, k))
        return k

    def shrink(n):
        k = min(n, budget[1], len(r.replicas) - 1)
        for rid in sorted(r.replicas, reverse=True)[:k]:
            r.retire_replica(rid)
        calls.append(("shrink", n, k))
        return k

    ras = Autoscaler(r, grow, shrink, Config(**cfg))
    ticks, ids = [], iter(range(1000))
    for op, *args in script:
        if op == "at":
            now[0] = args[0]
        elif op == "lat":
            r._latencies.extend([args[0]] * args[1])
        elif op == "load":
            for _ in range(args[0]):
                i = next(ids)
                assert r.submit(Request(id=i, prompt=[i, 3], max_new_tokens=4))
        elif op == "flush":
            r.flush()
        elif op == "budget":
            budget[:] = args
        else:
            ev = ras.tick()
            ticks.append(None if ev is None else dataclasses.astuple(ev))
    return ticks, [dataclasses.astuple(e) for e in ras.events], calls


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scripted_decisions_are_the_reference(name):
    """Each script gives the reference's events, tick by tick, and the same
    calls to grow and shrink."""
    got, want = scripted("torch", name), scripted("jax", name)
    assert got == want
    actions = [e[1] for e in got[1]]
    expect = {"p99": ["scale_up"], "depth": ["scale_up", "scale_up"],
              "up_cooldown": ["scale_up", "scale_up", "scale_up"],
              "down_cooldown": ["scale_up"] * 3 + ["scale_down"] * 3,
              "max_step_and_max": ["scale_up"], "min_replicas": ["scale_up", "scale_down"],
              "under_delivery": ["scale_up", "scale_down"]}[name]
    assert actions == expect, got
    if name == "p99":
        assert "p99" in got[1][0][3]
    if name == "max_step_and_max":
        assert got[1][0][2] == 2 and got[2] == [("grow", 2, 2)]
    if name == "under_delivery":   # the event counts what grow and shrink delivered
        assert got[2][:2] == [("grow", 2, 0), ("grow", 2, 1)] and got[1][0][2] == 1
        assert got[1][1][2] == 1 and ("shrink", 1, 0) in got[2]


# ------------------------------------------ one open-loop run, virtual clock

TICK = 0.01
SLOTS, ROWS = 4, 4
CONFIG = dict(min_replicas=1, max_replicas=ROWS, p99_target_ms=150.0, queue_depth_target=3.0,
              low_water_fraction=0.5, scale_up_cooldown_s=0.05, scale_down_cooldown_s=0.4,
              max_step=2)
ROUTER = dict(max_queue_per_replica=6, max_retry_backlog=4096, p99_window=16)


def arrivals():
    """(seconds, id, prompt, new tokens): a ramp of 140 requests at 200/s,
    then a quiet tail of 30 at 10/s."""
    out = [(0.01 + 0.005 * i, i, [i, 17], 8) for i in range(140)]
    return out + [(1.0 + 0.1 * i, 1000 + i, [1000 + i, 17], 4) for i in range(30)]


def virtual_clock():
    k = [0]
    return k, (lambda: k[0] * TICK), (lambda *_: k.__setitem__(0, k[0] + 1))


def loop(pkg):
    """The run in `run_serve`'s order over one package's router of ROWS
    StubEngine rows, r0 registered: the events, the ids completed at each
    router tick, the outputs and the stats."""
    Router, StubEngine, Autoscaler, Config, Request = PACKAGES[pkg]
    k, clock, advance = virtual_clock()
    r = Router(clock=clock, stats_sink=advance, **ROUTER)
    rows = {f"r{d}": StubEngine(SLOTS) for d in range(ROWS)}
    r.add_replica("r0", rows["r0"])
    per_tick = collections.defaultdict(list)

    def grow(n):
        ids = [rid for rid in sorted(rows) if rid not in r.replicas][:n]
        for rid in ids:
            r.add_replica(rid, rows[rid])
        return len(ids)

    def shrink(n):
        ids = sorted(r.replicas, reverse=True)[:min(n, len(r.replicas) - 1)]
        for rid in ids:
            per_tick[r.stats["ticks"]] += [q.id for q in r.retire_replica(rid)]
        return len(ids)

    ras = Autoscaler(r, grow, shrink, Config(**CONFIG))
    reqs = [(t, Request(id=i, prompt=p, max_new_tokens=n)) for t, i, p, n in arrivals()]
    waiting, shed = collections.deque(reqs), []
    while True:
        if r.idle() and not shed:
            if not waiting:
                break
            if clock() < waiting[0][0]:   # nothing in flight: wait, tick nothing
                advance()
                continue
        while waiting and clock() >= waiting[0][0]:
            q = waiting.popleft()[1]
            if not r.submit(q):
                shed.append(q)
        shed = [q for q in shed if not r.submit(q)]
        done = r.tick()
        per_tick[r.stats["ticks"]] += [q.id for q in done]
        ras.tick()
    events = [(e.at, e.action, e.count, e.reason, e.workers_before) for e in ras.events]
    return dict(events=events, completions={t: sorted(v) for t, v in per_tick.items() if v},
                outputs={str(q.id): list(q.output) for _, q in reqs}, stats=dict(r.stats))


def drive_run():
    """The same run through `drive` in its timed mode, over ROWS
    `ReplicaActor`s behind `ActorReplicaHandle`s and `local_links`: what
    `loop` returns, and drive's record."""
    k, clock, advance = virtual_clock()
    r = router.Router(clock=clock, stats_sink=advance, **ROUTER)
    links = local_links({f"r{d}": ReplicaActor(batch_slots=SLOTS) for d in range(ROWS)})
    r.add_replica("r0", ActorReplicaHandle(links["r0"]))
    reqs = [TimedRequest(id=i, prompt=p, max_new_tokens=n, arrival_s=t)
            for t, i, p, n in arrivals()]
    per_tick = collections.defaultdict(list)
    cfg = autoscaler.ReplicaScalingConfig(**CONFIG)
    rec = drive(r, reqs, links, completed=lambda q, rid, tick: per_tick[tick].append(q.id),
                scaler=lambda ro, g, s: autoscaler.ReplicaAutoscaler(ro, g, s, cfg),
                sleep=advance)
    events = [(e["t"], e["action"], e["count"], e["reason"], e["before"]) for e in rec["scaling"]]
    return dict(events=events, completions={t: sorted(v) for t, v in per_tick.items()},
                outputs=rec["outputs"], stats=rec["stats"]), rec, reqs


@pytest.fixture(scope="module")
def runs():
    port, rec, reqs = drive_run()
    for q in reqs:   # the replay starts from the requests as they came
        q.output, q.done = [], False
    again = replay(reqs, {f"r{d}": ReplicaActor(batch_slots=SLOTS) for d in range(ROWS)}, rec,
                   ROUTER["max_queue_per_replica"],
                   router.Router(**ROUTER))
    return {"jax": loop("jax"), "torch": loop("torch"), "drive": port, "record": rec,
            "replay": again}


ASPECTS = ["events", "completions", "outputs", "stats"]


@pytest.mark.parametrize("aspect", ASPECTS)
def test_the_ramp_and_quiet_loop_is_the_reference(runs, aspect):
    """The loop over the port's Router, StubEngine and ReplicaAutoscaler
    gives the reference's events, completions a tick, outputs and stats."""
    assert runs["torch"][aspect] == runs["jax"][aspect]


@pytest.mark.parametrize("aspect", ASPECTS)
def test_drive_in_its_timed_mode_is_the_loop(runs, aspect):
    """`drive` on the same virtual clock, through the actors' transport,
    gives what the reference's loop gives."""
    assert runs["drive"][aspect] == runs["jax"][aspect]


def test_the_run_grows_under_the_ramp_and_shrinks_when_quiet(runs):
    """The reference's shape: at least one scale-up while the ramp arrives,
    one scale-down in the quiet tail, the peak above one replica, every
    request served once, and what a retired row's drain finished, that row
    finished."""
    rec = runs["record"]
    ups = [e for e in rec["scaling"] if e["action"] == "scale_up"]
    downs = [e for e in rec["scaling"] if e["action"] == "scale_down"]
    assert ups and ups[0]["t"] < 0.71 and max(n for _, _, n in rec["rows"]) > 1
    assert downs and downs[-1]["t"] > 1.0
    assert rec["unserved"] == [] and set(rec["completions"].values()) == {1}
    for e in downs:
        for rid, ids in e["drained"].items():
            assert all(rec["assigned"][str(i)] == rid for i in ids)
    assert all(e["ids"] and len(e["ids"]) == e["count"] for e in rec["scaling"])


@pytest.mark.parametrize("aspect", ["outputs", "assigned", "stats", "scaling", "submitted"])
def test_the_replay_of_drive_is_drive(runs, aspect):
    """`replay` of drive's record, each request offered at its recorded
    tick and each scaling decision applied at its tick to its rows, gives
    drive's tokens, assignment, stats, scaling rows and offer ticks."""
    got, want = runs["replay"][aspect], runs["record"][aspect]
    if aspect == "scaling":
        got, want = ([(e["tick"], e["action"], e["ids"], e.get("drained")) for e in x]
                     for x in (got, want))
    assert got == want
