"""The serving mode of the rank entry (`launch/rank.py --serve`): D replicas
of M ranks each on a `--mesh DxM`, behind the port's router on rank 0.

    python3 -m repro_torch.launch.rank --serve --requests REQS.jsonl \\
        --outputs OUT.jsonl --mesh 2x1 [--slots 4] [--max-len 1024] \\
        [--queue 8] [--replica-timeout 600] [--p99-window 512] \\
        [--autoscale '{"min_replicas": 1, "max_replicas": 2}'] \\
        <the job's other arguments>

Replica d is the row of ranks d*M .. d*M+M-1. Each rank builds `--arch` (a
(1, M) view of its row where M > 1, `launch/mesh.py::row_view`, so its
params are whole within the row and no collective leaves it), draws the
seed's params (rank by rank the blocks of one process's model) and serves
them with a `ServeEngine` of `--slots` slots over `--max-len` positions,
wrapped in a `ReplicaActor`. Every rank runs its replica's ops as rank 0
writes them to the job's store (`serve/transport.py`).

Rank 0 also routes: a `Router` (`--queue` a replica, `--p99-window`
completions in its p99) over one `ActorReplicaHandle` per replica, each
over a `StoreTransport`. It offers each request of `--requests` (JSONL: id,
prompt, max_new_tokens, eos_id, arrival_s) at its arrival, `arrival_s`
seconds after the router's start (0 by default: every request at once),
re-offers a shed one, ticks until nothing is in flight and no request is
to come, appending each finished request to `--outputs` (JSONL: id,
replica, tick, output) as it finishes, and then sends every replica a
drain and an exit op (`drive`). While nothing is in flight it sleeps until
the next arrival and sends no op. A replica that does not answer within
`--replica-timeout` seconds is lost (`ReplicaLost` at its next tick or
drain) and failed: its requests, those handed to it after the op that
timed out included, are re-routed and re-decoded. That bounds every wait
of rank 0, its own replica's too: rank 0 leads r0 from a thread of its own
(`ServerThread`) and reaches it through the store as it reaches every
other replica, so a member of r0 that dies holds that thread, never the
router, in r0's collective. (A router rank that serves no replica would
need a rank without a card, which neither backend starts: srun and the
Kubernetes Job start one task a card.)

With `--autoscale JSON` (`ReplicaScalingConfig`'s fields) the D rows are
the allocation and a `ReplicaAutoscaler` the set the router serves
through: every row builds its engine at start, the router registers the
`min_replicas` lowest rows, the autoscaler (ticked after each router tick on the router's
clock) grows the lowest parked rows and shrinks the highest registered
ones through `Router.retire_replica`'s drain, never the last one; a
retired row is parked again, its ranks up for a later grow under the same
id. `max_replicas` may not exceed D.

Every rank warms its engine with one request before it reports ready
(`build_engine`), so no row's first tick, a grown row's included, pays
the process's first prefill and decode on the card.

SIGTERM to a replica's rank marks the replica exiting; rank 0 retires it
(it finishes what it holds), records the router tick, and its ranks exit
EXIT_PREEMPTED (75). SIGTERM to rank 0 retires every replica, and every
rank exits 75. Each rank prints one JSON line when it stops (`serve_rank`);
rank 0's adds the router's record. `replay` runs rank 0's loop again in
one process, over the same transport on an in-memory store with local
actors: each request offered at the tick rank 0 offered it, each scaling
decision applied at its tick to its rows, the replicas exiting and lost at
the ops where rank 0 saw them so: the same tokens, assignment and stats,
on the same params and device.
"""
from __future__ import annotations

import collections
import json
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.backends.slurm_gpu import EXIT_PREEMPTED
from repro_torch.distributed import job_store
from repro_torch.launch.mesh import make_mesh, row_view
from repro_torch.launch.rank import SEED, TIMEOUT_S, job_config, launches, mesh_of
from repro_torch.models import build_model
from repro_torch.serve.autoscaler import ReplicaAutoscaler, ReplicaScalingConfig, ScalingEvent
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.router import ActorReplicaHandle, ReplicaActor, Router
from repro_torch.serve.transport import (ReplicaLost, ReplicaServer, StoreTransport, peer_lost,
                                         wait_for)

# longest sleep of rank 0 waiting for the next arrival (a signal is seen
# within it)
IDLE_SLEEP_S = 0.05
# a rank's warm-up request: prompt tokens (at most half a slot's
# positions), new tokens (one prefill and one decode step)
WARM_PROMPT, WARM_NEW = 64, 2


@dataclass
class TimedRequest(Request):
    """A request of a requests file, with its arrival: seconds after the
    router's start."""
    arrival_s: float = 0.0


def read_requests(path: str) -> List[TimedRequest]:
    """The requests of a JSONL file: id, prompt, max_new_tokens (16),
    eos_id (-1), arrival_s (0)."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [TimedRequest(id=int(r["id"]), prompt=[int(t) for t in r["prompt"]],
                         max_new_tokens=int(r.get("max_new_tokens", 16)),
                         eos_id=int(r.get("eos_id", -1)),
                         arrival_s=float(r.get("arrival_s", 0.0))) for r in rows]


def row(rid: str) -> int:
    """The mesh row of replica `rid` ("r<d>")."""
    return int(rid[1:])


def drive(router: Router, requests: List[Request], links: Dict[str, Any],
          stopping: Callable[[], bool] = lambda: False,
          completed: Optional[Callable[[Request, str, int], Any]] = None, *,
          scaler: Optional[Callable[[Router, Callable, Callable], Any]] = None,
          offered: Optional[Dict[str, int]] = None,
          sleep: Callable[[float], Any] = time.sleep) -> Dict[str, Any]:
    """Rank 0's serving loop over `router`, whose replica r's handle calls
    through `links[r]` (a replica of `links` not registered is parked).
    Each turn, as the reference's open-loop `run_serve`: offer the requests
    whose arrival has come (`arrival_s` on the router's clock from the
    start; with `offered`, request id -> tick, at that many router ticks,
    in its order, as the replay does), re-offer the shed ones, run one
    router tick, then tick the autoscaler `scaler(router, grow, shrink)`
    makes (`grow(count)` registers the lowest parked rows, `shrink(count)`
    retires the highest registered ones, never the last; both take the
    rows as `ids=` from a replay); then retire a replica whose link says it
    is exiting (every replica once `stopping()`). A replica whose tick or
    drain raised `ReplicaLost` is failed (a lost replica's submits do not
    raise: `serve/transport.py`). While nothing is in flight and the next
    arrival is ahead, it `sleep`s and sends no op. Once nothing is in
    flight and no request is to come, it drains every registered replica
    and posts an exit op to every one it has not retired. `completed(req,
    replica, tick)` sees each request as it finishes. Returns the record
    of the run: the replicas `retired` on a signal and `failed` (tick and
    op), the tick it `stopped` at, the `initial` rows, the ticks started
    when each request was first offered (`submitted`), the `scaling`
    events (tick, seconds, action, count, reason, rows before, `ids`, and
    for a shrink the requests each row finished in its drain, `drained`),
    the row count at each
    change (`rows`: tick, seconds, count), each request's arrival, offer
    and completion in seconds (`times`), the router's stats and p99, and
    each request's replica, completions and output."""
    rec = {"retired": {}, "failed": {}, "stopped": None, "resubmitted": 0,
           "initial": sorted(router.replicas, key=row), "submitted": {}, "scaling": [],
           "rows": [], "times": {}}
    t0 = router.clock()
    started = [0]   # router ticks started
    seen: set = set()
    exited: set = set()

    def now() -> float:
        return router.clock() - t0

    def call(fn, *args):
        try:
            return fn(*args)
        except ReplicaLost as e:
            rec["failed"][e.replica] = {"tick": router.stats["ticks"], "op": e.op}
            router.fail_replica(e.replica)

    def harvest():
        owner = {i: rid for rid, link in links.items() for i in link.done}
        for req in requests:
            if req.done and req.id not in seen:
                seen.add(req.id)
                rec["times"][str(req.id)].append(now())
                if completed is not None:
                    completed(req, owner[req.id], router.stats["ticks"])

    def retire(rid):
        rec["retired"][rid] = {"tick": router.stats["ticks"], "op": links[rid].exiting_at}
        call(router.retire_replica, rid)
        links[rid].post({"kind": "exit", "preempted": True})
        exited.add(rid)
        harvest()

    step: Dict[str, Any] = {}   # the rows this turn's grow or shrink took

    def grow(count: int, ids: Optional[List[str]] = None) -> int:
        if ids is None:
            ids = [rid for rid in sorted(links, key=row)
                   if rid not in router.replicas and rid not in rec["failed"]
                   and rid not in exited][:count]
        for rid in ids:   # the handle's first op refreshes its stats
            router.add_replica(rid, ActorReplicaHandle(links[rid]))
        step["ids"] = list(ids)
        return len(ids)

    def shrink(count: int, ids: Optional[List[str]] = None) -> int:
        if ids is None:
            ids = sorted(router.replicas, key=row,
                         reverse=True)[:min(count, len(router.replicas) - 1)]
        step.update(ids=list(ids), drained={})
        for rid in ids:
            done = call(router.retire_replica, rid) or []
            step["drained"][rid] = sorted(r.id for r in done)
        harvest()
        return len(ids)

    scaling = scaler(router, grow, shrink) if scaler is not None else None
    arrival = lambda req: getattr(req, "arrival_s", 0.0)   # a plain Request arrives at once
    if offered is None:
        waiting = collections.deque(sorted(requests, key=arrival))
        due = lambda req: now() >= arrival(req)
    else:
        by_id = {str(r.id): r for r in requests}
        waiting = collections.deque(by_id[i] for i in offered)
        due = lambda req: offered[str(req.id)] <= started[0]
    shed: List[Request] = []
    rec["rows"].append([0, 0.0, len(router.replicas)])
    while router.replicas:
        if stopping():
            rec["stopped"] = router.stats["ticks"]
            for rid in sorted(router.replicas):
                retire(rid)
            break
        if router.idle() and not shed:
            if not waiting:
                break
            if not due(waiting[0]):
                if offered is not None:
                    raise RuntimeError(f"replay: request {waiting[0].id} is offered at tick "
                                       f"{offered[str(waiting[0].id)]}, and nothing is in "
                                       f"flight at tick {started[0]}")
                sleep(max(0.0, min(IDLE_SLEEP_S, arrival(waiting[0]) - now())))
                continue
        while waiting and due(waiting[0]):
            req = waiting.popleft()
            rec["submitted"][str(req.id)] = started[0]
            rec["times"][str(req.id)] = [arrival(req), now()]
            if not router.submit(req):
                shed.append(req)
        rec["resubmitted"] += len(shed)
        shed = [req for req in shed if not router.submit(req)]
        started[0] += 1
        call(router.tick)
        harvest()
        if scaling is not None:
            step.clear()
            ev = scaling.tick()
            if ev is not None:
                rec["scaling"].append({"tick": started[0], "t": ev.at - t0, "action": ev.action,
                                       "count": ev.count, "reason": ev.reason,
                                       "before": ev.workers_before, **step})
        for rid in sorted(router.replicas):
            if links[rid].exiting:
                retire(rid)
        if len(router.replicas) != rec["rows"][-1][2]:
            rec["rows"].append([started[0], now(), len(router.replicas)])
    for rid in sorted(router.replicas):
        call(router.replicas[rid].run_until_drained)
    harvest()
    for rid in sorted(links, key=row):   # a failed replica's rank still up reads it and leaves
        if rid not in exited:
            links[rid].post({"kind": "exit", "preempted": False})
    reports = [i for link in links.values() for i in link.done]
    owner = {i: rid for rid, link in links.items() for i in link.done}
    rec.update(stats=dict(router.stats), snapshot=router.snapshot(), p99_ms=router.p99_ms(),
               assigned={str(r.id): owner.get(r.id) for r in requests},
               completions={str(r.id): reports.count(r.id) for r in requests},
               outputs={str(r.id): list(r.output) for r in requests if r.done},
               unserved=[r.id for r in requests if not r.done])
    return rec


class Replayed:
    """The scaling decisions of a recorded run (its record's `scaling`),
    each applied at its tick to its rows: the replay's autoscaler."""

    def __init__(self, events: List[Dict[str, Any]], router: Router, grow, shrink):
        self.events = collections.deque(events)
        self.router, self.grow, self.shrink = router, grow, shrink
        self.ticks = 0

    def tick(self, now: Optional[float] = None) -> Optional[ScalingEvent]:
        self.ticks += 1
        if not self.events or self.events[0]["tick"] != self.ticks:
            return None
        e = self.events.popleft()
        before = len(self.router.replicas)
        fn = self.grow if e["action"] == "scale_up" else self.shrink
        got = fn(len(e["ids"]), ids=list(e["ids"]))
        return ScalingEvent(self.router.clock() if now is None else now, e["action"], got,
                            e["reason"], before)


def local_links(actors: Dict[str, Any], routed: Optional[Dict[str, Any]] = None):
    """A `StoreTransport` a replica on one in-memory store, each to its own
    `ReplicaServer` over `actors[r]` run in the caller's thread: the replica
    exiting from the op and lost at the op where rank 0's record `routed`
    saw it."""
    routed = routed or {"retired": {}, "failed": {}}
    store = dist.HashStore()
    links = {}
    for rid, actor in actors.items():
        marked = (routed["retired"].get(rid) or {}).get("op")
        server = ReplicaServer(store, rid, actor, lead=True, timeout=0.0,
                               signalled=lambda: False)
        if marked is not None:
            server.signalled = lambda s=server, at=marked: s.n >= at
        lost = (routed["failed"].get(rid) or {}).get("op")
        links[rid] = StoreTransport(store, rid, 0.0,
                                    local=server if lost is None else LostAt(server, lost))
    return links


def replay(requests: List[Request], actors: Dict[str, Any], routed: Dict[str, Any],
           queue: int, router: Optional[Router] = None) -> Dict[str, Any]:
    """`drive` over local `actors` (replica id -> ReplicaActor) through
    `local_links`: the replicas rank 0 registered at start, each request
    offered at the tick rank 0 offered it, each scaling decision of its
    record `routed` at its tick with its rows, stopped at the tick where
    rank 0 stopped. `router` (default: a fresh one of `queue` a replica) is
    the one driven. Rank 0's run, replayed in this process."""
    links = local_links(actors, routed)
    router = router if router is not None else Router(max_queue_per_replica=queue)
    for rid in routed.get("initial", sorted(links, key=row)):
        router.add_replica(rid, ActorReplicaHandle(links[rid]))
    stopped = routed["stopped"]
    events = routed.get("scaling") or []
    return drive(router, requests, links,
                 stopping=lambda: stopped is not None and router.stats["ticks"] >= stopped,
                 scaler=(lambda r, g, s: Replayed(events, r, g, s)) if events else None,
                 offered=routed.get("submitted"))


class LostAt:
    """A replica's server that runs its ops before op `op` and none from
    it on: the replay's replica lost at that op."""

    def __init__(self, server: ReplicaServer, op: int):
        self.server, self.op = server, op

    def step(self):
        if self.server.n + 1 < self.op:
            self.server.step()


class ServerThread(threading.Thread):
    """Rank 0's own replica's server on a thread of its own, on `dev` (the
    card is current per thread), so rank 0's router waits for r0 on the
    store alone, with its `--replica-timeout`. Keeps the exit op it
    stopped at, or the error it stopped with."""

    def __init__(self, server: ReplicaServer, dev: torch.device):
        super().__init__(name=f"replica-{server.replica}", daemon=True)
        self.server, self.dev = server, dev
        self.exit_op: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None

    def run(self):
        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev)
        try:
            self.exit_op = self.server.serve()
        except Exception as e:   # the router lost r0, or has its ReplicaFailed
            self.error = e


def build_engine(args, dev, shape):
    """This rank's `ServeEngine`: `--arch` on a (1, M) view of its row (a
    collective where M > 1: the mesh's groups), the seed's params; and the
    engine stats of its warm-up. One request goes through an engine first
    and the rank serves from a fresh one: a process's first prefill and
    decode step pay its start on the card (seconds on a shared card,
    PERF.md), which the router must not wait on at a tick."""
    mesh = None
    if shape[1] > 1:
        mesh = make_mesh(shape, ("data", "model"), device=dev)
        if shape[0] > 1:
            mesh = row_view(mesh)
    model = build_model(job_config(args), device=dev, mesh=mesh)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    engine = ServeEngine(model, params, batch_slots=args.slots, max_len=args.max_len, device=dev)
    engine.add_request(Request(id=-1, prompt=[1] * min(WARM_PROMPT, args.max_len // 2),
                               max_new_tokens=WARM_NEW))
    engine.run_until_drained()
    warmed = {k: engine.stats[k] for k in ("prefills", "ticks")}
    engine = ServeEngine(model, params, batch_slots=args.slots, max_len=args.max_len, device=dev)
    if dev.type == "cuda":   # the draw's fp32 transients go back to the card's other ranks
        torch.cuda.empty_cache()
    return engine, warmed


def scaling_config(args, rows: int) -> Optional[ReplicaScalingConfig]:
    """`--autoscale`'s config, or None; its `max_replicas` within the
    job's `rows`."""
    if not args.autoscale:
        return None
    cfg = ReplicaScalingConfig(**json.loads(args.autoscale))
    if not 1 <= cfg.min_replicas <= cfg.max_replicas <= rows:
        raise ValueError(f"--autoscale: want 1 <= min_replicas <= max_replicas <= {rows} (the "
                         f"mesh's rows), got {cfg.min_replicas} and {cfg.max_replicas}")
    return cfg


def serve_rank(args, dev, store_path: str, entered: float, joined: float) -> int:
    """One rank of a serving job, in a process group already formed: build,
    serve (rank 0 also routes), print the rank's JSON line; the exit code."""
    signals: list = []
    signal.signal(signal.SIGTERM, lambda *_: signals.append(time.time()))
    shape, axes = mesh_of(args.mesh, args.world)
    if axes != ("data", "model"):
        raise ValueError(f"--serve takes a DxM mesh, not {args.mesh}")
    replicas, width = shape
    scaling = scaling_config(args, replicas)
    rid = f"r{args.rank // width}"
    store = job_store("serve")
    engine, warmed = build_engine(args, dev, shape)
    server = ReplicaServer(store, rid, ReplicaActor(engine=engine), lead=args.rank % width == 0,
                           signalled=lambda: bool(signals), timeout=TIMEOUT_S)
    store.set(f"{rid}/ready/{args.rank}", "1")
    built = time.time()
    line = {"rank": args.rank, "world": args.world, "backend": dist.get_backend(),
            "store": store_path, "device": str(dev), "mesh": list(shape), "replica": rid}
    if args.rank == 0:
        thread = ServerThread(server, dev)
        thread.start()
        for r in range(args.world):   # a replica that never came up fails the job
            if wait_for(store, f"r{r // width}/ready/{r}", args.replica_timeout) is None:
                raise ReplicaLost(f"r{r // width}", 0, args.replica_timeout)
        requests = read_requests(args.requests)
        links = {f"r{d}": StoreTransport(store, f"r{d}", args.replica_timeout)
                 for d in range(replicas)}
        router = Router(max_queue_per_replica=args.queue, p99_window=args.p99_window)
        for r in sorted(links, key=row)[:scaling.min_replicas if scaling else replicas]:
            router.add_replica(r, ActorReplicaHandle(links[r]))
        with open(args.outputs, "w") as out:
            def completed(req, replica, tick):
                out.write(json.dumps({"id": req.id, "replica": replica, "tick": tick,
                                      "output": req.output}) + "\n")
                out.flush()

            rec = drive(router, requests, links, lambda: bool(signals), completed,
                        scaler=(lambda ro, grow, shrink: ReplicaAutoscaler(ro, grow, shrink,
                                                                           scaling))
                        if scaling else None)
        rec.pop("outputs")
        rec["store_ms"] = {r: link.store_ms for r, link in links.items()}
        preempted = bool(signals) or rid in rec["retired"]
        code = EXIT_PREEMPTED if preempted else (1 if rec["unserved"] else 0)
        # r0's thread read its exit op, or r0 was lost: its thread may sit in
        # a collective with a dead member, and is not waited for
        thread.join(0.0 if rid in rec["failed"] else args.replica_timeout)
        if thread.error is not None and not peer_lost(thread.error):
            code = 1   # r0's own fault, not a member gone
        line.update(role="router", router=rec,
                    server_error=None if thread.error is None else repr(thread.error))
    else:
        thread = None
        exit_op = server.serve()
        code = EXIT_PREEMPTED if signals or exit_op["preempted"] else 0
        line.update(role="lead" if server.lead else "member")
    served = time.time()
    line.update(ticks=len(server.tick_ms), tick_ms=server.tick_ms, engine=dict(engine.stats),
                warmup=warmed, signalled=bool(signals), exit=code,
                peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
                launches=launches(), entered=entered,
                seconds={"join": joined - entered, "build": built - joined,
                         "serve": served - built})
    print(json.dumps(line), flush=True)
    if thread is not None and thread.is_alive():
        # the thread holds r0's collective with a dead member: leave now, as
        # tearing the group down would wait on it
        sys.stderr.flush()
        os._exit(code)
    return code
