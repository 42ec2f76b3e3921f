"""The serving mode of the rank entry (`launch/rank.py --serve`): D replicas
of M ranks each on a `--mesh DxM`, behind the port's router on rank 0.

    python3 -m repro_torch.launch.rank --serve --requests REQS.jsonl \\
        --outputs OUT.jsonl --mesh 2x1 [--slots 4] [--max-len 1024] \\
        [--queue 8] [--replica-timeout 600] <the job's other arguments>

Replica d is the row of ranks d*M .. d*M+M-1. Each rank builds `--arch` (a
(1, M) view of its row where M > 1, `launch/mesh.py::row_view`, so its
params are whole within the row and no collective leaves it), draws the
seed's params (rank by rank the blocks of one process's model) and serves
them with a `ServeEngine` of `--slots` slots over `--max-len` positions,
wrapped in a `ReplicaActor`. Every rank runs its replica's ops as rank 0
writes them to the job's store (`serve/transport.py`).

Rank 0 also routes: a `Router` (`--queue` a replica) over one
`ActorReplicaHandle` per replica, each over a `StoreTransport`. It submits
the requests of `--requests` (JSONL: id, prompt, max_new_tokens, eos_id)
in order, re-submits a shed one after the next tick, ticks until nothing
is in flight, appending each finished request to `--outputs` (JSONL: id,
replica, tick, output) as it finishes, and then sends every replica a
drain and an exit op (`drive`). A replica that does not answer within
`--replica-timeout` seconds is lost (`ReplicaLost` at its next tick or
drain) and failed: its requests, those handed to it after the op that
timed out included, are re-routed and re-decoded. That bounds every wait
of rank 0 but one: rank 0 serves its own replica r0 in process, and where
r0 has M > 1 ranks its ops run tensor-parallel collectives with r0's other
ranks, so a member of r0 that dies holds rank 0 in a collective until the
group's timeout (`launch/rank.py::TIMEOUT_S`).

SIGTERM to a replica's rank marks the replica exiting; rank 0 retires it
(it finishes what it holds), records the router tick, and its ranks exit
EXIT_PREEMPTED (75). SIGTERM to rank 0 retires every replica, and every
rank exits 75. Each rank prints one JSON line when it stops (`serve_rank`);
rank 0's adds the router's record. `replay` runs rank 0's loop again in
one process, over the same transport on an in-memory store with local
actors, the replicas exiting and lost at the ops where rank 0 saw them
so: the same tokens, assignment and stats, on the same params and device.
"""
from __future__ import annotations

import json
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.backends.slurm_gpu import EXIT_PREEMPTED
from repro_torch.distributed import job_store
from repro_torch.launch.mesh import make_mesh, row_view
from repro_torch.launch.rank import SEED, TIMEOUT_S, job_config, launches, mesh_of
from repro_torch.models import build_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.router import ActorReplicaHandle, ReplicaActor, Router
from repro_torch.serve.transport import ReplicaLost, ReplicaServer, StoreTransport, wait_for


def read_requests(path: str) -> List[Request]:
    """The requests of a JSONL file: id, prompt, max_new_tokens (16),
    eos_id (-1)."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [Request(id=int(r["id"]), prompt=[int(t) for t in r["prompt"]],
                    max_new_tokens=int(r.get("max_new_tokens", 16)),
                    eos_id=int(r.get("eos_id", -1))) for r in rows]


def drive(router: Router, requests: List[Request], links: Dict[str, Any],
          stopping: Callable[[], bool] = lambda: False,
          completed: Optional[Callable[[Request, str, int], Any]] = None) -> Dict[str, Any]:
    """Rank 0's serving loop over `router`, whose replica r's handle calls
    through `links[r]`: submit `requests` in order, tick until idle,
    retiring a replica whose link says it is exiting (every replica once
    `stopping()`) and failing one whose tick or drain raised `ReplicaLost`
    (a lost replica's submits do not raise: `serve/transport.py`); then
    drain every replica and post each one an exit op. `completed(req,
    replica, tick)` sees each request as it finishes. Returns the record of
    the run."""
    rec = {"retired": {}, "failed": {}, "stopped": None, "resubmitted": 0}
    seen: set = set()

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
                if completed is not None:
                    completed(req, owner[req.id], router.stats["ticks"])

    def retire(rid):
        rec["retired"][rid] = {"tick": router.stats["ticks"], "op": links[rid].exiting_at}
        call(router.retire_replica, rid)
        links[rid].post({"kind": "exit", "preempted": True})
        harvest()

    shed = [req for req in requests if not router.submit(req)]
    while router.replicas:
        if stopping():
            rec["stopped"] = router.stats["ticks"]
            for rid in sorted(router.replicas):
                retire(rid)
            break
        if router.idle() and not shed:
            break
        call(router.tick)
        harvest()
        rec["resubmitted"] += len(shed)
        shed = [req for req in shed if not router.submit(req)]
        for rid in sorted(router.replicas):
            if links[rid].exiting:
                retire(rid)
    for rid in sorted(router.replicas):
        call(router.replicas[rid].run_until_drained)
    harvest()
    for rid in sorted(router.replicas):
        links[rid].post({"kind": "exit", "preempted": False})
    for rid in rec["failed"]:   # unanswered: a rank still up reads it and leaves
        links[rid].post({"kind": "exit", "preempted": False})
    reports = [i for link in links.values() for i in link.done]
    owner = {i: rid for rid, link in links.items() for i in link.done}
    rec.update(stats=dict(router.stats), snapshot=router.snapshot(), p99_ms=router.p99_ms(),
               assigned={str(r.id): owner.get(r.id) for r in requests},
               completions={str(r.id): reports.count(r.id) for r in requests},
               outputs={str(r.id): list(r.output) for r in requests if r.done},
               unserved=[r.id for r in requests if not r.done])
    return rec


def replay(requests: List[Request], actors: Dict[str, Any], routed: Dict[str, Any],
           queue: int, router: Optional[Router] = None) -> Dict[str, Any]:
    """`drive` over local `actors` (replica id -> ReplicaActor), each one's
    ops through a `StoreTransport` on an in-memory store to its own
    `ReplicaServer`, as rank 0 serves r0: the replica exiting from the op,
    lost at the op and stopped at the tick where rank 0's record `routed`
    saw it. `router` (default: a fresh one of `queue` a replica) is the one
    driven. Rank 0's run, replayed in this process."""
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
    router = router if router is not None else Router(max_queue_per_replica=queue)
    for rid in sorted(links):
        router.add_replica(rid, ActorReplicaHandle(links[rid]))
    stopped = routed["stopped"]
    return drive(router, requests, links,
                 stopping=lambda: stopped is not None and router.stats["ticks"] >= stopped)


class LostAt:
    """A replica's server that runs its ops before op `op` and none from
    it on: the replay's replica lost at that op."""

    def __init__(self, server: ReplicaServer, op: int):
        self.server, self.op = server, op

    def step(self):
        if self.server.n + 1 < self.op:
            self.server.step()


def build_engine(args, dev, shape):
    """This rank's `ServeEngine`: `--arch` on a (1, M) view of its row (a
    collective where M > 1: the mesh's groups), the seed's params."""
    mesh = None
    if shape[1] > 1:
        mesh = make_mesh(shape, ("data", "model"), device=dev)
        if shape[0] > 1:
            mesh = row_view(mesh)
    model = build_model(job_config(args), device=dev, mesh=mesh)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    engine = ServeEngine(model, params, batch_slots=args.slots, max_len=args.max_len, device=dev)
    if dev.type == "cuda":   # the draw's fp32 transients go back to the card's other ranks
        torch.cuda.empty_cache()
    return engine


def serve_rank(args, dev, store_path: str, entered: float, joined: float) -> int:
    """One rank of a serving job, in a process group already formed: build,
    serve (rank 0 also routes), print the rank's JSON line; the exit code."""
    signals: list = []
    signal.signal(signal.SIGTERM, lambda *_: signals.append(time.time()))
    shape, axes = mesh_of(args.mesh, args.world)
    if axes != ("data", "model"):
        raise ValueError(f"--serve takes a DxM mesh, not {args.mesh}")
    replicas, width = shape
    rid = f"r{args.rank // width}"
    store = job_store("serve")
    engine = build_engine(args, dev, shape)
    server = ReplicaServer(store, rid, ReplicaActor(engine=engine), lead=args.rank % width == 0,
                           signalled=lambda: bool(signals), timeout=TIMEOUT_S)
    store.set(f"{rid}/ready/{args.rank}", "1")
    built = time.time()
    line = {"rank": args.rank, "world": args.world, "backend": dist.get_backend(),
            "store": store_path, "device": str(dev), "mesh": list(shape), "replica": rid}
    if args.rank == 0:
        for r in range(args.world):   # a replica that never came up fails the job
            if wait_for(store, f"r{r // width}/ready/{r}", args.replica_timeout) is None:
                raise ReplicaLost(f"r{r // width}", 0, args.replica_timeout)
        requests = read_requests(args.requests)
        links = {f"r{d}": StoreTransport(store, f"r{d}", args.replica_timeout,
                                         local=server if d == 0 else None)
                 for d in range(replicas)}
        router = Router(max_queue_per_replica=args.queue)
        for r in sorted(links):
            router.add_replica(r, ActorReplicaHandle(links[r]))
        with open(args.outputs, "w") as out:
            def completed(req, replica, tick):
                out.write(json.dumps({"id": req.id, "replica": replica, "tick": tick,
                                      "output": req.output}) + "\n")
                out.flush()

            rec = drive(router, requests, links, lambda: bool(signals), completed)
        rec.pop("outputs")
        rec["store_ms"] = {r: link.store_ms for r, link in links.items()}
        preempted = bool(signals) or rid in rec["retired"]
        code = EXIT_PREEMPTED if preempted else (1 if rec["unserved"] else 0)
        line.update(role="router", router=rec)
    else:
        exit_op = server.serve()
        code = EXIT_PREEMPTED if signals or exit_op["preempted"] else 0
        line.update(role="lead" if server.lead else "member")
    served = time.time()
    line.update(ticks=len(server.tick_ms), tick_ms=server.tick_ms, engine=dict(engine.stats),
                signalled=bool(signals), exit=code,
                peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
                launches=launches(), entered=entered,
                seconds={"join": joined - entered, "build": built - joined,
                         "serve": served - built})
    print(json.dumps(line), flush=True)
    return code
