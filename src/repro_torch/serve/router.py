"""Serving-plane router: cluster-level continuous batching over replicas,
the port of the JAX package's `serve/router.py`, with the same admission
order, retry buffer, shedding, fault handling and observability.

The engine (`serve/engine.py`) batches at the *slot* level -- B decode
slots over one static KV cache. This router composes a second batching
layer above it: a fleet of long-running replicas, each wrapping an engine,
fed by token-level admission so the cluster-level batcher and the engine's
slot-level batcher stay full together.

Admission (per `submit`):

  1. fill free decode slots first -- a replica with an empty slot starts
     the request on its very next prefill, so those replicas win over any
     amount of queueing elsewhere,
  2. ties (and the no-free-slot case) break by least outstanding tokens:
     the replica that owes the fewest decode steps to already-admitted
     requests finishes soonest,
  3. per-replica queues are bounded (`max_queue_per_replica`); when every
     replica is full the request is *shed to the retry buffer* rather
     than dropped -- `tick()` re-admits it as capacity frees. Only a full
     retry buffer drops (counted in ``stats["shed"]``).

Fault handling:

  * `fail_replica` (abrupt death, e.g. its ranks were lost): every
    in-flight request the replica held is reclaimed, its partial output
    reset, and re-routed to survivors. Outputs stay correct because the
    engine is deterministic per prompt -- a re-decoded request produces
    the same tokens.
  * `retire_replica` (graceful scale-down / drain): admissions stop, the
    replica finishes its in-flight decodes (`run_until_drained`), and
    only then is it removed -- no admitted work is dropped.
  * `Router.recover` (router death): a fresh router adopts the live
    replicas; each quiesces (drains its in-flight work to completion, so
    nothing the dead router admitted is lost) and re-registers empty.

Replica handles are duck-typed: anything with the engine surface
(``add_request`` / ``tick`` / ``pop_completed`` / ``run_until_drained`` /
``free_slots`` / ``queue_len`` / ``outstanding_tokens``) serves -- a
local ``StubEngine``/``ServeEngine``, or `ActorReplicaHandle`, which adapts
the same surface over a payload -> reply call to a `ReplicaActor` hosted
elsewhere: across ranks, `serve/transport.py::StoreTransport` over the
job's store (`launch/serve.py`).

`stats_sink`, called after every tick with a snapshot
(requests/shed/completed/p99_ms/replicas), is how a caller gets the
serving gauges.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.serve.engine import Request, StubEngine
from repro_torch.serve.metrics import MetricsRegistry


class Router:
    """Continuous-batching request router over replica handles."""

    def __init__(self, max_queue_per_replica: int = 8,
                 max_retry_backlog: int = 64,
                 p99_window: int = 512,
                 clock: Optional[Callable[[], float]] = None,
                 stats_sink: Optional[Callable[[Dict[str, float]],
                                               Any]] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.max_queue = max(0, int(max_queue_per_replica))
        self.max_retry = max(0, int(max_retry_backlog))
        self.clock = clock or time.monotonic
        self.stats_sink = stats_sink
        # observability: queue-depth histogram (one observation per
        # tick) and shed-time depth histogram -- the conformance checker
        # holds their counts against stats["ticks"] / stats["shed"]
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.replicas: Dict[str, Any] = {}
        self._draining: set = set()          # no new admissions
        self._inflight: Dict[str, Dict[int, Request]] = {}
        self._submit_t: Dict[int, float] = {}
        self._retry: "collections.deque[Request]" = collections.deque()
        self._latencies: "collections.deque[float]" = collections.deque(
            maxlen=max(1, int(p99_window)))
        self.stats = {"requests": 0, "shed": 0, "completed": 0,
                      "rerouted": 0, "retried": 0, "ticks": 0}

    # -- membership -----------------------------------------------------------

    def add_replica(self, replica_id: str, handle: Any):
        if replica_id in self.replicas:
            raise ValueError(f"replica {replica_id!r} already registered")
        self.replicas[replica_id] = handle
        self._inflight.setdefault(replica_id, {})
        self._draining.discard(replica_id)

    def retire_replica(self, replica_id: str,
                       max_ticks: int = 10000) -> List[Request]:
        """Graceful scale-down of one replica: stop admissions, let it
        finish every in-flight decode, unregister it. Returns the
        requests it completed on the way out -- none are dropped."""
        handle = self.replicas.get(replica_id)
        if handle is None:
            return []
        self._draining.add(replica_id)
        done = list(handle.run_until_drained(max_ticks=max_ticks))
        finished = self._harvest(replica_id, done)
        leftover = self._inflight.pop(replica_id, {})
        del self.replicas[replica_id]
        self._draining.discard(replica_id)
        # anything the engine could not finish inside max_ticks is
        # re-routed like a failure, not silently lost
        self._reroute(leftover.values())
        return finished

    def fail_replica(self, replica_id: str) -> int:
        """Abrupt replica death: reclaim every request it held (queued or
        mid-decode), reset partial outputs, re-route to survivors (or the
        retry buffer). Returns the number of requests re-routed."""
        self.replicas.pop(replica_id, None)
        self._draining.discard(replica_id)
        lost = self._inflight.pop(replica_id, {})
        n = len(lost)
        self.stats["rerouted"] += n
        self._reroute(lost.values())
        return n

    @classmethod
    def recover(cls, replicas: Dict[str, Any],
                **kwargs) -> "tuple[Router, List[Request]]":
        """Router-death recovery: a fresh router adopts live replicas.
        Each quiesces -- drains its in-flight work to completion (those
        completions are returned, not lost) -- and re-registers empty."""
        router = cls(**kwargs)
        recovered: List[Request] = []
        for rid in sorted(replicas):
            handle = replicas[rid]
            for req in handle.run_until_drained():
                req.done = True
                recovered.append(req)
            router.add_replica(rid, handle)
        return router, recovered

    # -- admission ------------------------------------------------------------

    def _candidates(self) -> List[str]:
        return [rid for rid in self.replicas if rid not in self._draining]

    def _place(self, req: Request) -> Optional[str]:
        """Token-level admission: free decode slots first, then bounded
        queues; least-outstanding-tokens tiebreak (replica id breaks the
        remaining ties deterministically)."""
        cands = self._candidates()
        free = [r for r in cands if self.replicas[r].free_slots > 0]
        pool = free or [r for r in cands
                        if self.replicas[r].queue_len < self.max_queue]
        if not pool:
            return None
        rid = min(pool, key=lambda r: (self.replicas[r].outstanding_tokens,
                                       r))
        self.replicas[rid].add_request(req)
        self._inflight[rid][req.id] = req
        self._submit_t.setdefault(req.id, self.clock())
        return rid

    def submit(self, req: Request) -> bool:
        """Admit one request. True = accepted (placed now, or parked in
        the retry buffer); False = shed (every replica AND the retry
        buffer are full -- the caller may retry later)."""
        self._submit_t[req.id] = self.clock()
        if self._place(req) is not None:
            self.stats["requests"] += 1
            return True
        if len(self._retry) < self.max_retry:
            self._retry.append(req)
            self.stats["requests"] += 1
            return True
        self._submit_t.pop(req.id, None)
        self.stats["shed"] += 1
        self.metrics.histogram("syndeo_router_shed_depth").observe(
            self.queue_depth())
        return False

    def _reroute(self, reqs) -> None:
        for req in reqs:
            req.output = []
            req.done = False
            if self._place(req) is None:
                self._retry.append(req)   # unbounded here: reclaimed work
                                          # is never shed a second time

    # -- the serving tick -----------------------------------------------------

    def _harvest(self, rid: str, done) -> List[Request]:
        """Fold a replica's completions back into the requests this
        router tracks (remote handles may return rebuilt twins)."""
        out: List[Request] = []
        inflight = self._inflight.get(rid, {})
        now = self.clock()
        for r in done:
            orig = inflight.pop(r.id, None)
            if orig is not None and orig is not r:
                orig.output = list(r.output)
            req = orig or r
            req.done = True
            t0 = self._submit_t.pop(req.id, None)
            if t0 is not None:
                self._latencies.append(now - t0)
            self.stats["completed"] += 1
            out.append(req)
        return out

    def tick(self) -> List[Request]:
        """One router iteration: re-admit the retry buffer into freed
        capacity, tick every replica one decode step, harvest
        completions. Returns the requests that finished this tick."""
        for _ in range(len(self._retry)):
            req = self._retry.popleft()
            if self._place(req) is None:
                self._retry.append(req)
                break
            self.stats["retried"] += 1
        finished: List[Request] = []
        for rid in sorted(self.replicas):
            handle = self.replicas[rid]
            handle.tick()
            finished.extend(self._harvest(rid, handle.pop_completed()))
        self.stats["ticks"] += 1
        self.metrics.histogram("syndeo_router_queue_depth").observe(
            self.queue_depth())
        if self.stats_sink is not None:
            self.stats_sink(self.snapshot())
        return finished

    def flush(self, max_ticks: int = 100000) -> List[Request]:
        """Tick until nothing is in flight anywhere (or the tick budget
        runs out); returns everything completed along the way."""
        out: List[Request] = []
        for _ in range(max_ticks):
            if self.idle():
                break
            out.extend(self.tick())
        return out

    def idle(self) -> bool:
        return (not self._retry
                and not any(self._inflight.get(r) for r in self.replicas))

    # -- observability --------------------------------------------------------

    def inflight_count(self) -> int:
        return (len(self._retry)
                + sum(len(m) for m in self._inflight.values()))

    def p99_ms(self) -> float:
        """p99 end-to-end latency over the sliding completion window."""
        if not self._latencies:
            return 0.0
        window = sorted(self._latencies)
        idx = min(len(window) - 1, int(0.99 * len(window)))
        return window[idx] * 1000.0

    def queue_depth(self) -> float:
        """Mean per-replica backlog (queued + retry share) -- the SLO
        autoscaler's second signal."""
        n = max(1, len(self.replicas))
        queued = sum(h.queue_len for h in self.replicas.values())
        return (queued + len(self._retry)) / n

    def snapshot(self) -> Dict[str, float]:
        return {"requests": self.stats["requests"],
                "shed": self.stats["shed"],
                "completed": self.stats["completed"],
                "p99_ms": self.p99_ms(),
                "replicas": len(self.replicas)}


class ReplicaActor:
    """Service actor wrapping an engine, hosted by the ranks of a replica
    (`serve/transport.py::ReplicaServer`). One `handle(payload)` call per
    routed op:

      {"kind": "submit", "id", "prompt", "max_new_tokens", "eos_id"}
          -> {"accepted": True}
      {"kind": "tick"}   -> {"active": n, "done": [[id, output], ...],
                             "stats": {free_slots, queue_len,
                                       outstanding_tokens}}
      {"kind": "stats"}  -> the same stats dict
      {"kind": "drain"}  -> {"done": [[id, output], ...]} (run to empty)

    `drain()` finishes every in-flight decode before its host exits."""

    def __init__(self, batch_slots: int = 4, engine: Any = None,
                 weights_version: Optional[str] = None):
        self.engine = engine or StubEngine(batch_slots)
        self.weights_version = weights_version

    def _stats(self) -> Dict[str, int]:
        return {"free_slots": self.engine.free_slots,
                "queue_len": self.engine.queue_len,
                "outstanding_tokens": self.engine.outstanding_tokens}

    def handle(self, payload: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        kind = (payload or {}).get("kind")
        if kind == "submit":
            self.engine.add_request(Request(
                id=int(payload["id"]),
                prompt=[int(t) for t in payload.get("prompt") or []],
                max_new_tokens=int(payload.get("max_new_tokens", 16)),
                eos_id=int(payload.get("eos_id", -1))))
            return {"accepted": True}
        if kind == "tick":
            n = self.engine.tick()
            done = self.engine.pop_completed()
            return {"active": n,
                    "done": [[r.id, list(r.output)] for r in done],
                    "stats": self._stats()}
        if kind == "stats":
            return self._stats()
        if kind == "drain":
            done = self.engine.run_until_drained()
            return {"done": [[r.id, list(r.output)] for r in done]}
        raise ValueError(f"unknown replica op {kind!r}")

    def drain(self):
        self.engine.run_until_drained()


class ActorReplicaHandle:
    """Engine-surface adapter over a remote `ReplicaActor`: `call` is any
    synchronous payload -> value transport (`serve/transport.py::
    StoreTransport` across ranks, or `ReplicaActor.handle` in process).
    Slot/queue stats are the remote's own, refreshed on every tick, with
    local adjustments between ticks so back-to-back admissions in one
    router pass don't all pick the same replica on stale numbers."""

    def __init__(self, call: Callable[[Dict[str, Any]], Dict[str, Any]]):
        self._call = call
        self._stats = {"free_slots": 0, "queue_len": 0,
                       "outstanding_tokens": 0}
        self._completed: List[Request] = []
        self.refresh()

    def refresh(self):
        self._stats = dict(self._call({"kind": "stats"}))

    @property
    def free_slots(self) -> int:
        return int(self._stats.get("free_slots", 0))

    @property
    def queue_len(self) -> int:
        return int(self._stats.get("queue_len", 0))

    @property
    def outstanding_tokens(self) -> int:
        return int(self._stats.get("outstanding_tokens", 0))

    def add_request(self, req: Request):
        self._call({"kind": "submit", "id": req.id, "prompt": req.prompt,
                    "max_new_tokens": req.max_new_tokens,
                    "eos_id": req.eos_id})
        self._stats["free_slots"] = max(0, self.free_slots - 1)
        self._stats["queue_len"] = self.queue_len + 1
        self._stats["outstanding_tokens"] = (self.outstanding_tokens
                                             + req.max_new_tokens)

    def _rebuild(self, done) -> List[Request]:
        return [Request(id=int(rid), prompt=[], output=list(out), done=True)
                for rid, out in done or []]

    def tick(self) -> int:
        got = self._call({"kind": "tick"})
        self._stats = dict(got.get("stats") or self._stats)
        self._completed.extend(self._rebuild(got.get("done")))
        return int(got.get("active", 0))

    def pop_completed(self) -> List[Request]:
        out, self._completed = self._completed, []
        return out

    def run_until_drained(self, max_ticks: int = 10000) -> List[Request]:
        got = self._call({"kind": "drain"})
        out = self.pop_completed() + self._rebuild(got.get("done"))
        self.refresh()
        return out
