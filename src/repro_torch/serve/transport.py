"""The call between rank 0's router and the ranks of each replica, over the
job's own store.

A serving job (`launch/serve.py`) runs D replicas of M ranks each; rank 0
routes. `ActorReplicaHandle` (`serve/router.py`) takes a synchronous
payload -> reply `call`; across ranks that call is a `StoreTransport`, and
each rank of a replica runs a `ReplicaServer` over its `ReplicaActor`. Both
sides speak through the `FileStore` the ranks formed their group at
(`distributed.init_rank`, `distributed.job_store`), under these keys:

    <replica>/op/<n>      rank 0's n-th op for the replica (JSON), n from 1
    <replica>/reply/<n>   the replica's lead rank's reply to op n (JSON)
    <replica>/exiting     set by a rank of the replica that took SIGTERM
    <replica>/ready/<r>   set by rank r once its engine is built

Every rank of a replica reads every op in order and runs it on its actor,
so the M ranks of a tensor-parallel replica run one request stream, in
lockstep through their own collectives; the lead rank (the first of the
replica's row) writes the reply. Every replica gets its ops so, rank 0's
own included: rank 0 leads r0 from a thread that polls the store as the
other leads do.

No collective spans replicas once the job has started, so a lost replica
cannot hang rank 0: a reply that does not come within `timeout` seconds
marks the replica lost at that op, and nothing retries it. A lost
replica's `tick` and `drain` raise `ReplicaLost`, which the router's loop
turns into `fail_replica`; its `submit` and `stats` answer at once, as if
taken, and post nothing. So a request handed to a lost replica is on the
router's books for it (`Router._inflight`) and `fail_replica` re-routes
it, whether the op that timed out was a submit of the retry buffer's
re-admission or of a re-route. Rank 0's own replica r0 is reached the same
way: its server runs on a thread of rank 0's own (`launch/serve.py`), so
a member of r0 that dies leaves only that thread in a collective, and
rank 0's router loses r0 after `timeout` as it loses any other replica.
An op the replica's actor raised on comes back as `ReplicaFailed` with the
replica's traceback, and the replica's ranks raise too, save where a
collective raised that a rank of its group is gone (`peer_lost`): that op
gets no reply, so the replica goes silent and is lost. A rank
that took SIGTERM marks its replica exiting; the lead's next reply carries
that (`StoreTransport.exiting`), and rank 0 retires the replica.
"""
from __future__ import annotations

import json
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

# longest pause between two looks at the store while waiting for a key
POLL_MAX_S = 1e-3
# what a lost replica answers to the ops that do not raise: a submit taken,
# no capacity reported
LOST_REPLIES = {"submit": {"accepted": True},
                "stats": {"free_slots": 0, "queue_len": 0, "outstanding_tokens": 0}}


class ReplicaLost(RuntimeError):
    """A replica's reply did not come in time: its ranks are gone or hung."""

    def __init__(self, replica: str, op: int, waited_s: float):
        super().__init__(f"replica {replica!r} did not answer op {op} within {waited_s:.1f} s")
        self.replica, self.op = replica, op


class ReplicaFailed(RuntimeError):
    """A replica's actor raised on an op; the message carries its traceback."""


def wait_for(store, key: str, timeout: float) -> Optional[bytes]:
    """The value of `key` once it is set, or None after `timeout` seconds.
    Polls (`check`, pauses up to POLL_MAX_S) rather than blocking in the
    store, so a signal's handler runs while the caller waits."""
    deadline = time.monotonic() + timeout
    pause = 1e-4
    while not store.check([key]):
        if time.monotonic() > deadline:
            return None
        time.sleep(pause)
        pause = min(2 * pause, POLL_MAX_S)
    return store.get(key)


# what a collective raises when a rank of its group is gone: gloo's tcp
# transport, NCCL's remote error
PEER_LOST = ("Connection closed by peer", "Connection reset by peer", "Broken pipe",
             "remote process exited")


def peer_lost(exc: BaseException) -> bool:
    """Whether `exc` is a collective's report that a rank of its group is
    gone: one of PEER_LOST in its message, raised with a frame of
    `torch.distributed` or of `repro_torch.distributed` on its traceback.
    Any other error, a collective's too, is the replica's own fault."""
    if not any(m in str(exc) for m in PEER_LOST):
        return False
    tb = exc.__traceback__
    while tb is not None:
        name = tb.tb_frame.f_globals.get("__name__", "")
        if name == "repro_torch.distributed" or name.startswith("torch.distributed"):
            return True
        tb = tb.tb_next
    return False


def _done_ids(value) -> List[int]:
    """The request ids a reply reports finished (tick and drain replies)."""
    if not isinstance(value, dict):
        return []
    return [int(i) for i, _ in value.get("done") or []]


class ReplicaServer:
    """One rank's side of a replica: runs rank 0's ops, in order, on
    `actor`. The lead rank writes the replies. `signalled()` says whether
    this rank took SIGTERM; the first op after it marks the replica
    exiting. `timeout` bounds the wait for the next op."""

    def __init__(self, store, replica: str, actor, *, lead: bool,
                 signalled: Callable[[], bool], timeout: float):
        self.store, self.replica, self.actor = store, replica, actor
        self.lead, self.signalled, self.timeout = lead, signalled, timeout
        self.n = 0
        self.announced = self.exiting = False
        self.tick_ms: List[float] = []   # each tick op's time on the actor

    def step(self) -> Dict[str, Any]:
        """Wait for the next op, run it (an exit op is only read), reply if
        lead; returns the op."""
        self.n += 1
        raw = wait_for(self.store, f"{self.replica}/op/{self.n}", self.timeout)
        if raw is None:
            raise TimeoutError(f"replica {self.replica}: no op {self.n} from rank 0 within "
                               f"{self.timeout:.0f} s")
        op = json.loads(raw)
        t = time.perf_counter()
        try:
            value = None if op["kind"] == "exit" else self.actor.handle(op)
        except BaseException as e:
            if self.lead and not peer_lost(e):   # a member gone: the replica goes silent
                self._reply({"error": traceback.format_exc()})
            raise
        ms = (time.perf_counter() - t) * 1e3
        if op["kind"] == "tick":
            self.tick_ms.append(ms)
        if self.signalled() and not self.announced:
            self.store.set(f"{self.replica}/exiting", "1")
            self.announced = True
        if self.lead:
            self.exiting = (self.exiting or self.announced
                            or self.store.check([f"{self.replica}/exiting"]))
            self._reply({"value": value, "exiting": self.exiting, "ms": ms})
        return op

    def _reply(self, reply):
        self.store.set(f"{self.replica}/reply/{self.n}", json.dumps(reply))

    def serve(self) -> Dict[str, Any]:
        """Run ops until the exit op; returns it."""
        while True:
            op = self.step()
            if op["kind"] == "exit":
                return op


class StoreTransport:
    """Rank 0's side of a replica: `call(payload)` writes op n and waits up
    to `timeout` s for the lead's reply. `local` is a server run in this
    thread on each op, as `launch/serve.py::replay` runs its replicas (in a
    job, rank 0's own replica has a thread of its own). Records the ids
    each reply reports finished (`done`), the op whose reply first said the
    replica is exiting (`exiting_at`), the op that got no reply (`lost_at`:
    from it on no op is written, a tick or drain raises `ReplicaLost` and a
    submit or stats gets its `LOST_REPLIES` answer), and each op's round
    trip less the actor's time (`store_ms`)."""

    def __init__(self, store, replica: str, timeout: float, local=None):
        self.store, self.replica, self.timeout, self.local = store, replica, timeout, local
        self.ops = 0
        self.exiting_at: Optional[int] = None
        self.lost_at: Optional[int] = None
        self.done: List[int] = []
        self.store_ms: List[float] = []

    @property
    def exiting(self) -> bool:
        return self.exiting_at is not None

    def post(self, payload: Dict[str, Any]):
        """Write the next op and wait for no reply (the exit op)."""
        self.ops += 1
        self.store.set(f"{self.replica}/op/{self.ops}", json.dumps(payload))
        if self.local is not None:
            self.local.step()

    def __call__(self, payload: Dict[str, Any]):
        if self.lost_at is None:
            t = time.perf_counter()
            self.post(payload)
            raw = wait_for(self.store, f"{self.replica}/reply/{self.ops}", self.timeout)
            if raw is None:
                self.lost_at = self.ops
        if self.lost_at is not None:
            if payload["kind"] in LOST_REPLIES:
                return dict(LOST_REPLIES[payload["kind"]])
            raise ReplicaLost(self.replica, self.lost_at, self.timeout)
        reply = json.loads(raw)
        if "error" in reply:
            raise ReplicaFailed(f"replica {self.replica!r} failed op {self.ops} "
                                f"({payload['kind']}):\n{reply['error']}")
        self.store_ms.append((time.perf_counter() - t) * 1e3 - reply["ms"])
        if reply["exiting"] and self.exiting_at is None:
            self.exiting_at = self.ops
        self.done += _done_ids(reply["value"])
        return reply["value"]
