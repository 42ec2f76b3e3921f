"""The serving ranks of the port on the CPU: `python -m repro_torch.launch.rank
--serve` (src/repro_torch/launch/serve.py) as a process a rank, the port's
Router on rank 0 and each replica's ops over the job's store
(src/repro_torch/serve/transport.py).

Every case runs llama3-8b SMOKE in fp32 on 16 requests of 32 new tokens,
and is held to rank 0's run replayed in one process over local engines on
the same params (`launch/serve.py::replay`): the same tokens, the same
replica for every request and the same router stats. Cases: meshes 2x1,
1x2 (one tensor-parallel replica) and 2x2 (two, each a row view); SIGTERM
to rank 1 once replica r1 has finished a request (its replica retired,
rank 1 exiting 75); SIGKILL of rank 1 then (rank 0 hits `ReplicaLost`
after its `--replica-timeout`, fails the replica and re-routes its
requests, and is not hung); SIGTERM to rank 0 then (every replica retired
at once, every rank exiting 75, what was not yet admitted left unserved);
a 2x1 job started through Slurm's rendered `rank_<id>.sh`; a 3x1 job whose
requests arrive over time and whose rows the autoscaler grows and shrinks
on queue depth (`--autoscale`), replayed with its offer ticks and scaling
decisions; and SIGKILL of rank 1 of a 2x2 job, a member of rank 0's own
replica r0, once r0 has finished a request (rank 0's thread for r0 is left
in a broken collective, its router loses r0 after its timeout). All cases
run at once in the module's one subprocess (`_torch_subproc.run`: one
thread a rank); this module imports no JAX. The transport's own cases run
in process, over one in-memory store, and so do `drive`'s with a replica
lost at a submit: of the retry buffer's re-admission, and of a re-route;
and rank 0's thread for r0 (`ServerThread`), answering through the store.
"""
import threading

import pytest
import torch.distributed as dist

import _torch_subproc as subproc
import _torch_serve_ranks as S
import torch
from repro_torch.launch.serve import ServerThread, read_requests, replay
from repro_torch.serve.engine import Request
from repro_torch.serve.router import ReplicaActor, Router
from repro_torch.serve.transport import (ReplicaFailed, ReplicaLost, ReplicaServer,
                                         StoreTransport, peer_lost)

STATS = ("requests", "completed", "rerouted", "retried", "shed", "ticks")
CODES = {"sigterm": [0, 75], "sigkill": [0, -9], "sigterm0": [75, 75], "r0member": [0, -9, 0, 0]}
KILLED = ("sigkill", "r0member")


@pytest.fixture(scope="module")
def cases():
    return subproc.run("""
        import json
        import _torch_serve_ranks as S
        print(json.dumps(S.run_cases()))
    """)


def _routed(case):
    line = case["ranks"][0]["line"]
    assert line is not None, case["ranks"][0]["stderr"]
    return line["router"]


@pytest.mark.parametrize("name", list(S.CASES))
def test_ranks_serve_as_the_replay(cases, name):
    """Tokens, the replica each request went to, and the router's stats are
    those of rank 0's run replayed in one process; every request finished
    once (but those a SIGTERM to rank 0 left unadmitted), and its outputs
    line names the replica that finished it."""
    case, routed = cases[name], _routed(cases[name])
    again = case["replay"]
    got = {str(o["id"]): o["output"] for o in case["outputs"]}
    assert routed["unserved"] == again["unserved"]
    if name != "sigterm0":
        assert routed["unserved"] == []
    assert len(case["outputs"]) == len(got) == S.N_REQUESTS - len(routed["unserved"])
    assert got == again["outputs"]
    assert all(len(out) == S.NEW_TOKENS for out in got.values())
    assigned = {str(o["id"]): o["replica"] for o in case["outputs"]}
    served = {k: v for k, v in routed["assigned"].items() if v is not None}
    assert assigned == served and routed["assigned"] == again["assigned"]
    assert {k: routed["stats"][k] for k in STATS} == {k: again["stats"][k] for k in STATS}
    assert routed["stats"]["completed"] == len(got)
    assert routed["completions"] == again["completions"]
    assert {routed["completions"][k] for k in got} == {1}


@pytest.mark.parametrize("name", list(S.CASES))
def test_exit_codes(cases, name):
    """Rank 0 exits 0; a retired replica's rank exits 75 and a killed one
    -9; every rank that printed its line printed its exit code."""
    ranks = cases[name]["ranks"]
    assert [r["code"] for r in ranks] == CODES.get(name, [0] * len(ranks)), \
        [r["stderr"] for r in ranks]
    for r in ranks:
        if r["line"] is not None:
            assert r["line"]["exit"] == r["code"]


@pytest.mark.parametrize("name", list(S.CASES))
def test_each_rank_serves_its_row(cases, name):
    """Replica d is the row d of the mesh: its ranks ran one request stream
    in lockstep (equal engine stats and tick counts), over gloo on the CPU,
    each after its engine's warm-up request (one prefill, one decode step)."""
    mesh = S.CASES[name][0]
    d, m = (int(n) for n in mesh.split("x"))
    lines = [r["line"] for r in cases[name]["ranks"] if r["line"] is not None]
    for line in lines:
        assert (line["backend"], line["device"], line["mesh"]) == ("gloo", "cpu", [d, m])
        assert line["replica"] == f"r{line['rank'] // m}"
        want = "router" if line["rank"] == 0 else ("lead" if line["rank"] % m == 0 else "member")
        assert line["role"] == want
        assert line["warmup"] == {"prefills": 1, "ticks": 1}
    for row in range(d):   # a killed rank printed no line
        mates = [x for x in lines if x["replica"] == f"r{row}"]
        assert len({(x["ticks"], tuple(sorted(x["engine"].items()))) for x in mates}) <= 1
    assert len(lines) == len(cases[name]["ranks"]) - (name in KILLED)


def test_sigterm_retires_the_replica_and_loses_nothing(cases):
    """SIGTERM to rank 1: its next reply says its replica is exiting, rank 0
    retires r1 (it finishes what it holds) at a recorded tick, and r0
    serves the rest; nothing is re-routed or lost."""
    case = cases["sigterm"]
    routed, rank1 = _routed(case), case["ranks"][1]["line"]
    assert case["signalled_at"] and rank1["signalled"]
    assert list(routed["retired"]) == ["r1"] and routed["failed"] == {}
    at = routed["retired"]["r1"]
    assert 0 < at["tick"] < routed["stats"]["ticks"] and at["op"] > 1
    assert routed["stats"]["rerouted"] == 0
    r1_ticks = [o["tick"] for o in case["outputs"] if o["replica"] == "r1"]
    assert r1_ticks and max(r1_ticks) <= at["tick"]
    assert max(o["tick"] for o in case["outputs"] if o["replica"] == "r0") > at["tick"]


def test_sigkill_fails_the_replica_and_reroutes_its_requests(cases):
    """SIGKILL of rank 1: rank 0's next call to r1 times out
    (`ReplicaLost`), r1 is failed and the requests it held are re-routed to
    r0 and finish; rank 0 ends within its timeout, not hung on the dead
    rank."""
    case = cases["sigkill"]
    routed = _routed(case)
    assert case["signalled_at"] and list(routed["failed"]) == ["r1"]
    assert routed["retired"] == {} and routed["stats"]["rerouted"] > 0
    lost_at = routed["failed"]["r1"]["tick"]
    late = [o for o in case["outputs"] if o["tick"] > lost_at]
    assert late and all(o["replica"] == "r0" for o in late)
    assert case["ranks"][0]["seconds"] - case["signalled_at"][0] < S.KILL_TIMEOUT + 60


def test_sigterm_to_rank_0_retires_every_replica(cases):
    """SIGTERM to rank 0: the router stops at a recorded tick and retires
    every replica (each finishes what it holds); every rank exits 75."""
    case = cases["sigterm0"]
    routed = _routed(case)
    assert case["signalled_at"] and case["ranks"][0]["line"]["signalled"]
    assert routed["stopped"] is not None and sorted(routed["retired"]) == ["r0", "r1"]
    assert all(r["tick"] == routed["stopped"] for r in routed["retired"].values())
    assert routed["failed"] == {} and routed["stats"]["rerouted"] == 0
    assert max(o["tick"] for o in case["outputs"]) <= routed["stopped"]


def test_a_dead_member_of_rank_0s_replica_is_lost_in_time(cases):
    """SIGKILL of rank 1, a member of r0, which rank 0 leads from a thread:
    that thread stops in r0's broken collective and sends no reply, rank 0's
    router loses r0 after its `--replica-timeout` as it loses any replica,
    re-routes r0's requests to r1, where they finish; rank 0 exits 0 within
    the timeout and 30 s of the kill, and every other rank exits by itself."""
    case = cases["r0member"]
    routed, line = _routed(case), case["ranks"][0]["line"]
    assert case["signalled_at"] and list(routed["failed"]) == ["r0"]
    assert routed["retired"] == {} and routed["stats"]["rerouted"] > 0
    assert line["server_error"] and routed["unserved"] == []
    lost_at = routed["failed"]["r0"]["tick"]
    late = [o for o in case["outputs"] if o["tick"] > lost_at]
    assert late and all(o["replica"] == "r1" for o in late)
    assert case["ranks"][0]["seconds"] - case["signalled_at"][0] < S.KILL_TIMEOUT + 30


def test_autoscaled_rows_grow_under_arrivals_and_shrink(cases):
    """`--autoscale` on 3x1: the router starts on r0, grows parked rows
    while the first requests arrive and retires them through their drain
    (what a drain finished, the retired row finished) once the queues are
    short; each request was offered once, at its arrival."""
    routed = _routed(cases["autoscale"])
    assert routed["initial"] == ["r0"]
    actions = [e["action"] for e in routed["scaling"]]
    assert "scale_up" in actions and "scale_down" in actions
    assert max(n for _, _, n in routed["rows"]) >= 2
    for e in routed["scaling"]:
        assert e["count"] == len(e["ids"]) >= 1
        for rid, ids in (e.get("drained") or {}).items():
            assert all(routed["assigned"][str(i)] == rid for i in ids)
    assert sorted(routed["submitted"], key=int) == [str(i) for i in range(S.N_REQUESTS)]
    for i, (arrival, offered, done) in routed["times"].items():
        assert arrival == S.ARRIVALS[int(i)] and arrival <= offered <= done


def test_the_rendered_slurm_rank_script_serves(cases):
    """Slurm's `rank_<id>.sh` forwards the serving arguments: its ranks met
    at the store named by cluster, job, step and restart."""
    for r in cases["slurm"]["ranks"]:
        assert r["line"]["store"].endswith("/rdv/torch/slurm-32.0.0")
        assert r["line"]["world"] == 2


def test_rank_0_reports_the_store_round_trips(cases):
    """Rank 0's line has each replica's round trips less the actor's time,
    one an op, every one of them non-negative."""
    routed = _routed(cases["2x1"])
    assert set(routed["store_ms"]) == {"r0", "r1"}
    assert all(ms and min(ms) >= 0 for ms in routed["store_ms"].values())


# ------------------------------------------------ the transport, in process over one store


def _pair(store, actor, *, timeout=5.0, signalled=lambda: False):
    """A replica's server in a thread and rank 0's transport to it."""
    server = ReplicaServer(store, "r1", actor, lead=True, signalled=signalled, timeout=timeout)
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    return server, thread, StoreTransport(store, "r1", timeout=timeout)


def test_store_transport_replies_as_the_actor():
    """Ops through the store get the replies the actor gives the same ops
    directly; the exit op ends the server; the round trips are recorded."""
    store = dist.PrefixStore("serve", dist.HashStore())
    server, thread, link = _pair(store, ReplicaActor(batch_slots=2))
    direct = ReplicaActor(batch_slots=2)
    ops = [{"kind": "stats"}, {"kind": "submit", "id": 3, "prompt": [5, 6], "max_new_tokens": 3},
           {"kind": "submit", "id": 4, "prompt": [1], "max_new_tokens": 1}, {"kind": "tick"},
           {"kind": "tick"}, {"kind": "drain"}, {"kind": "stats"}]
    for op in ops:
        assert link(dict(op)) == direct.handle(dict(op))
    link.post({"kind": "exit", "preempted": False})
    thread.join(5)
    assert not thread.is_alive() and server.n == len(ops) + 1
    assert sorted(link.done) == [3, 4] and len(link.store_ms) == len(ops)
    assert len(server.tick_ms) == 2 and not link.exiting


def test_a_silent_replica_is_lost_at_its_op():
    """No reply within the timeout raises ReplicaLost naming the replica
    and the op; nothing retries it."""
    link = StoreTransport(dist.PrefixStore("serve", dist.HashStore()), "r1", timeout=0.2)
    with pytest.raises(ReplicaLost, match="'r1' did not answer op 1") as e:
        link({"kind": "tick"})
    assert (e.value.replica, e.value.op, link.ops) == ("r1", 1, 1)


def test_an_actor_error_comes_back_with_its_traceback():
    """An op the actor raises on fails rank 0's call with the replica's
    traceback (ReplicaFailed), and the replica's rank raises too."""
    store = dist.PrefixStore("serve", dist.HashStore())
    failed = []

    def serve():
        try:
            server.serve()
        except ValueError as e:
            failed.append(e)

    server = ReplicaServer(store, "r1", ReplicaActor(batch_slots=1), lead=True,
                           signalled=lambda: False, timeout=5.0)
    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    link = StoreTransport(store, "r1", timeout=5.0)
    with pytest.raises(ReplicaFailed, match="unknown replica op 'nope'"):
        link({"kind": "nope"})
    thread.join(5)
    assert len(failed) == 1


def test_the_next_reply_after_sigterm_says_exiting():
    """A rank that took SIGTERM marks its replica exiting; the lead's next
    reply carries it, and the transport keeps the op it first saw it at.
    A member rank's mark reaches the lead through the store."""
    store = dist.PrefixStore("serve", dist.HashStore())
    flag = []
    server, thread, link = _pair(store, ReplicaActor(batch_slots=1),
                                 signalled=lambda: bool(flag))
    link({"kind": "stats"})
    flag.append(1)
    link({"kind": "stats"})
    link({"kind": "stats"})
    assert link.exiting_at == 2
    link.post({"kind": "exit", "preempted": True})
    thread.join(5)
    store2 = dist.PrefixStore("serve", dist.HashStore())
    member = ReplicaServer(store2, "r1", ReplicaActor(batch_slots=1), lead=False,
                           signalled=lambda: True, timeout=5.0)
    lead, thread, link = _pair(store2, ReplicaActor(batch_slots=1))
    link.post({"kind": "stats"})   # the lead may answer before the member reads
    member.step()
    link({"kind": "stats"})
    assert link.exiting_at == 2 and member.announced and lead.exiting
    link.post({"kind": "exit", "preempted": True})
    thread.join(5)


def test_a_lost_replica_takes_submits_and_raises_at_its_tick():
    """A submit that gets no reply is taken (so the router books the
    request to the replica), as is every later submit or stats, with no op
    written; the replica's next tick or drain raises ReplicaLost at the op
    that timed out. The exit op is still written, for a rank still up."""
    store = dist.PrefixStore("serve", dist.HashStore())
    link = StoreTransport(store, "r1", timeout=0.05)
    submit = {"kind": "submit", "id": 7, "prompt": [2], "max_new_tokens": 1}
    assert link(dict(submit)) == {"accepted": True} and link.lost_at == 1
    assert link({"kind": "stats"}) == {"free_slots": 0, "queue_len": 0, "outstanding_tokens": 0}
    assert link(dict(submit, id=8)) == {"accepted": True} and link.ops == 1
    for kind in ("tick", "drain"):
        with pytest.raises(ReplicaLost, match="'r1' did not answer op 1"):
            link({"kind": kind})
    link.post({"kind": "exit", "preempted": False})
    assert link.ops == 2 and store.check(["r1/op/2"]) and not store.check(["r1/reply/1"])


class _Logged(ReplicaActor):
    """A StubEngine replica that keeps the kind of every op it runs."""

    def __init__(self):
        super().__init__(batch_slots=1)
        self.kinds = []

    def handle(self, payload):
        self.kinds.append(payload["kind"])
        return super().handle(payload)


class _Traced(Router):
    """A router that keeps, for each placement, where it happened (a
    submit, the retry buffer's re-admission in a tick, a re-route), the
    replica and the op number of its submit."""

    phase = "submit"

    def __init__(self):
        super().__init__(max_queue_per_replica=1)
        self.placed = []

    def tick(self):
        self.phase = "retry"   # a tick places only from the retry buffer
        try:
            return super().tick()
        finally:
            self.phase = "submit"

    def _reroute(self, reqs):
        phase, self.phase = self.phase, "reroute"
        try:
            super()._reroute(reqs)
        finally:
            self.phase = phase

    def _place(self, req):
        rid = super()._place(req)
        if rid is not None:
            self.placed.append((self.phase, rid, self.replicas[rid]._call.ops))
        return rid


def _drive_lost(failed):
    """12 requests over three one-slot StubEngine replicas, queue 1, the
    replicas in `failed` lost at their ops: (record, router, actors)."""
    reqs = [Request(id=i, prompt=[i + 1, 2 * i + 3], max_new_tokens=2 + i % 4)
            for i in range(12)]
    actors = {f"r{d}": _Logged() for d in range(3)}
    router = _Traced()
    rec = replay(reqs, actors, {"retired": {}, "failed": failed, "stopped": None}, 1, router)
    return rec, router, actors


@pytest.mark.parametrize("where", ["retry", "reroute"])
def test_a_replica_lost_at_a_submit_loses_no_request(where):
    """A replica lost at the op of a submit, made in the retry buffer's
    re-admission or in the re-route of another lost replica's requests: the
    request is booked to it, re-routed when its tick raises, and every
    request finishes once with the tokens of the run that lost nothing."""
    clean, router, actors = _drive_lost({})
    failed = {}
    if where == "reroute":   # r1 lost at its first tick; a survivor at its re-routed submit
        failed["r1"] = {"op": actors["r1"].kinds.index("tick") + 1}
        _, router, _ = _drive_lost(failed)
    at = [(rid, op) for phase, rid, op in router.placed if phase == where and rid not in failed]
    assert at, router.placed
    rid, op = at[0]
    failed[rid] = {"op": op}
    rec, router, _ = _drive_lost(failed)
    assert {r: f["op"] for r, f in rec["failed"].items()} == {r: f["op"] for r, f in failed.items()}
    assert rec["unserved"] == [] and rec["outputs"] == clean["outputs"]
    assert set(rec["completions"].values()) == {1} and rec["stats"]["rerouted"] > 0
    assert sorted(router.replicas) == sorted({"r0", "r1", "r2"} - set(failed))


def test_rank_0s_thread_answers_through_the_store():
    """Rank 0's own replica served from a thread (`ServerThread`): the
    router's transport to it writes ops and reads replies as it does for
    any replica, and the thread ends at the exit op."""
    store = dist.PrefixStore("serve", dist.HashStore())
    server = ReplicaServer(store, "r0", ReplicaActor(batch_slots=2), lead=True,
                           signalled=lambda: False, timeout=5.0)
    thread = ServerThread(server, torch.device("cpu"))
    thread.start()
    link = StoreTransport(store, "r0", timeout=5.0)
    direct = ReplicaActor(batch_slots=2)
    for op in ({"kind": "submit", "id": 1, "prompt": [4, 5], "max_new_tokens": 2},
               {"kind": "tick"}, {"kind": "tick"}, {"kind": "stats"}):
        assert link(dict(op)) == direct.handle(dict(op))
    link.post({"kind": "exit", "preempted": False})
    thread.join(5)
    assert not thread.is_alive() and thread.error is None and thread.exit_op["kind"] == "exit"
    assert link.done == [1] and server.tick_ms and len(link.store_ms) == 4


def _collective(message):
    """A collective that raises `message`: a function of a module named as
    torch.distributed's, so its frame is on the error's traceback as a real
    collective's is."""
    ns = {"__name__": "torch.distributed.distributed_c10d"}
    exec(f"def all_reduce(t):\n    raise RuntimeError({message!r})", ns)
    return ns["all_reduce"]


@pytest.mark.parametrize("gone", [True, False], ids=["member_gone", "own_fault"])
def test_a_collective_error_in_r0_is_silent_only_when_a_member_is_gone(gone):
    """An op of r0 that fails in a collective because a rank of its group
    is gone (gloo's "Connection closed by peer") gets no reply: the router
    loses r0 after its timeout. Any other error, in a collective too, comes
    back as `ReplicaFailed` with its traceback."""
    message = ("[pair.cc:553] Connection closed by peer [127.0.0.1]:2944" if gone
               else "Tensors must be contiguous")
    reduce = _collective(message)

    class Collective(ReplicaActor):
        def handle(self, payload):
            reduce(torch.zeros(1))

    store = dist.PrefixStore("serve", dist.HashStore())
    server = ReplicaServer(store, "r0", Collective(batch_slots=1), lead=True,
                           signalled=lambda: False, timeout=5.0)
    thread = ServerThread(server, torch.device("cpu"))
    thread.start()
    link = StoreTransport(store, "r0", timeout=0.5 if gone else 5.0)
    if gone:
        with pytest.raises(ReplicaLost, match="'r0' did not answer op 1"):
            link({"kind": "tick"})
    else:
        with pytest.raises(ReplicaFailed, match="Tensors must be contiguous"):
            link({"kind": "tick"})
    thread.join(5)
    assert peer_lost(thread.error) == gone and store.check(["r0/reply/1"]) != gone
    assert not peer_lost(RuntimeError(message))   # raised outside a collective


def test_requests_file_arrival_default(tmp_path):
    """`arrival_s` is seconds after the router's start, 0 where a row has
    none (every request at once, as before arrivals existed)."""
    path = tmp_path / "requests.jsonl"
    path.write_text('{"id": 3, "prompt": [1, 2]}\n{"id": 4, "prompt": [5], "arrival_s": 1.5}\n')
    assert [(r.id, r.arrival_s) for r in read_requests(str(path))] == [(3, 0.0), (4, 1.5)]


def test_requests_file_defaults(tmp_path):
    path = tmp_path / "requests.jsonl"
    path.write_text('{"id": 3, "prompt": [1, 2]}\n\n{"id": 4, "prompt": [5], '
                    '"max_new_tokens": 2, "eos_id": 9}\n')
    got = [(r.id, r.prompt, r.max_new_tokens, r.eos_id) for r in read_requests(str(path))]
    assert got == [(3, [1, 2], 16, -1), (4, [5], 2, 9)]
