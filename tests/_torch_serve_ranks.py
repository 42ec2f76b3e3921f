"""The serving ranks' cases for tests/test_torch_serve_ranks.py, run in the
module's one subprocess (`run_cases`): each case starts the ranks of a
`launch/rank.py --serve` job on the CPU, a process a rank with one thread,
all cases at once; then replays rank 0's run in this process over local
engines on the same params (`launch/serve.py::replay`). Imports no JAX."""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.backends import AllocationRequest, ContainerSpec, SlurmGpuBackend
from repro_torch.launch import rank as R
from repro_torch.launch.serve import read_requests, replay
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.router import ReplicaActor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# llama3-8b SMOKE in fp32: the same engine code on the same params gives the
# same tokens, in a rank or here
MODEL = ["--arch", "llama3-8b", "--smoke", "--param-dtype", "float32", "--device", "cpu"]
SLOTS, MAX_LEN, QUEUE = 2, 64, 2
N_REQUESTS, NEW_TOKENS = 16, 32
# seconds rank 0 waits for a reply before it fails the replica: the SIGKILL
# case's, and every other case's
KILL_TIMEOUT, TIMEOUT = 8.0, 120.0
# mesh, the signal sent once replica r1 (WATCH: another) has finished a
# request and the rank it goes to, and whether the ranks start through
# Slurm's rendered rank_<id>.sh
CASES = {"2x1": ("2x1", None, 1, False), "1x2": ("1x2", None, 1, False),
         "2x2": ("2x2", None, 1, False), "sigterm": ("2x1", signal.SIGTERM, 1, False),
         "sigkill": ("2x1", signal.SIGKILL, 1, False),
         "sigterm0": ("2x1", signal.SIGTERM, 0, False), "slurm": ("2x1", None, 1, True),
         "autoscale": ("3x1", None, 1, False), "r0member": ("2x2", signal.SIGKILL, 1, False)}
# r0member: SIGKILL to rank 1, a member of rank 0's own replica r0, once r0
# has finished a request
WATCH = {"r0member": "r0"}
# autoscale: the requests arrive (ARRIVALS, seconds after the router's
# start: 12 over 0.3 s, then 4 a half second apart from 2 s), and the rows
# are grown and shrunk on queue depth alone (the p99 target is out of reach,
# so no wall-clock latency decides)
ARRIVALS = [0.025 * i for i in range(12)] + [2.0 + 0.5 * i for i in range(4)]
AUTOSCALE = {"autoscale": {"min_replicas": 1, "max_replicas": 3, "p99_target_ms": 1e9,
                           "queue_depth_target": 1.0, "low_water_fraction": 0.5,
                           "scale_up_cooldown_s": 0.05, "scale_down_cooldown_s": 0.3,
                           "max_step": 1}}


def write_requests(path: str, vocab: int, seed: int = 0, arrivals=None):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(N_REQUESTS):
            prompt = rng.integers(1, vocab, int(rng.integers(4, 25))).tolist()
            row = {"id": i, "prompt": prompt, "max_new_tokens": NEW_TOKENS, "eos_id": -1}
            if arrivals is not None:
                row["arrival_s"] = arrivals[i]
            f.write(json.dumps(row) + "\n")


def requests_file(shared: str, name: str) -> str:
    return f"{shared}/{name}.requests.jsonl" if name in AUTOSCALE else f"{shared}/requests.jsonl"


def job_args(shared: str, name: str, mesh: str, timeout: float) -> list:
    scaling = ["--autoscale", json.dumps(AUTOSCALE[name])] if name in AUTOSCALE else []
    return [*MODEL, "--mesh", mesh, "--serve", "--requests", requests_file(shared, name),
            "--outputs", f"{shared}/{name}.outputs.jsonl", "--slots", str(SLOTS),
            "--max-len", str(MAX_LEN), "--queue", str(QUEUE),
            "--replica-timeout", str(timeout), *scaling]


def launch(shared: str, name: str, mesh: str, timeout: float, slurm: bool) -> list:
    world = int(np.prod([int(n) for n in mesh.split("x")]))
    job = job_args(shared, name, mesh, timeout)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    if slurm:   # as srun starts one task a node: SLURM_PROCID is the rank
        env.update(SLURM_JOB_ID="32", SLURM_STEP_ID="0", SLURM_NTASKS=str(world),
                   SLURM_LOCALID="0")
        return [subprocess.Popen(["bash", f"{shared}/rank_{name}.sh", *job],
                                 env=dict(env, SLURM_PROCID=str(r)), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, cwd=REPO)
                for r in range(world)]
    return [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.rank",
                              "--rendezvous", shared, "--cluster-id", name, "--job-id", "1",
                              "--rank", str(r), "--world", str(world), "--local-rank", "0", *job],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=REPO)
            for r in range(world)]


def outputs(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f.read().splitlines(keepends=True)
                if line.endswith("\n")]


def signal_once_finished(path: str, replica: str, proc, sig, t0: float, sent: list):
    """Send `sig` to `proc` once `replica` has a finished request in the
    outputs at `path`."""
    while proc.poll() is None and time.monotonic() - t0 < 180:
        if any(o["replica"] == replica for o in outputs(path)):
            proc.send_signal(sig)
            sent.append(time.monotonic() - t0)
            return
        time.sleep(0.002)


def finish(procs, t0: float) -> list:
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            lines = stdout.strip().splitlines()
            out.append({"code": p.returncode, "seconds": time.monotonic() - t0,
                        "line": json.loads(lines[-1]) if lines else None,
                        "stderr": stderr[-3000:]})
    finally:   # no rank outlives its case
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def local_actors(n_replicas: int) -> dict:
    """One ReplicaActor a replica over one process's engine on the seed's
    params, as `launch/serve.py::build_engine` draws them."""
    args = R.parser().parse_args(["--rendezvous", ".", "--cluster-id", "x", "--job-id", "0",
                                  "--rank", "0", "--world", "1", "--local-rank", "0", *MODEL])
    model = build_model(R.job_config(args), device="cpu")
    params = model.init_params(torch.Generator(device="cpu").manual_seed(R.SEED))
    return {f"r{d}": ReplicaActor(engine=ServeEngine(model, params, batch_slots=SLOTS,
                                                     max_len=MAX_LEN, device="cpu"))
            for d in range(n_replicas)}


def run_cases() -> dict:
    from repro_torch.configs import get_config
    with tempfile.TemporaryDirectory(prefix="serve-ranks-") as shared:
        vocab = get_config("llama3-8b", smoke=True).vocab_size
        write_requests(f"{shared}/requests.jsonl", vocab)
        for name in AUTOSCALE:
            write_requests(requests_file(shared, name), vocab, arrivals=ARRIVALS)
        for name, (mesh, _, _, slurm) in CASES.items():
            if slurm:
                world = int(np.prod([int(n) for n in mesh.split("x")]))
                req = AllocationRequest(nodes=world, gpus_per_node=1, shared_dir=shared)
                arts = SlurmGpuBackend(ContainerSpec()).render_artifacts(req, name)
                with open(f"{shared}/rank_{name}.sh", "w") as f:
                    f.write(arts[f"rank_{name}.sh"])
        t0 = time.monotonic()
        procs, signallers, sent = {}, [], {}
        for name, (mesh, sig, target, slurm) in CASES.items():
            procs[name] = launch(shared, name, mesh, KILL_TIMEOUT if sig == signal.SIGKILL
                                 else TIMEOUT, slurm)
            if sig is not None:
                sent[name] = []
                signallers.append(threading.Thread(
                    target=signal_once_finished,
                    args=(f"{shared}/{name}.outputs.jsonl", WATCH.get(name, "r1"),
                          procs[name][target], sig, t0, sent[name])))
                signallers[-1].start()
        done = {name: finish(p, t0) for name, p in procs.items()}
        for s in signallers:
            s.join()
        results = {}
        for name, (mesh, _, _, _) in CASES.items():
            ranks = done[name]
            routed = ranks[0]["line"]["router"] if ranks[0]["line"] else None
            again = None
            if routed is not None:
                again = replay(read_requests(requests_file(shared, name)),
                               local_actors(int(mesh.split("x")[0])), routed, QUEUE)
            results[name] = {"ranks": ranks, "outputs": outputs(f"{shared}/{name}.outputs.jsonl"),
                             "replay": again, "signalled_at": sent.get(name)}
        results["requests"] = [r.__dict__ for r in read_requests(f"{shared}/requests.jsonl")]
        results["seconds"] = time.monotonic() - t0
        return results
