"""The port's Kubernetes GPU backend (src/repro_torch/backends/kubernetes_gpu.py)
and the optimizer of its per-rank entry (src/repro_torch/launch/rank.py), on
the CPU.

The rendered head Service and Pod, worker Deployment, HPA and metrics
adapter, scale-up and scale-down are held line for line to the reference
Kubernetes backend's (src/repro/core/backends/kubernetes.py) from the same
request, but for the worker pods' `nvidia.com/gpu` limit; parsed as YAML,
every pod runs as a non-root user with the shared claim at the request's
shared directory. The indexed Job of the ranks holds the Job's contract;
its pod script, run under bash with `python3` replaced by a fake, starts
node-major ranks and exits as the pod's ranks did.

Then the rendered `rank_<id>.sh` runs as two "nodes" x one rank on the CPU
(llama3-8b SMOKE, fp32, mesh (2, 1), ZeRO-2, Adafactor), each pod script
under bash with `JOB_COMPLETION_INDEX` and `JOB_UID` set by hand, one Job
at a time, one thread a rank: step 1's loss and grad norm held to JAX's
single-device train step from the same params; every step's loss and grad
norm, and the final params, held to one process's Trainer on the same job
at the bounds of tests/test_torch_zero_adafactor.py; SIGTERM to one pod's
shell stops both ranks at one checkpointed step and both shells exit 75; a
Job killed once its ranks have joined leaves its store behind, and the
relaunch under a new Job UID meets at a store of its own and ends bit for
bit where the straight run ends.
"""
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.autoscaler import AutoscalerConfig
from repro.core.backends.base import AllocationRequest as RefRequest
from repro.core.backends.kubernetes import KubernetesBackend
from repro.core.cluster import ContainerSpec as RefSpec
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as JO
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch.backends import (EXIT_PREEMPTED, AllocationRequest, ContainerSpec,
                                  KubernetesGpuBackend)
from repro_torch.backends.kubernetes_gpu import JOB_UID_LABEL, STOP_GRACE_S
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import rank as R
from repro_torch.models import build_model
from repro_torch.tree import flatten

import _torch_subproc as subproc

# tests/test_torch_zero_adafactor.py's bounds: the loss absolute, the grad
# norm relative, a param within STEP_REL of its update (or STEP_ABS an entry)
LOSS_TOL, METRIC_TOL, STEP_REL, STEP_ABS = 1e-5, 1e-5, 1e-2, 1e-5
# the two-rank job on the CPU: enough steps after the step-1 checkpoint
# that the signal lands before the run ends
JOB = ["--arch", "llama3-8b", "--smoke", "--param-dtype", "float32", "--mesh", "2x1",
       "--optimizer", "adafactor", "--steps", "12", "--batch", "4", "--seq", "16",
       "--ckpt-every", "1", "--device", "cpu"]
SPEC = dict(image="syndeo.sif", base="docker://python:3.11-slim", env={"A": "1"},
            binds=["/scratch:/scratch"], sandbox_writable=True,
            entrypoint="python -m repro.core.worker")
REQUESTS = {
    "4x4": dict(nodes=4, cpus_per_node=28, gpus_per_node=4, shared_dir="/shared/syndeo"),
    "2x8": dict(nodes=2, cpus_per_node=64, gpus_per_node=8, shared_dir="/lustre/syndeo"),
}
REFERENCE_FILES = ["syndeo_abc123.yaml", "syndeo_hpa_abc123.yaml",
                   "syndeo_metrics_adapter_abc123.yaml"]


def _backends(req_kw):
    return ((KubernetesBackend(RefSpec(**SPEC)), RefRequest(**req_kw)),
            (KubernetesGpuBackend(ContainerSpec(**SPEC)), AllocationRequest(**req_kw)))


def _gpu_line(gpus):
    return f"          limits: {{nvidia.com/gpu: {gpus}}}\n"


def _pod_specs(docs):
    """Each pod spec of the parsed documents (a Pod's, a template's)."""
    for d in docs:
        if d["kind"] == "Pod":
            yield d["spec"]
        elif d["kind"] in ("Deployment", "Job"):
            yield d["spec"]["template"]["spec"]


def _holds_the_claim_as_non_root(spec, shared):
    assert spec["securityContext"] == {"runAsNonRoot": True, "runAsUser": 1000}
    claims = [v["name"] for v in spec["volumes"]
              if v.get("persistentVolumeClaim") == {"claimName": "syndeo-shared"}]
    assert len(claims) == 1
    for c in spec["containers"]:
        assert {"name": claims[0], "mountPath": shared} in c["volumeMounts"]


# ---------------------------------------------------------------- rendering


@pytest.mark.parametrize("name", list(REQUESTS))
def test_bring_up_holds_the_reference_kubernetes_lines(name):
    """The reference's documents from the same request, plus the worker
    pods' `nvidia.com/gpu` limit; scale-up and scale-down the reference's."""
    yaml = pytest.importorskip("yaml")
    (ref, rreq), (gpu, greq) = _backends(REQUESTS[name])
    g = greq.gpus_per_node
    want, got = ref.render_artifacts(rreq, "abc123"), gpu.render_artifacts(greq, "abc123")
    assert set(want) == set(REFERENCE_FILES)
    for fname in REFERENCE_FILES:
        assert got[fname].replace(_gpu_line(g), "") == want[fname], fname
    assert got["syndeo_abc123.yaml"].count(_gpu_line(g)) == 1
    docs = [d for f in REFERENCE_FILES for d in yaml.safe_load_all(got[f])]
    specs = list(_pod_specs(docs))
    assert len(specs) == 3   # the head, the workers, the metrics adapter
    for spec in specs:
        _holds_the_claim_as_non_root(spec, greq.shared_dir)
    (workers,) = [d for d in docs if d["metadata"]["name"] == "syndeo-workers-abc123"
                  and d["kind"] == "Deployment"]
    (worker,) = workers["spec"]["template"]["spec"]["containers"]
    assert worker["resources"] == {"requests": {"cpu": str(greq.cpus_per_node)},
                                   "limits": {"nvidia.com/gpu": g}}
    assert workers["spec"]["replicas"] == greq.nodes - 1
    up = (ref.provision_workers(rreq, "abc123", 3), gpu.provision_workers(greq, "abc123", 3))
    assert up[1] == up[0] and "kubectl scale" not in up[1]["scale_up_abc123_3.sh"]
    for grace in (0.0, 60.0):
        down = (ref.release_workers(rreq, "abc123", ["w-7", "w-9"], grace),
                gpu.release_workers(greq, "abc123", ["w-7", "w-9"], grace))
        assert down[1] == down[0]
        text = down[1]["scale_down_abc123.sh"]
        assert "controller.kubernetes.io/pod-deletion-cost=-999" in text
        assert f"--timeout={int(grace) + 180}s" in text and "kubectl scale" not in text


def test_ranks_job_is_an_indexed_job_of_gpu_pods():
    yaml = pytest.importorskip("yaml")
    req = AllocationRequest(**REQUESTS["4x4"])
    b = KubernetesGpuBackend(ContainerSpec(**SPEC))
    (job,) = yaml.safe_load_all(b.render_artifacts(req, "abc123")["ranks_abc123.yaml"])
    assert (job["apiVersion"], job["kind"]) == ("batch/v1", "Job")
    spec = job["spec"]
    assert spec["completionMode"] == "Indexed"
    assert spec["completions"] == spec["parallelism"] == req.nodes
    assert spec["backoffLimit"] == 0
    # exit 75 is a preemption: the Job ends under its own rule, not retried in place
    assert spec["podFailurePolicy"]["rules"] == [
        {"action": "FailJob", "onExitCodes": {"containerName": "rank", "operator": "In",
                                              "values": [EXIT_PREEMPTED]}}]
    pod = spec["template"]["spec"]
    assert pod["restartPolicy"] == "Never"
    assert pod["terminationGracePeriodSeconds"] == STOP_GRACE_S >= 300
    _holds_the_claim_as_non_root(pod, req.shared_dir)
    (c,) = pod["containers"]
    assert c["name"] == "rank" and c["image"] == "syndeo:latest"
    assert c["command"] == ["bash", f"{req.shared_dir}/rank_abc123.sh"] and c["args"] == []
    assert c["resources"]["limits"] == {"nvidia.com/gpu": req.gpus_per_node}
    assert c["env"] == [{"name": "JOB_UID", "valueFrom": {"fieldRef": {
        "fieldPath": f"metadata.labels['{JOB_UID_LABEL}']"}}}]
    # the job's own arguments
    (job,) = yaml.safe_load_all(b.ranks_job(req, "abc123", ["--arch", "llama3-8b", "--steps",
                                                            "9", "--note", 'a "b"']))
    assert job["spec"]["template"]["spec"]["containers"][0]["args"] == [
        "--arch", "llama3-8b", "--steps", "9", "--note", 'a "b"']


def test_a_gpu_backend_needs_cards_and_gets_kubernetes_cooldowns():
    b = KubernetesGpuBackend(ContainerSpec())
    with pytest.raises(ValueError):
        b.render_artifacts(AllocationRequest(nodes=2), "c")
    assert b.supports_elastic and b.name == KubernetesBackend.name
    assert AutoscalerConfig.for_backend(b.name) == AutoscalerConfig.for_backend("kubernetes")
    assert AutoscalerConfig.for_backend(b.name) != AutoscalerConfig()
    with pytest.raises(NotImplementedError):
        b.preempt_workers(AllocationRequest(nodes=1, gpus_per_node=1), "c", ["n0"])


# ---------------------------------------------------------------- the pod script


def _stage(shared, nodes, gpus, cluster_id):
    req = AllocationRequest(nodes=nodes, gpus_per_node=gpus, shared_dir=str(shared))
    arts = KubernetesGpuBackend(ContainerSpec()).render_artifacts(req, cluster_id)
    for fname, text in arts.items():
        with open(os.path.join(shared, fname), "w") as f:
            f.write(text)
    return os.path.join(shared, f"rank_{cluster_id}.sh")


def _fake_python(bin_dir):
    """A `python3` on PATH that prints its arguments as one JSON line (one
    write, so the node's ranks' lines do not interleave) and exits with the
    code `CODES` gives its local rank (0 by default)."""
    path = os.path.join(bin_dir, "python3")
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\nexec {sys.executable} -c '"
                "import json, os, sys; a = sys.argv[1:]; "
                "os.write(1, (json.dumps(a) + chr(10)).encode()); "
                "codes = os.environ.get(\"CODES\", \"\").split(); "
                "i = int(a[a.index(\"--local-rank\") + 1]); "
                "sys.exit(int(codes[i]) if codes else 0)' \"$@\"\n")
    os.chmod(path, 0o755)


@pytest.mark.parametrize("node", [0, 1])
def test_pod_script_starts_node_major_ranks(tmp_path, node):
    script = _stage(tmp_path, 2, 4, "abc123")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    _fake_python(str(bin_dir))
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               JOB_COMPLETION_INDEX=str(node), JOB_UID="0f1e-2d3c")
    job = ["--arch", "llama3-8b", "--layers", "2", "--mesh", "2x4", "--steps", "7"]
    out = subprocess.run(["bash", script, *job], env=env, capture_output=True, text=True,
                         check=True, timeout=30)
    argvs = [json.loads(line) for line in out.stdout.splitlines()]
    assert len(argvs) == 4
    got = []
    for argv in argvs:
        assert argv[:2] == ["-m", "repro_torch.launch.rank"]
        ns = R.parser().parse_args(argv[2:])
        assert (ns.world, ns.job_id, ns.cluster_id, ns.rendezvous) == (
            8, "k8s-0f1e-2d3c", "abc123", str(tmp_path))
        assert (ns.arch, ns.layers, ns.mesh, ns.steps) == ("llama3-8b", 2, "2x4", 7)
        got.append((ns.rank, ns.local_rank))
    assert sorted(got) == [(node * 4 + i, i) for i in range(4)]
    # the last axis of the mesh, "model", stays inside the node
    assert R.mesh_of("2x4", 8) == ((2, 4), ("data", "model"))


@pytest.mark.parametrize("codes,want", [
    ("0 0", 0),
    (f"{EXIT_PREEMPTED} {EXIT_PREEMPTED}", EXIT_PREEMPTED),
    (f"0 {EXIT_PREEMPTED}", EXIT_PREEMPTED),
    (f"{EXIT_PREEMPTED} 3", 3),
    ("0 3", 3),
])
def test_pod_script_exits_as_its_ranks_did(tmp_path, codes, want):
    script = _stage(tmp_path, 1, 2, "c")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    _fake_python(str(bin_dir))
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", JOB_COMPLETION_INDEX="0",
               JOB_UID="u", CODES=codes)
    out = subprocess.run(["bash", script], env=env, capture_output=True, text=True, timeout=30)
    assert out.returncode == want, out.stderr
    assert len(out.stdout.splitlines()) == 2


def test_pod_script_without_its_job_identity_starts_no_rank(tmp_path):
    script = _stage(tmp_path, 1, 1, "c")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    _fake_python(str(bin_dir))
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", JOB_COMPLETION_INDEX="0")
    env.pop("JOB_UID", None)
    out = subprocess.run(["bash", script], env=env, capture_output=True, text=True, timeout=30)
    assert out.returncode != 0 and out.stdout == "" and "JOB_UID" in out.stderr


# ---------------------------------------------------------------- the optimizer of a rank job


@pytest.mark.parametrize("arch,flag,want", [("llama3-8b", None, "adamw"),
                                            ("arctic-480b", None, "adafactor"),
                                            ("llama3-8b", "adafactor", "adafactor"),
                                            ("arctic-480b", "adamw", "adamw")])
def test_rank_job_trains_with_the_config_s_optimizer_or_the_flag(tmp_path, arch, flag, want):
    argv = ["--rendezvous", str(tmp_path), "--cluster-id", "c", "--job-id", "0", "--rank", "0",
            "--world", "1", "--local-rank", "0", "--arch", arch, "--smoke", "--layers", "1",
            "--device", "cpu"] + (["--optimizer", flag] if flag else [])
    args = R.parser().parse_args(argv)
    assert R.job_config(args).optimizer == ("adafactor" if arch == "arctic-480b" else "adamw")
    trainer = R.make_trainer(args, torch.device("cpu"), None, str(tmp_path / "ckpt"))
    assert trainer.opt.name == want


# ---------------------------------------------------------------- two rendered pods on the CPU


def _launch(shared, cluster_id, uid):
    """A Job of two pods, one rank each: the pod script under bash once a
    node, each in its own session, so the pod's rank goes with it."""
    env = dict(subproc.env(), JOB_UID=uid)
    return [subprocess.Popen(["bash", os.path.join(shared, f"rank_{cluster_id}.sh"), *JOB],
                             env=dict(env, JOB_COMPLETION_INDEX=str(node)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=subproc.REPO, start_new_session=True)
            for node in range(2)]


def _kill(pods):
    for p in pods:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.communicate()


def _finish(pods):
    """Each pod's exit code and its rank's JSON line."""
    out = []
    try:
        for p in pods:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode in (0, EXIT_PREEMPTED), stderr[-4000:]
            out.append((p.returncode, json.loads(stdout.strip().splitlines()[-1])))
    finally:   # no rank outlives a failed launch
        _kill([p for p in pods if p.poll() is None])
    return out


def _kill_once_joined(pods):
    """SIGKILL every pod with its rank once each rank has joined its group
    and restored its state (its line on stderr), as a node failure ends a
    Job: no rank releases the store."""
    for p in pods:
        for line in p.stderr:
            if " from step " in line:
                break
    _kill(pods)


def _latest(directory):
    return max(int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_"))


def _job_args(shared, cluster_id):
    return R.parser().parse_args(["--rendezvous", shared, "--cluster-id", cluster_id,
                                  "--job-id", "0", "--rank", "0", "--world", "1",
                                  "--local-rank", "0", *JOB])


def _jax_step1(args):
    """JAX's single-device train step from the params the ranks draw, on
    the ranks' first global batch: (loss, grad norm)."""
    cfg = R.job_config(args)
    params = build_model(cfg, device="cpu").init_params(
        torch.Generator(device="cpu").manual_seed(R.SEED))
    jcfg = jax_get_config("llama3-8b", smoke=True).replace(param_dtype="float32")
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(params))
    jopt = JO.make_optimizer(args.optimizer)
    step = jax.jit(JS.make_train_step(jax_build_model(jcfg), jopt,
                                      JO.warmup_cosine(3e-4, args.warmup, args.steps),
                                      n_microbatches=R.N_MICRO))
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                     global_batch=args.batch, seed=R.SEED)).batch_at(0)
    _, m = step({"params": jp, "opt": jopt.init(jp), "step": jnp.int32(0)},
                {k: jnp.asarray(v) for k, v in batch.items()})
    return float(m["loss"]), float(m["grad_norm"])


def _params(state):
    """The state's params by checkpoint key, as numpy."""
    return {"/".join(map(str, ("params",) + path)): t.detach().numpy().copy()
            for path, t in flatten(state["params"])}


def _one_process(args, directory):
    """One process's Trainer on the job: its history, its first and its
    final params."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)   # beside the pods' ranks and the suite's workers
    try:
        trainer = R.make_trainer(args, torch.device("cpu"), None, directory)
        state = trainer.init_or_restore(R.SEED)
        first = _params(state)
        return trainer.history, first, _params(trainer.run(state))
    finally:
        torch.set_num_threads(prev)


def _checkpoint(directory, step):
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        leaves_ = json.load(f)["leaves"]
    return {k: (v["dtype"], np.load(os.path.join(d, v["file"]))) for k, v in leaves_.items()}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The rendered pods, one Job at a time: a straight run (Job UID
    "straight-1"); a run whose node-1 shell takes SIGTERM once the step-1
    checkpoint commits ("pre-1"); a Job killed once its ranks have joined
    ("pre-2"); and the relaunch, a new Job ("pre-3"), which resumes."""
    with subproc.slot():
        return _launches(str(tmp_path_factory.mktemp("shared")))


def _launches(shared):
    for cid in ("straight", "preempted"):
        _stage(shared, 2, 1, cid)
    straight = _launch(shared, "straight", "straight-1")
    args = _job_args(shared, "straight")
    refs = {"jax": _jax_step1(args), "one": _one_process(args, os.path.join(shared, "one"))}
    runs = {"straight": _finish(straight)}

    preempted = _launch(shared, "preempted", "pre-1")
    first = os.path.join(shared, "ckpt", "preempted", "step_0000000001")
    t0 = time.monotonic()
    while not os.path.isdir(first) and time.monotonic() - t0 < 180:
        if any(p.poll() is not None for p in preempted):
            break
        time.sleep(0.002)
    signalled = preempted[1].poll() is None
    if signalled:
        preempted[1].send_signal(signal.SIGTERM)   # the shell alone, as an eviction does
    runs["preempted"] = _finish(preempted)
    saved = sorted(os.listdir(os.path.dirname(first)))   # before the relaunches add their own
    stores = os.path.join(shared, "rdv", "torch")
    _kill_once_joined(_launch(shared, "preempted", "pre-2"))
    stale = sorted(os.listdir(stores))
    resumable = _latest(os.path.dirname(first))   # the killed Job may have saved a step
    runs["relaunched"] = _finish(_launch(shared, "preempted", "pre-3"))
    return {"shared": shared, "stores": stores, "runs": runs, "refs": refs,
            "signalled": signalled, "saved": saved, "stale": stale, "resumable": resumable,
            "steps": args.steps}


def test_rendered_pods_step_1_matches_jax(launched):
    loss, norm = launched["refs"]["jax"]
    for node, (code, r) in enumerate(launched["runs"]["straight"]):
        assert code == 0 and r["rank"] == node and r["world"] == 2
        assert r["backend"] == "gloo" and r["mesh"] == [2, 1]
        first = r["history"][0]
        assert first["step"] == 0
        assert abs(first["loss"] - loss) <= LOSS_TOL, (first["loss"], loss)
        assert abs(first["grad_norm"] - norm) <= METRIC_TOL * abs(norm), (first["grad_norm"], norm)


def test_rank_job_on_adafactor_matches_one_process_trainer(launched):
    """Every step's loss and grad norm of the two ranks on Adafactor, and
    their final params (the straight run's last checkpoint), against one
    process's Trainer on the same job."""
    history, p0, p1 = launched["refs"]["one"]
    steps = launched["steps"]
    assert [h["step"] for h in history] == list(range(steps))
    for _, r in launched["runs"]["straight"]:
        assert [h["step"] for h in r["history"]] == list(range(steps))
        for got, want in zip(r["history"], history):
            assert abs(got["loss"] - want["loss"]) <= LOSS_TOL, (got, want)
            assert abs(got["grad_norm"] - want["grad_norm"]) <= METRIC_TOL * want["grad_norm"]
    saved = _checkpoint(os.path.join(launched["shared"], "ckpt", "straight"), steps)
    assert sorted(k for k in saved if k.startswith("params/")) == sorted(p1)
    assert any(k.startswith("opt/") and k.endswith(("/vr", "/vc")) for k in saved), \
        sorted(saved)[:20]
    for k, want in p1.items():
        dtype, got = saved[k]
        tol = max(STEP_ABS * np.sqrt(want.size), STEP_REL * float(np.linalg.norm(want - p0[k])))
        assert float(np.linalg.norm(got - want)) <= tol, k


def test_sigterm_to_one_pod_s_shell_stops_both_ranks_at_one_step(launched):
    assert launched["signalled"], "the run ended before the signal"
    (c0, r0), (c1, r1) = launched["runs"]["preempted"]
    assert c0 == c1 == EXIT_PREEMPTED and r0["preempted"] and r1["preempted"]
    assert r0["stopped"] == r1["stopped"] and 1 < r0["stopped"] < launched["steps"], (r0, r1)
    assert launched["saved"][-1] == f"step_{r0['stopped']:010d}", launched["saved"]


def test_a_killed_job_s_store_stays_and_the_relaunch_meets_at_its_own(launched):
    """The killed Job left its store, with its ranks' keys in it; the
    relaunch, a new Job UID, met at a store of its own, which no launch
    before it had made, and ran to the end (a rank meeting at the stale one
    would pass its barrier on the dead ranks' count and hang dialling their
    addresses). A Job whose ranks all stopped usually removes its store
    (the last rank to let go of a `FileStore` deletes its file), but
    nothing here relies on it."""
    assert "preempted-k8s-pre-2" in launched["stale"], launched["stale"]
    assert "preempted-k8s-pre-3" not in launched["stale"], launched["stale"]
    killed = os.path.join(launched["stores"], "preempted-k8s-pre-2")
    for code, r in launched["runs"]["relaunched"]:
        assert code == 0 and r["backend"] == "gloo" and r["stopped"] == launched["steps"]
        assert r["store"] == os.path.join(launched["stores"], "preempted-k8s-pre-3")
        assert r["store"] != killed
    for code, r in launched["runs"]["preempted"]:
        assert r["store"] == os.path.join(launched["stores"], "preempted-k8s-pre-1")


def test_relaunch_under_a_new_job_ends_bit_identical(launched):
    stopped = launched["runs"]["preempted"][0][1]["stopped"]
    assert launched["resumable"] >= stopped
    for code, r in launched["runs"]["relaunched"]:
        assert code == 0 and r["start"] == launched["resumable"]
        assert r["stopped"] == launched["steps"]
    steps, root = launched["steps"], os.path.join(launched["shared"], "ckpt")
    a, b = _checkpoint(os.path.join(root, "straight"), steps), \
        _checkpoint(os.path.join(root, "preempted"), steps)
    assert sorted(a) == sorted(b) and len(a) > 10
    for k in a:
        assert a[k][0] == b[k][0] and np.array_equal(a[k][1], b[k][1]), k
    # the losses of every step either run took agree too, bit for bit
    want = [h["loss"] for h in launched["runs"]["straight"][0][1]["history"]]
    before = [h["loss"] for h in launched["runs"]["preempted"][0][1]["history"]]
    after = [h["loss"] for h in launched["runs"]["relaunched"][0][1]["history"]]
    assert before == want[:stopped] and after == want[launched["resumable"]:]
