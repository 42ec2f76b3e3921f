"""The port's Slurm GPU backend (src/repro_torch/backends/), its per-rank
entry (src/repro_torch/launch/rank.py), the ranks' backend decision
(src/repro_torch/distributed.py::init_rank) and the Trainer's preemption
agreed across ranks, on the CPU.

The rendered allocation, scale-up and scale-down are held line for line to
the reference Slurm backend's (src/repro/core/backends/slurm.py) from the
same request, but for the GPU lines (`--gres`, `--nv`); every rendered
command line parses with the parser of the module it runs. Then the
rendered `rank_<id>.sh` runs as two processes on the CPU (llama3-8b SMOKE,
fp32, mesh (2, 1), ZeRO-2), as Slurm would start them: step 1's loss and
grad norm held to JAX's single-device train step from the same params at
the bounds of tests/test_torch_zero_adafactor.py; SIGTERM to one rank
stops both at one step; a later step of the same job killed once its ranks
have joined leaves its store behind, and the step after it meets at a new
one and ends bit-identical to an uninterrupted run.
"""
import argparse
import json
import os
import shlex
import signal
import subprocess
import sys
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.worker as W
from repro.configs import get_config as jax_get_config
from repro.core.autoscaler import AutoscalerConfig
from repro.core.backends.base import AllocationRequest as RefRequest
from repro.core.backends.slurm import SlurmBackend
from repro.core.cluster import ContainerSpec as RefSpec
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as JO
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch import distributed as D
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.backends import (EXIT_PREEMPTED, AllocationRequest, ContainerSpec,
                                  SlurmGpuBackend)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import rank as R
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.trainer import Preempted, Trainer, TrainerConfig

import _torch_backends_ranks as BR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_zero_adafactor.py's bounds: the loss absolute, the grad norm relative
LOSS_TOL, METRIC_TOL = 1e-5, 1e-5
# the two-rank job on the CPU: enough steps after the step-1 checkpoint
# that the signal lands before the run ends
JOB = ["--arch", "llama3-8b", "--smoke", "--param-dtype", "float32", "--mesh", "2x1",
       "--steps", "12", "--batch", "4", "--seq", "16", "--ckpt-every", "1", "--device", "cpu"]
SPEC = dict(image="syndeo.sif", base="docker://python:3.11-slim", env={"A": "1"},
            binds=["/scratch:/scratch"], sandbox_writable=True,
            entrypoint="python -m repro.core.worker")
REQUESTS = {
    "4x4": dict(nodes=4, cpus_per_node=28, gpus_per_node=4, shared_dir="/shared/syndeo"),
    "2x8-reservation": dict(nodes=2, cpus_per_node=64, gpus_per_node=8,
                            shared_dir="/lustre/syndeo", reservation="syndeo-pool",
                            partition="h100", walltime="12:00:00"),
}


def _backends(req_kw, writable=True):
    spec = dict(SPEC, sandbox_writable=writable)
    return ((SlurmBackend(RefSpec(**spec)), RefRequest(**req_kw)),
            (SlurmGpuBackend(ContainerSpec(**spec)), AllocationRequest(**req_kw)))


def _strip_gpu(text, gpus):
    """A GPU artifact with its GPU lines taken out."""
    return text.replace(f"#SBATCH --gres=gpu:h100:{gpus}\n", "").replace(" --nv", "")


# ---------------------------------------------------------------- rendering


@pytest.mark.parametrize("writable", [True, False])
@pytest.mark.parametrize("name", list(REQUESTS))
def test_bring_up_holds_the_reference_slurm_lines(name, writable):
    """The allocation, its srun variant, scale-up and scale-down: the
    reference's text from the same request, plus `--gres` on each
    allocation and `--nv` on each container."""
    (ref, rreq), (gpu, greq) = _backends(REQUESTS[name], writable)
    g = greq.gpus_per_node
    want, got = ref.render_artifacts(rreq, "abc123"), gpu.render_artifacts(greq, "abc123")
    for fname in ("submit_abc123.sbatch", "srun_steps_abc123.sh"):
        assert _strip_gpu(got[fname], g) == want[fname], fname
        assert got[fname].count("apptainer exec --nv ") == want[fname].count("apptainer exec ")
    assert f"#SBATCH --gres=gpu:h100:{g}\n" in got["submit_abc123.sbatch"]
    up_want = ref.provision_workers(rreq, "abc123", 3)["scale_up_abc123_3.sbatch"]
    up_got = gpu.provision_workers(greq, "abc123", 3)["scale_up_abc123_3.sbatch"]
    assert _strip_gpu(up_got, g) == up_want
    assert f"#SBATCH --gres=gpu:h100:{g}\n" in up_got and "apptainer exec --nv " in up_got
    assert "#SBATCH --dependency=singleton" in up_got
    assert ("#SBATCH --reservation=syndeo-pool" in up_got) == bool(greq.reservation)
    for grace in (0.0, 60.0):
        down = (ref.release_workers(rreq, "abc123", ["node7", "node9"], grace),
                gpu.release_workers(greq, "abc123", ["node7", "node9"], grace))
        assert down[1] == down[0]
        assert "$MAP/node7.host" in down[1]["scale_down_abc123.sh"]


def test_gpu_definition_builds_the_kernels_into_a_cuda_image():
    spec = ContainerSpec()
    text = SlurmGpuBackend(spec).render_artifacts(
        AllocationRequest(nodes=1, gpus_per_node=1), "c")["syndeo.def"]
    assert f"From: {spec.base.removeprefix('docker://')}" in text and "nvidia/pytorch" in text
    assert "from repro_torch.kernels import build; build.build()" in text
    assert "pip install" not in text
    assert "export PYTHONPATH=/opt/syndeo/src" in text
    assert "src /opt/syndeo/src" in text


def test_ranks_step_and_rank_script():
    req = AllocationRequest(**REQUESTS["4x4"])
    arts = SlurmGpuBackend(ContainerSpec(**SPEC)).render_artifacts(req, "abc123")
    step = arts["ranks_abc123.sh"]
    assert ("srun --nodes=4 --ntasks-per-node=4 --gpus-per-task=1 --overlap" in step)
    # a preempted rank's exit kills no other rank; a failed one ends the step
    assert "--kill-on-bad-exit=0 --wait=120" in step and "--kill-on-bad-exit=1" not in step
    assert ("apptainer exec --nv --writable-tmpfs --bind /shared/syndeo:/shared/syndeo "
            "--bind /scratch:/scratch syndeo.sif bash /shared/syndeo/rank_abc123.sh \"$@\""
            in step)
    rank = arts["rank_abc123.sh"]
    for piece in ('--job-id "$SLURM_JOB_ID.${SLURM_STEP_ID:-0}.${SLURM_RESTART_COUNT:-0}"',
                  '--rank "$SLURM_PROCID"', '--world "$SLURM_NTASKS"',
                  '--local-rank "$SLURM_LOCALID" "$@"', "exec python3 -m repro_torch.launch.rank"):
        assert piece in rank, piece
    with pytest.raises(ValueError):
        SlurmGpuBackend(ContainerSpec()).render_artifacts(AllocationRequest(nodes=2), "c")


def test_autoscaler_gives_the_gpu_backend_slurms_cooldowns():
    b = SlurmGpuBackend(ContainerSpec())
    assert b.supports_elastic
    assert AutoscalerConfig.for_backend(b.name) == AutoscalerConfig.for_backend("slurm")
    assert AutoscalerConfig.for_backend(b.name) != AutoscalerConfig()
    with pytest.raises(NotImplementedError):
        b.preempt_workers(AllocationRequest(nodes=1, gpus_per_node=1), "c", ["n0"])


# ---------------------------------------------------------------- the command lines parse


class _Parsed(Exception):
    pass


def _worker_namespace(argv):
    """`repro.core.worker.main`'s parse of `argv`; its parser errors exit."""
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise _Parsed(parse(self, argv))

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed) as got:
            W.main()
    return got.value.args[0]


def _worker_lines(text):
    marker = "python -m repro.core.worker "
    return [shlex.split(line.split(marker, 1)[1].rsplit(" &", 1)[0])
            for line in text.splitlines() if marker in line]


def _fake(bin_dir, name):
    """A `name` on PATH that prints its arguments as one JSON line."""
    path = os.path.join(bin_dir, name)
    with open(path, "w") as f:
        f.write(f"#!/bin/sh\nexec {sys.executable} -c "
                "'import json, sys; print(json.dumps(sys.argv[1:]))' \"$@\"\n")
    os.chmod(path, 0o755)


def test_every_rendered_command_parses_with_its_modules_parser(tmp_path):
    req = AllocationRequest(**REQUESTS["4x4"])
    b = SlurmGpuBackend(ContainerSpec(**SPEC))
    arts = b.render_artifacts(req, "abc123")
    texts = [arts["submit_abc123.sbatch"], arts["srun_steps_abc123.sh"],
             b.provision_workers(req, "abc123", 2)["scale_up_abc123_2.sbatch"]]
    roles = []
    for text in texts:
        for argv in _worker_lines(text):
            ns = _worker_namespace(argv)
            assert ns.rendezvous == req.shared_dir and ns.cluster_id == "abc123"
            roles.append(ns.role)
    assert roles.count("head") == 2 and roles.count("worker") == 3, roles

    # the scripts as bash runs them, python3 and srun replaced by fakes
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("python3", "srun"):
        _fake(str(bin_dir), name)
    for fname, text in arts.items():
        (tmp_path / fname).write_text(text)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", SLURM_JOB_ID="4242",
               SLURM_PROCID="5", SLURM_NTASKS="16", SLURM_LOCALID="1")
    job = ["--arch", "llama3-8b", "--layers", "2", "--mesh", "4x4", "--steps", "7"]

    def run(fname, **extra):
        out = subprocess.run(["bash", str(tmp_path / fname), *job], env=dict(env, **extra),
                             capture_output=True, text=True, check=True, timeout=30)
        return json.loads(out.stdout)

    argv = run("rank_abc123.sh")
    assert argv[:2] == ["-m", "repro_torch.launch.rank"]
    ns = R.parser().parse_args(argv[2:])
    assert (ns.rank, ns.world, ns.local_rank, ns.job_id) == (5, 16, 1, "4242.0.0")
    assert (ns.rendezvous, ns.cluster_id) == (req.shared_dir, "abc123")
    assert (ns.arch, ns.layers, ns.mesh, ns.steps, ns.device) == ("llama3-8b", 2, "4x4", 7,
                                                                   "cuda")
    assert R.mesh_of(ns.mesh, ns.world) == ((4, 4), ("data", "model"))
    # a store a step and a restart: a later step of the allocation and a
    # requeued job each meet at their own
    for extra, want in (({"SLURM_RESTART_COUNT": "2"}, "4242.0.2"),
                        ({"SLURM_STEP_ID": "3"}, "4242.3.0"),
                        ({"SLURM_STEP_ID": "3", "SLURM_RESTART_COUNT": "1"}, "4242.3.1")):
        assert R.parser().parse_args(run("rank_abc123.sh", **extra)[2:]).job_id == want
    step = run("ranks_abc123.sh")
    assert step[-2 - len(job):] == ["bash", f"{req.shared_dir}/rank_abc123.sh", *job]
    assert step[step.index("exec") - 1:step.index("exec") + 2] == ["apptainer", "exec", "--nv"]


def test_rank_mesh_specs():
    assert R.mesh_of(None, 8) == ((8, 1), ("data", "model"))
    assert R.mesh_of("2x4x1", 8) == ((2, 4, 1), ("pod", "data", "model"))
    with pytest.raises(ValueError):
        R.mesh_of("8", 8)


# ---------------------------------------------------------------- the backend decision


@pytest.mark.parametrize("uuids,want", [
    (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),   # a card a rank, on one host or several
    (["GPU-a"], "nccl"),
    (["GPU-a", "GPU-a"], "gloo"),                     # ranks sharing a card
    (["GPU-a", "GPU-b", "GPU-a", "GPU-b"], "gloo"),
    (["", ""], "gloo"),                               # ranks on the CPU
    (["GPU-a", ""], "gloo"),
])
def test_backend_from_the_cards_the_ranks_hold(uuids, want):
    assert D.backend_for(uuids) == want


def test_card_uuid_of_the_cpu_is_empty():
    assert D.card_uuid(torch.device("cpu")) == ""


def test_backends_and_rank_entry_load_neither_jax_nor_repro():
    code = ("import json, sys; import repro_torch.backends, repro_torch.launch.rank; "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
                         check=True)
    assert json.loads(out.stdout) == []


# ---------------------------------------------------------------- the Trainer's agreed flag


def test_one_process_tests_its_own_flag_with_no_collective(tmp_path):
    """Without a mesh the Trainer stops at the boundary after its own
    request, and no collective is called on the way."""
    cfg = get_config("llama3-8b", smoke=True)
    t = Trainer(build_model(cfg, device="cpu"), make_optimizer("adamw"),
                TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)),
                Checkpointer(str(tmp_path)),
                TrainerConfig(num_steps=6, ckpt_every=100, log_every=1, n_microbatches=2),
                failure_hook=lambda step: step == 2 and t.request_preemption())
    with mock.patch("torch.distributed.all_reduce", side_effect=AssertionError("collective")):
        with pytest.raises(Preempted) as e:
            t.run(t.init_or_restore(0))
    assert e.value.step == 3 and t.ckpt.latest_step() == 3 and len(t.history) == 3


def test_a_flag_on_one_rank_stops_every_rank_at_one_step(tmp_path):
    """Rank 1 alone requests preemption during step 2: both ranks finish
    step 2, save step 3 and stop; without the agreement rank 1 would enter
    the checkpoint's gather while rank 0 entered step 3's collectives."""
    with mock.patch.dict(os.environ, {"OMP_NUM_THREADS": "1"}):   # beside the suite's workers
        got = D.spawn(BR.flag_one_rank, 2, str(tmp_path), 1, 2, 6, device="cpu", timeout=60)
    assert got == [{"stopped": 3, "latest": 3, "steps_run": [0, 1, 2]}] * 2, got


# ---------------------------------------------------------------- two rendered ranks on the CPU


def _launch(shared, cluster_id, job_id, step_id="0"):
    # a thread a rank: two jobs' ranks run at once beside the suite's workers
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), SLURM_JOB_ID=job_id,
               SLURM_STEP_ID=step_id, SLURM_NTASKS="2", SLURM_LOCALID="0",
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(["bash", os.path.join(shared, f"rank_{cluster_id}.sh"), *JOB],
                             env=dict(env, SLURM_PROCID=str(r)), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, cwd=REPO)
            for r in range(2)]


def _finish(procs):
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode in (0, EXIT_PREEMPTED), stderr[-4000:]
            out.append((p.returncode, json.loads(stdout.strip().splitlines()[-1])))
    finally:   # no rank outlives a failed launch
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _kill_once_joined(procs):
    """SIGKILL every rank once each has joined its group and restored its
    state (its line on stderr), as a node failure ends a step: no rank
    releases the store."""
    for p in procs:
        for line in p.stderr:
            if " from step " in line:
                break
    for p in procs:
        p.kill()
        p.communicate()


def _latest(directory):
    return max(int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_"))


def _jax_step1(shared):
    """JAX's single-device train step from the params the ranks draw, on
    the ranks' first global batch: (loss, grad norm)."""
    args = R.parser().parse_args(["--rendezvous", shared, "--cluster-id", "x", "--job-id", "0",
                                  "--rank", "0", "--world", "1", "--local-rank", "0", *JOB])
    cfg = R.job_config(args)
    params = build_model(cfg, device="cpu").init_params(
        torch.Generator(device="cpu").manual_seed(R.SEED))
    jcfg = jax_get_config("llama3-8b", smoke=True).replace(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(params))
    jopt = JO.make_optimizer("adamw")
    step = jax.jit(JS.make_train_step(jm, jopt, JO.warmup_cosine(3e-4, args.warmup, args.steps),
                                      n_microbatches=R.N_MICRO))
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                     global_batch=args.batch, seed=R.SEED)).batch_at(0)
    _, m = step({"params": jp, "opt": jopt.init(jp), "step": jnp.int32(0)},
                {k: jnp.asarray(v) for k, v in batch.items()})
    return float(m["loss"]), float(m["grad_norm"])


def _checkpoint(directory, step):
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return {k: (v["dtype"], np.load(os.path.join(d, v["file"]))) for k, v in leaves.items()}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The rendered ranks: a straight run (job 11); a run whose rank 1 takes
    SIGTERM once the step-1 checkpoint commits (job 12, step 0); the next
    step of job 12, killed once its ranks have joined; and step 2 of job 12,
    which resumes."""
    shared = str(tmp_path_factory.mktemp("shared"))
    req = AllocationRequest(nodes=2, gpus_per_node=1, shared_dir=shared)
    for cid in ("straight", "preempted"):
        for fname, text in SlurmGpuBackend(ContainerSpec()).render_artifacts(req, cid).items():
            with open(os.path.join(shared, fname), "w") as f:
                f.write(text)
    straight = _launch(shared, "straight", "11")
    preempted = _launch(shared, "preempted", "12")
    first = os.path.join(shared, "ckpt", "preempted", "step_0000000001")
    t0 = time.monotonic()
    while not os.path.isdir(first) and time.monotonic() - t0 < 180:
        if any(p.poll() is not None for p in preempted):
            break
        time.sleep(0.002)
    signalled = preempted[1].poll() is None
    if signalled:
        preempted[1].send_signal(signal.SIGTERM)
    jax_ref = _jax_step1(shared)
    runs = {"straight": _finish(straight), "preempted": _finish(preempted)}
    saved = sorted(os.listdir(os.path.dirname(first)))   # before the relaunches add their own
    stores = os.path.join(shared, "rdv", "torch")
    _kill_once_joined(_launch(shared, "preempted", "12", "1"))
    stale = sorted(os.listdir(stores))
    resumable = _latest(os.path.dirname(first))   # the killed step may have saved a step
    runs["relaunched"] = _finish(_launch(shared, "preempted", "12", "2"))
    return {"shared": shared, "runs": runs, "jax": jax_ref, "signalled": signalled,
            "saved": saved, "stale": stale, "resumable": resumable,
            "steps": int(JOB[JOB.index("--steps") + 1])}


def test_rendered_ranks_step_1_matches_jax(launched):
    loss, norm = launched["jax"]
    for code, r in launched["runs"]["straight"]:
        assert code == 0 and r["backend"] == "gloo" and r["mesh"] == [2, 1]
        first = r["history"][0]
        assert first["step"] == 0
        assert abs(first["loss"] - loss) <= LOSS_TOL, (first["loss"], loss)
        assert abs(first["grad_norm"] - norm) <= METRIC_TOL * abs(norm), (first["grad_norm"], norm)


def test_sigterm_to_one_rendered_rank_stops_both_at_one_step(launched):
    assert launched["signalled"], "the run ended before the signal"
    (c0, r0), (c1, r1) = launched["runs"]["preempted"]
    assert c0 == c1 == EXIT_PREEMPTED and r0["preempted"] and r1["preempted"]
    assert r0["stopped"] == r1["stopped"] and 1 < r0["stopped"] < launched["steps"], (r0, r1)
    assert launched["saved"][-1] == f"step_{r0['stopped']:010d}", launched["saved"]


def test_a_killed_step_s_store_stays_and_the_next_step_meets_at_its_own(launched):
    """The killed step left its store (job 12, step 1, restart 0) with its
    ranks' keys in it; step 2 of the same job met at a new store and ran
    to the end (a rank meeting at the stale one would pass its barrier on
    the dead ranks' count and hang dialling their addresses)."""
    assert launched["stale"] == ["preempted-12.1.0"], launched["stale"]
    for code, r in launched["runs"]["relaunched"]:
        assert code == 0 and r["backend"] == "gloo" and r["stopped"] == launched["steps"]


def test_relaunch_after_preemption_ends_bit_identical(launched):
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
