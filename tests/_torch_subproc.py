"""The subprocess of the port's multi-rank test modules, with a thread budget.

Each of those modules runs its cases in one subprocess (a module fixture):
JAX on `devices` host devices, and beside it the port's gloo ranks, which
`repro_torch.distributed.spawn` starts from that subprocess and which
inherit its environment. Under `pytest -n 6` several such subprocesses run
at once on the machine's cores, so none may take the machine for itself:
  * `OMP_NUM_THREADS` caps torch's intra-op threads in the subprocess and in
    every rank it spawns (`distributed.init_rank` only ever lowers a rank's
    count, so it keeps this one);
  * `--xla_cpu_multi_thread_eigen=false` and `intra_op_parallelism_threads`
    keep XLA's CPU kernels on one thread a device.
Every comparison a module makes, bit for bit or within a tolerance, is
between runs made in that one subprocess, so under the same settings.
And at most SLOTS such subprocesses run at once across the run's workers
(`slot`: a lock on one of SLOTS files in a directory named by the xdist
run), so their ranks and the other workers' tests share the cores without
crowding; a subprocess's TIMEOUT starts once it has its slot.

`run(script)` runs the script (dedented) with `src/` and `tests/` on its
path, from the repository's root, and returns the JSON object its last
line of output prints; it fails with the subprocess's output if it exits
non-zero.
"""
from __future__ import annotations

import contextlib
import fcntl
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds a module's subprocess may take, once it has its slot
TIMEOUT = 300
# rank-spawning subprocesses that may run at once across the xdist workers
SLOTS = 3


@contextlib.contextmanager
def slot():
    """Hold one of SLOTS slots shared by the workers of this pytest-xdist run
    (waiting for one to free); outside xdist, nothing to share."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run_id:
        yield
        return
    directory = os.path.join(tempfile.gettempdir(), f"repro-torch-slots-{run_id}")
    os.makedirs(directory, exist_ok=True)
    while True:
        for k in range(SLOTS):
            with open(os.path.join(directory, f"slot{k}"), "a") as f:
                try:
                    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except BlockingIOError:
                    continue
                try:
                    yield
                finally:
                    fcntl.flock(f, fcntl.LOCK_UN)
                return
        time.sleep(0.5)


def env(devices: Optional[int] = None) -> dict:
    """The subprocess's environment: `devices` JAX host devices (None: JAX's
    own default), one intra-op thread for torch and XLA."""
    out = dict(os.environ)
    flags = ["--xla_cpu_multi_thread_eigen=false", "intra_op_parallelism_threads=1"]
    if devices is not None:
        flags.insert(0, f"--xla_force_host_platform_device_count={devices}")
    out["XLA_FLAGS"] = " ".join(flags)
    out["OMP_NUM_THREADS"] = out["MKL_NUM_THREADS"] = "1"
    out["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
    return out


def run(script: str, devices: Optional[int] = None, timeout: float = TIMEOUT) -> dict:
    """Run `script` in a subprocess under `env(devices)`; the JSON object on
    its last line of output."""
    with slot():
        out = subprocess.run([sys.executable, "-W", "ignore", "-c", textwrap.dedent(script)],
                             capture_output=True, text=True, timeout=timeout, env=env(devices),
                             cwd=REPO)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr[-6000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])
