"""Slurm GPU backend: the port's counterpart of the JAX package's Cloud-TPU
backend (`repro/core/backends/gcp_tpu.py`), which gang-allocates accelerator
hosts and starts the Syndeo worker and the framework's distributed
bootstrap on each.

The outer scheduler is Slurm with H100 nodes (`--gres=gpu:h100:G`). The
Syndeo cluster comes up inside the allocation by the reference Slurm
backend's protocol, line for line (`repro/core/backends/slurm.py`, §III-D):
node 0 starts the containerized head and writes its endpoint to the shared
filesystem; every other node polls it and joins as a worker under its
hostname, recording the id -> host mapping for scale-down; scale-up is a
worker-only job under `--dependency=singleton`; scale-down drains hosts
resolved through the mapping. The containers run with `--nv`.

The port's training job runs as one more step of the allocation,
`ranks_<id>.sh`: one `srun` task a card on every node, each in the
container running `rank_<id>.sh`, which starts `repro_torch.launch.rank`
with its Slurm identity (`SLURM_PROCID`, node-major, is the global rank).
The ranks meet at a store in the shared directory, named by cluster, job,
step and restart, decide the backend from the cards they hold, and train
on a (nodes, gpus) mesh, with the "model" axis inside a node. The job's own arguments
(`--arch`, `--layers`, `--mesh`, `--steps`, `--device`, ...) pass through
both scripts, so `render_artifacts(req, cluster_id)` keeps the reference's
signature. The same step serves instead of training with the serving
arguments: `bash ranks_<id>.sh --serve --requests R.jsonl --outputs
O.jsonl --mesh <nodes>x1` runs a replica a node behind the router on rank
0 (`launch/serve.py`); a replica whose rank is preempted is retired and
its ranks exit 75 while the others serve on.

`name` is "slurm", so the shared autoscaler's `for_backend(name)` gives
Slurm's cooldowns. Like the reference's Slurm and TPU backends, this one
has no `preempt_workers`: Slurm's own preemption sends SIGTERM to every
task, and the ranks agree on the step to stop at
(`repro_torch/train/trainer.py`).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.backends.base import AllocationRequest, Backend
from repro_torch.backends.containers import (apptainer_definition, apptainer_exec,
                                             apptainer_run_command)

# the exit code of a rank that stopped on preemption after checkpointing
# (EX_TEMPFAIL: the job is to be resubmitted, and resumes from the checkpoint)
EXIT_PREEMPTED = 75
# seconds `ranks_<id>.sh`'s step gives the other ranks once one has exited
STEP_WAIT_S = 120


class SlurmGpuBackend(Backend):
    name = "slurm"
    supports_elastic = True

    @staticmethod
    def _gpus(req: AllocationRequest) -> int:
        if req.gpus_per_node < 1:
            raise ValueError("the Slurm GPU backend needs gpus_per_node >= 1")
        return req.gpus_per_node

    def _worker_cmd(self, req: AllocationRequest, cluster_id: str) -> str:
        # Syndeo worker id == Slurm NodeName: workers join under $(hostname)
        # and record the mapping under the rendezvous, so scale-down can
        # resolve the scheduler's worker ids back to drainable hosts.
        # --blob-host: the p2p blob server must advertise the node's
        # fabric address, not the 127.0.0.1 default, or peers dial their
        # own loopback
        return (apptainer_run_command(self.container, role="worker",
                                      rendezvous_dir=req.shared_dir,
                                      cluster_id=cluster_id, gpus=self._gpus(req))
                + ' --worker-id "$(hostname)"'
                + ' --blob-host "$(hostname -i | cut -d\' \' -f1)"')

    def render_artifacts(self, req: AllocationRequest,
                         cluster_id: str) -> Dict[str, str]:
        gpus = self._gpus(req)
        head_cmd = apptainer_run_command(self.container, role="head",
                                         rendezvous_dir=req.shared_dir,
                                         cluster_id=cluster_id, gpus=gpus)
        worker_cmd = self._worker_cmd(req, cluster_id)
        record_host = (f'echo "$(hostname)" > '
                       f'"{req.shared_dir}/rdv/workers/$(hostname).host"')
        reservation = (f"#SBATCH --reservation={req.reservation}\n"
                       if req.reservation else "")
        sbatch = f"""\
#!/bin/bash
#SBATCH --job-name=syndeo-{cluster_id}
#SBATCH --nodes={req.nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --cpus-per-task={req.cpus_per_node}
#SBATCH --gres=gpu:h100:{gpus}
#SBATCH --time={req.walltime}
#SBATCH --partition={req.partition}
{reservation}#SBATCH --output={req.shared_dir}/logs/%j_%n.out

set -euo pipefail
mkdir -p {req.shared_dir}/logs {req.shared_dir}/rdv {req.shared_dir}/rdv/workers
{record_host}

# ---- phase 1: every node already has a copy of the container ----
# (image staged to {req.shared_dir} before submission; immutable at runtime)

NODELIST=$(scontrol show hostnames "$SLURM_JOB_NODELIST")
HEAD_NODE=$(echo "$NODELIST" | head -n1)

if [ "$(hostname)" = "$HEAD_NODE" ]; then
    # ---- phase 2: start the Ray-equivalent head; endpoint -> shared FS ----
    {head_cmd} &
    HEAD_PID=$!
else
    # ---- phase 3: workers poll the shared FS for the head endpoint ----
    {worker_cmd} &
    HEAD_PID=$!
fi

# ---- phase 4: the cluster accepts jobs at the head ----
wait $HEAD_PID
"""
        srun_variant = f"""\
#!/bin/bash
# Alternative launcher: one srun step per role (heterogeneous jobs).
srun --nodes=1 --ntasks=1 -w "$HEAD_NODE" {head_cmd} &
srun --nodes={req.nodes - 1} --ntasks={req.nodes - 1} {worker_cmd} &
wait
"""
        rank_script = f"rank_{cluster_id}.sh"
        container = apptainer_exec(self.container, rendezvous_dir=req.shared_dir, gpus=gpus)
        ranks = f"""\
#!/bin/bash
# The port's training job as one step of the allocation: a task a card on
# every node, each in the container (--nv) running {rank_script}, global
# ranks node-major. Stage the artifacts in {req.shared_dir}, which the
# container binds, and run this inside the allocation (or with
# SLURM_JOB_ID set to it); its arguments go to every rank, e.g.
#   bash ranks_{cluster_id}.sh --arch llama3-8b --mesh {req.nodes}x{gpus} --steps 1000
# --overlap: the step shares the nodes with the Syndeo head and workers.
# A rank exits {EXIT_PREEMPTED} when preempted: every rank stops at the same
# step once its checkpoint has committed, and none is killed for that exit
# (--kill-on-bad-exit=0); resubmit the step to resume. A rank that fails
# leaves the others in a collective: --wait ends them {STEP_WAIT_S} s after the
# first task exits, where the collectives' own timeout would take 30 min.
set -euo pipefail
srun --nodes={req.nodes} --ntasks-per-node={gpus} --gpus-per-task=1 --overlap \\
    --kill-on-bad-exit=0 --wait={STEP_WAIT_S} \\
    {container} bash {req.shared_dir}/{rank_script} "$@"
"""
        rank = f"""\
#!/bin/bash
# One rank of the port's training job, as ranks_{cluster_id}.sh starts it:
# SLURM_PROCID is the global rank, SLURM_NTASKS the world, SLURM_LOCALID
# the rank on its node. The store is named by job, step and restart, so a
# later step of the allocation, or a requeued job (same SLURM_JOB_ID),
# never meets at the store a killed step left behind. By hand on one
# machine: set those and SLURM_JOB_ID, PYTHONPATH to the sources, and run
# this once a rank (SLURM_STEP_ID anew for each launch).
set -euo pipefail
exec python3 -m repro_torch.launch.rank --rendezvous {req.shared_dir} \\
    --cluster-id {cluster_id} \\
    --job-id "$SLURM_JOB_ID.${{SLURM_STEP_ID:-0}}.${{SLURM_RESTART_COUNT:-0}}" \\
    --rank "$SLURM_PROCID" --world "$SLURM_NTASKS" --local-rank "$SLURM_LOCALID" "$@"
"""
        return {
            "syndeo.def": apptainer_definition(self.container),
            f"submit_{cluster_id}.sbatch": sbatch,
            f"srun_steps_{cluster_id}.sh": srun_variant,
            f"ranks_{cluster_id}.sh": ranks,
            rank_script: rank,
        }

    # -- elasticity: a worker-only sbatch joins the live rendezvous ------------

    def provision_workers(self, req: AllocationRequest, cluster_id: str,
                          count: int) -> Dict[str, str]:
        worker_cmd = self._worker_cmd(req, cluster_id)
        # guaranteed gang growth instead of hoping the partition has free
        # nodes: --dependency=singleton serializes scale-up jobs (all share
        # this job name), so bursts of autoscaler decisions queue in order
        # rather than racing each other for the same nodes, and an optional
        # standing --reservation pins the capacity the growth draws from.
        reservation = (f"#SBATCH --reservation={req.reservation}\n"
                       if req.reservation else "")
        scale_up = f"""\
#!/bin/bash
#SBATCH --job-name=syndeo-{cluster_id}-scaleup
#SBATCH --nodes={count}
#SBATCH --ntasks-per-node=1
#SBATCH --cpus-per-task={req.cpus_per_node}
#SBATCH --gres=gpu:h100:{self._gpus(req)}
#SBATCH --time={req.walltime}
#SBATCH --partition={req.partition}
#SBATCH --dependency=singleton
{reservation}#SBATCH --output={req.shared_dir}/logs/%j_%n.out

set -euo pipefail
# elastic scale-up: every node of this job joins the *existing* head via
# the shared-FS rendezvous (bring-up phase 3 only -- the head stays put),
# registering under its hostname so scale-down can find it again.
mkdir -p {req.shared_dir}/rdv/workers
echo "$(hostname)" > "{req.shared_dir}/rdv/workers/$(hostname).host"
{worker_cmd} &
wait
"""
        return {f"scale_up_{cluster_id}_{count}.sbatch": scale_up}

    def release_workers(self, req: AllocationRequest, cluster_id: str,
                        worker_ids: List[str],
                        drain_deadline_s: float = 0.0) -> Dict[str, str]:
        # Reconciliation: the scheduler names workers by *Syndeo worker id*;
        # Slurm drains by *NodeName*. Workers record id -> hostname under
        # the rendezvous at join (worker id is the hostname for nodes we
        # launched, but the mapping file is authoritative for any id), so
        # the rendered artifact resolves each id before touching Slurm --
        # it never drains the wrong host.
        resolves = "\n".join(
            f'HOSTS="$HOSTS,$(cat "$MAP/{wid}.host" 2>/dev/null '
            f'|| echo "{wid}")"'
            for wid in worker_ids)
        wait_step = (f"sleep {int(drain_deadline_s)}"
                     if drain_deadline_s > 0 else
                     ": # no drain grace requested (workers already drained)")
        scale_down = f"""\
#!/bin/bash
set -euo pipefail
# graceful scale-down: resolve Syndeo worker ids -> Slurm hostnames via the
# rendezvous mapping, mark those nodes DRAIN (no new Slurm work lands),
# give in-flight processes the drain grace, then cancel only the scale-up
# jobs running *on those hosts* (batches on other nodes keep running).
MAP={req.shared_dir}/rdv/workers
HOSTS=""
{resolves}
HOSTS=${{HOSTS#,}}
for HOST in ${{HOSTS//,/ }}; do
  scontrol update NodeName=$HOST State=DRAIN \\
    Reason="syndeo-{cluster_id} drained scale-down"
done
{wait_step}
scancel --name=syndeo-{cluster_id}-scaleup --nodelist=$HOSTS || true
"""
        return {f"scale_down_{cluster_id}.sh": scale_down}
