"""Kubernetes GPU backend: the port's counterpart of the JAX package's
Kubernetes backend (`repro/core/backends/kubernetes.py`, paper §III-E,
cloud deployment), as `slurm_gpu.py` is of its Cloud-TPU backend.

The Syndeo cluster comes up by the reference's manifests, line for line: a
head Service and Pod, a worker Deployment, a HorizontalPodAutoscaler on the
scheduler's demand signals and the custom-metrics adapter that serves them,
every pod `runAsNonRoot` with the `syndeo-shared` claim mounted as the
rendezvous. What changes for the cards: each worker pod asks for
`nvidia.com/gpu: G` (`req.gpus_per_node`), which the NVIDIA device plugin
schedules and exposes to the container. Elasticity stays declarative:
`provision_workers` / `release_workers` only move the HPA's floor, never
`kubectl scale`.

The port's training job is an indexed Job, `ranks_<id>.yaml`: one pod a
node, `completions` = `parallelism` = `req.nodes`, each with G cards,
running `rank_<id>.sh` from the shared claim, where it is staged as
`slurm_gpu.py` stages its scripts. That script starts the node's G ranks of
`repro_torch.launch.rank`: global rank `JOB_COMPLETION_INDEX * G + i` of
`nodes * G` (node-major, as Slurm's `SLURM_PROCID`), local rank i. The
ranks meet at a store named by the Job's UID (the pod label
`batch.kubernetes.io/controller-uid`, through the downward API), which is
new at every creation of the Job, so a relaunch never opens a store a
killed Job left behind.

The pod's shell is PID 1, and an eviction signals only it: the script
forwards SIGTERM to its ranks, which agree on a step, checkpoint it and exit
EXIT_PREEMPTED (75). The shell exits 75 when every rank did, else with the
first other non-zero code (and ends its remaining ranks `STEP_WAIT_S` after
a rank fails, where a collective's own timeout would take 30 min). The
Job's `podFailurePolicy` ends it at once on 75, with the rule's reason
(`PodFailurePolicy`) rather than a crash's: the Job is not retried in
place, since a pod made again inside it would carry the same UID. The
relaunch is a new Job (`kubectl delete` and `kubectl apply` the same
manifest), which resumes from the last checkpoint under
`<shared>/ckpt/<cluster_id>`.

`name` is "kubernetes", so the shared autoscaler's `for_backend(name)`
gives Kubernetes's cooldowns.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.backends.base import AllocationRequest, Backend
from repro_torch.backends.slurm_gpu import EXIT_PREEMPTED, STEP_WAIT_S

# seconds a rank pod has, after SIGTERM, to finish its step and commit the
# checkpoint the ranks agree on, before the kubelet sends SIGKILL (llama3-8b's
# full state on one node, 96 GB of params and AdamW moments, at ~1 GB/s to a
# shared volume, with room for the step)
STOP_GRACE_S = 600
# the pod label that carries the Job's UID (Kubernetes >= 1.27)
JOB_UID_LABEL = "batch.kubernetes.io/controller-uid"


def _yaml_list(items: Sequence[str]) -> str:
    """A YAML flow list of strings, each double-quoted."""
    return "[" + ", ".join('"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
                           for s in items) + "]"


class KubernetesGpuBackend(Backend):
    name = "kubernetes"
    supports_elastic = True

    @staticmethod
    def _gpus(req: AllocationRequest) -> int:
        if req.gpus_per_node < 1:
            raise ValueError("the Kubernetes GPU backend needs gpus_per_node >= 1")
        return req.gpus_per_node

    def _image(self) -> str:
        return self.container.image.replace(".sif", ":latest")

    def render_artifacts(self, req: AllocationRequest,
                         cluster_id: str) -> Dict[str, str]:
        gpus = self._gpus(req)
        image = self._image()
        manifest = f"""\
apiVersion: v1
kind: Service
metadata:
  name: syndeo-head-{cluster_id}
spec:
  selector:
    app: syndeo-{cluster_id}
    role: head
  ports:
  - port: 6379
---
apiVersion: v1
kind: Pod
metadata:
  name: syndeo-head-{cluster_id}
  labels: {{app: syndeo-{cluster_id}, role: head}}
spec:
  securityContext:
    runAsNonRoot: true            # the Apptainer principle, K8s-enforced
    runAsUser: 1000
  containers:
  - name: head
    image: {image}
    command: ["{self.container.entrypoint.split()[0]}"]
    args: ["-m", "repro.core.worker", "--role", "head",
           "--rendezvous", "{req.shared_dir}", "--cluster-id", "{cluster_id}"]
    resources:
      requests: {{cpu: "{req.cpus_per_node}"}}
    volumeMounts:
    - name: rdv
      mountPath: {req.shared_dir}
  volumes:
  - name: rdv
    persistentVolumeClaim: {{claimName: syndeo-shared}}
---
apiVersion: apps/v1
kind: Deployment
metadata:
  name: syndeo-workers-{cluster_id}
spec:
  replicas: {req.nodes - 1}
  selector:
    matchLabels: {{app: syndeo-{cluster_id}, role: worker}}
  template:
    metadata:
      labels: {{app: syndeo-{cluster_id}, role: worker}}
    spec:
      securityContext:
        runAsNonRoot: true
        runAsUser: 1000
      containers:
      - name: worker
        image: {image}
        command: ["{self.container.entrypoint.split()[0]}"]
        # --blob-host: the p2p blob server advertises the pod IP (downward
        # API), so peer workers dial this pod instead of their own loopback
        args: ["-m", "repro.core.worker", "--role", "worker",
               "--rendezvous", "{req.shared_dir}", "--cluster-id", "{cluster_id}",
               "--blob-host", "$(POD_IP)"]
        env:
        - name: POD_IP
          valueFrom: {{fieldRef: {{fieldPath: status.podIP}}}}
        resources:
          requests: {{cpu: "{req.cpus_per_node}"}}
          limits: {{nvidia.com/gpu: {gpus}}}
        volumeMounts:
        - name: rdv
          mountPath: {req.shared_dir}
      volumes:
      - name: rdv
        persistentVolumeClaim: {{claimName: syndeo-shared}}
"""
        return {f"syndeo_{cluster_id}.yaml": manifest,
                f"syndeo_hpa_{cluster_id}.yaml":
                    self._hpa_manifest(req, cluster_id),
                f"syndeo_metrics_adapter_{cluster_id}.yaml":
                    self._metrics_adapter_manifest(req, cluster_id),
                f"ranks_{cluster_id}.yaml": self.ranks_job(req, cluster_id),
                f"rank_{cluster_id}.sh": self._rank_script(req, cluster_id)}

    def ranks_job(self, req: AllocationRequest, cluster_id: str,
                  job_args: Sequence[str] = ()) -> str:
        """The indexed Job of the port's ranks: a pod a node, each running
        `rank_<id>.sh` from the shared claim with `job_args` (`--arch`,
        `--mesh`, `--steps`, ...; `render_artifacts` renders none, so the
        rank's defaults)."""
        gpus = self._gpus(req)
        return f"""\
apiVersion: batch/v1
kind: Job
metadata:
  name: syndeo-ranks-{cluster_id}
  labels: {{app: syndeo-{cluster_id}, role: ranks}}
spec:
  # a pod a node, all at once; JOB_COMPLETION_INDEX is the node
  completionMode: Indexed
  completions: {req.nodes}
  parallelism: {req.nodes}
  backoffLimit: 0
  podFailurePolicy:
    rules:
    # {EXIT_PREEMPTED}: every rank stopped at one step once its checkpoint
    # committed. A preemption, not a crash: the Job ends at once under this
    # rule, and a new Job (a new UID, so a new store) resumes from the
    # checkpoint; a pod made again inside this Job would meet at the store
    # its stopped ranks shared
    - action: FailJob
      onExitCodes:
        containerName: rank
        operator: In
        values: [{EXIT_PREEMPTED}]
  template:
    metadata:
      labels: {{app: syndeo-{cluster_id}, role: ranks}}
    spec:
      restartPolicy: Never
      # SIGTERM, then this long for the step and the checkpoint to commit
      terminationGracePeriodSeconds: {STOP_GRACE_S}
      securityContext:
        runAsNonRoot: true
        runAsUser: 1000
      containers:
      - name: rank
        image: {self._image()}
        command: ["bash", "{req.shared_dir}/rank_{cluster_id}.sh"]
        args: {_yaml_list(job_args)}
        env:
        - name: JOB_UID
          valueFrom: {{fieldRef: {{fieldPath: "metadata.labels['{JOB_UID_LABEL}']"}}}}
        resources:
          requests: {{cpu: "{req.cpus_per_node}"}}
          limits: {{nvidia.com/gpu: {gpus}}}
        volumeMounts:
        - name: rdv
          mountPath: {req.shared_dir}
        - name: shm
          mountPath: /dev/shm
      volumes:
      - name: rdv
        persistentVolumeClaim: {{claimName: syndeo-shared}}
      # NCCL's intra-node buffers: more than the container's 64 MiB default
      - name: shm
        emptyDir: {{medium: Memory}}
"""

    def _rank_script(self, req: AllocationRequest, cluster_id: str) -> str:
        gpus = self._gpus(req)
        return f"""\
#!/bin/bash
# One node's ranks of the port's training job, as a pod of
# ranks_{cluster_id}.yaml runs it: {gpus} ranks, a card each; rank i is
# global rank JOB_COMPLETION_INDEX * {gpus} + i of {req.nodes * gpus}, node-major.
# The store is named by the Job's UID (JOB_UID, from the pod's label
# {JOB_UID_LABEL}), new at every creation of the Job. By
# hand on one machine: set JOB_COMPLETION_INDEX, JOB_UID (anew for each
# launch) and PYTHONPATH to the sources, and run this once a node.
# This shell is the pod's PID 1, and an eviction signals only it: SIGTERM
# goes on to every rank, and the ranks stop together at a checkpointed step
# and exit {EXIT_PREEMPTED}. Exits {EXIT_PREEMPTED} when every rank did, else with the first
# other non-zero code; a failed rank's node mates are ended {STEP_WAIT_S} s after it.
set -uo pipefail
: "${{JOB_COMPLETION_INDEX:?the node, set by the indexed Job}}"
: "${{JOB_UID:?the Job's UID, set from the pod's label}}"
running=()
forward() {{ [ "${{#running[@]}}" -eq 0 ] || kill -TERM "${{running[@]}}" 2>/dev/null; }}
trap forward TERM
for ((i = 0; i < {gpus}; i++)); do
    python3 -m repro_torch.launch.rank --rendezvous {req.shared_dir} \\
        --cluster-id {cluster_id} --job-id "k8s-$JOB_UID" \\
        --rank $((JOB_COMPLETION_INDEX * {gpus} + i)) --world {req.nodes * gpus} \\
        --local-rank "$i" "$@" &
    running+=("$!")
done
first="" preempted=0 timer=""
while [ "${{#running[@]}}" -gt 0 ]; do
    unset pid
    wait -n -p pid "${{running[@]}}" $timer
    code=$?
    [ -n "${{pid:-}}" ] || continue   # the trap ended the wait, not a rank
    if [ "$pid" = "$timer" ]; then   # a rank failed {STEP_WAIT_S} s ago
        kill -KILL "${{running[@]}}" 2>/dev/null
        timer=""
        continue
    fi
    rest=()
    for p in "${{running[@]}}"; do [ "$p" = "$pid" ] || rest+=("$p"); done
    running=("${{rest[@]+"${{rest[@]}}"}}")
    [ "$code" != {EXIT_PREEMPTED} ] || preempted=$((preempted + 1))
    if [ "$code" != 0 ] && [ "$code" != {EXIT_PREEMPTED} ] && [ -z "$first" ]; then
        first=$code
        if [ "${{#running[@]}}" -gt 0 ]; then
            sleep {STEP_WAIT_S} >/dev/null 2>&1 &
            timer=$!
        fi
    fi
done
[ -z "$timer" ] || kill "$timer" 2>/dev/null
[ -z "$first" ] || exit "$first"
[ "$preempted" = 0 ] || exit {EXIT_PREEMPTED}
exit 0
"""

    def _hpa_manifest(self, req: AllocationRequest, cluster_id: str) -> str:
        """HorizontalPodAutoscaler on the scheduler's demand signals: the
        declarative twin of AutoscalerConfig's queue-depth and
        target-utilization policies (backlog per worker ~ 2, busy fraction
        ~ 0.75)."""
        return f"""\
apiVersion: autoscaling/v2
kind: HorizontalPodAutoscaler
metadata:
  name: syndeo-workers-{cluster_id}
spec:
  scaleTargetRef:
    apiVersion: apps/v1
    kind: Deployment
    name: syndeo-workers-{cluster_id}
  minReplicas: 1
  maxReplicas: {max(req.nodes * 4, req.nodes)}
  metrics:
  # READY+PENDING backlog per worker, from the head's stats op via the
  # custom-metrics adapter (queue_depth_per_worker policy, target 2)
  - type: Pods
    pods:
      metric:
        name: syndeo_backlog_per_worker
      target:
        type: AverageValue
        averageValue: "2"
  # busy-worker fraction (target_utilization policy, target 0.75 == 750m)
  - type: Pods
    pods:
      metric:
        name: syndeo_busy_fraction
      target:
        type: AverageValue
        averageValue: "750m"
  behavior:
    scaleDown:
      # the head drains pods (migrating hot objects) before they die, so
      # give the drain plane time between downscale steps
      stabilizationWindowSeconds: 120
      policies:
      - type: Pods
        value: 8
        periodSeconds: 60
    scaleUp:
      policies:
      - type: Pods
        value: 16
        periodSeconds: 15
"""

    def _metrics_adapter_manifest(self, req: AllocationRequest,
                                  cluster_id: str) -> str:
        """Custom-metrics adapter: a small deployment that polls the head's
        HMAC-authenticated `stats` op and serves the two scheduler signals
        under custom.metrics.k8s.io for the HPA to consume."""
        image = self._image()
        return f"""\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: syndeo-metrics-adapter-{cluster_id}
spec:
  replicas: 1
  selector:
    matchLabels: {{app: syndeo-{cluster_id}, role: metrics-adapter}}
  template:
    metadata:
      labels: {{app: syndeo-{cluster_id}, role: metrics-adapter}}
    spec:
      securityContext:
        runAsNonRoot: true
        runAsUser: 1000
      containers:
      - name: adapter
        image: {image}
        # polls the head's sealed `metrics` op (scheduler backlog, busy
        # fraction, tenant shares) and republishes it as custom metrics.
        # API aggregation dials the adapter over TLS, so it serves HTTPS
        # with the mounted serving cert (Secret syndeo-metrics-serving-cert,
        # e.g. issued by cert-manager or the cluster CA).
        command: ["python"]
        args: ["-m", "repro.core.metrics_adapter",
               "--rendezvous", "{req.shared_dir}",
               "--cluster-id", "{cluster_id}",
               "--metrics",
               "syndeo_backlog_per_worker,syndeo_busy_fraction",
               "--tls-cert", "/var/run/serving-cert/tls.crt",
               "--tls-key", "/var/run/serving-cert/tls.key"]
        volumeMounts:
        - name: rdv
          mountPath: {req.shared_dir}
        - name: serving-cert
          mountPath: /var/run/serving-cert
          readOnly: true
      volumes:
      - name: rdv
        persistentVolumeClaim: {{claimName: syndeo-shared}}
      - name: serving-cert
        secret: {{secretName: syndeo-metrics-serving-cert}}
---
apiVersion: v1
kind: Service
metadata:
  name: syndeo-metrics-adapter-{cluster_id}
spec:
  selector:
    app: syndeo-{cluster_id}
    role: metrics-adapter
  ports:
  - port: 443
    targetPort: 6443
---
apiVersion: apiregistration.k8s.io/v1
kind: APIService
metadata:
  name: v1beta1.custom.metrics.k8s.io
spec:
  service:
    name: syndeo-metrics-adapter-{cluster_id}
    namespace: default
  group: custom.metrics.k8s.io
  version: v1beta1
  insecureSkipTLSVerify: true
  groupPriorityMinimum: 100
  versionPriority: 100
"""

    # -- elasticity: nudge the HPA floor (declarative; never kubectl scale) ----

    def provision_workers(self, req: AllocationRequest, cluster_id: str,
                          count: int) -> Dict[str, str]:
        hpa = f"syndeo-workers-{cluster_id}"
        script = f"""\
#!/bin/bash
set -euo pipefail
# elastic scale-up: raise the HPA's replica floor by {count}. The HPA (fed
# by the scheduler's backlog/utilization custom metrics) owns the actual
# replica count -- the floor only guarantees the capacity the inner
# autoscaler asked for arrives even while metrics are still catching up.
CUR=$(kubectl get hpa {hpa} -o jsonpath='{{.spec.minReplicas}}')
MAX=$(kubectl get hpa {hpa} -o jsonpath='{{.spec.maxReplicas}}')
NEW=$((CUR + {count})); [ "$NEW" -le "$MAX" ] || NEW=$MAX
kubectl patch hpa {hpa} --type merge \\
  -p "{{\\"spec\\":{{\\"minReplicas\\":$NEW}}}}"
"""
        return {f"scale_up_{cluster_id}_{count}.sh": script}

    def release_workers(self, req: AllocationRequest, cluster_id: str,
                        worker_ids: List[str],
                        drain_deadline_s: float = 0.0) -> Dict[str, str]:
        hpa = f"syndeo-workers-{cluster_id}"
        # worker id == pod hostname == pod name in this backend (the worker
        # process registers under its hostname)
        annotates = "\n".join(
            f"kubectl annotate pod {wid} "
            f"controller.kubernetes.io/pod-deletion-cost=-999 "
            f"--overwrite || true"
            for wid in worker_ids)
        grace = int(drain_deadline_s) if drain_deadline_s > 0 else 0
        # pod deletion is asynchronous through the HPA: its scaleDown
        # stabilization window is 120s (see _hpa_manifest), so the wait
        # must cover window + drain grace before giving up
        wait_s = grace + 180
        script = f"""\
#!/bin/bash
set -euo pipefail
# graceful scale-down: the scheduler already drained these pods (no new
# placements, hot objects migrated). Mark them cheapest to delete, then
# lower the HPA floor -- with the demand metrics already low the HPA
# shrinks the Deployment after its 120s stabilization window and the
# ReplicaSet controller removes exactly the marked pods, each with a
# {grace}s termination grace for anything still exiting.
{annotates}
CUR=$(kubectl get hpa {hpa} -o jsonpath='{{.spec.minReplicas}}')
NEW=$((CUR - {len(worker_ids)})); [ "$NEW" -ge 1 ] || NEW=1
kubectl patch hpa {hpa} --type merge \\
  -p "{{\\"spec\\":{{\\"minReplicas\\":$NEW}}}}"
# sleep {grace}s drain grace first: a drained worker that self-exits early
# would otherwise be restarted by the ReplicaSet before the HPA shrinks
sleep {grace}
kubectl wait --for=delete {' '.join(f'pod/{wid}' for wid in worker_ids)} \\
  --timeout={wait_s}s || true
"""
        return {f"scale_down_{cluster_id}.sh": script}
