"""Backend interface, the port's own copy of the JAX package's
`repro/core/backends/base.py`: 'write code once and deploy anywhere'.

A backend knows how to (a) render the launch artifacts for its resource
manager and (b) bring the allocation up. The port's GPU backend renders
deployable artifacts (validated by tests), since no real cluster is
attached. The fields and the elasticity hooks are the reference's;
`gpus_per_node` is the field the GPU backend reads.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Dict, List

from repro_torch.backends.containers import ContainerSpec


@dataclass(frozen=True)
class AllocationRequest:
    nodes: int
    cpus_per_node: int = 28
    gpus_per_node: int = 0
    tpu_topology: str = ""           # e.g. "4x4x4" for TPU pods
    walltime: str = "04:00:00"
    partition: str = "normal"
    shared_dir: str = "/shared/syndeo"
    # Slurm: draw nodes from a standing reservation so elastic scale-up is
    # guaranteed capacity instead of hoping the partition has free nodes
    reservation: str = ""


class Backend(abc.ABC):
    name: str = "base"
    supports_elastic: bool = False   # provision/release hooks implemented

    def __init__(self, container: ContainerSpec):
        self.container = container

    @abc.abstractmethod
    def render_artifacts(self, req: AllocationRequest,
                         cluster_id: str) -> Dict[str, str]:
        """filename -> contents for everything this backend needs."""

    # -- elasticity hooks (driven by the shared autoscaler) ---------------------
    #
    # Render-only backends *render* the scale operation -- the artifacts that
    # grow or shrink the outer allocation -- because no real cluster is
    # attached.

    def provision_workers(self, req: AllocationRequest, cluster_id: str,
                          count: int) -> Dict[str, str]:
        """Grow the allocation by `count` workers that join the existing
        rendezvous. Returns filename -> contents of the scale-up artifacts."""
        raise NotImplementedError(f"{self.name} backend is not elastic")

    def release_workers(self, req: AllocationRequest, cluster_id: str,
                        worker_ids: List[str],
                        drain_deadline_s: float = 0.0) -> Dict[str, str]:
        """Shrink the allocation by retiring the named workers, already
        drained by the scheduler; `drain_deadline_s` is the grace the
        rendered artifact gives any process still wrapping up on the node
        before force-releasing it (0 = immediate)."""
        raise NotImplementedError(f"{self.name} backend is not elastic")

    def preempt_workers(self, req: AllocationRequest, cluster_id: str,
                        worker_ids: List[str],
                        notice_s: float = 30.0) -> Dict[str, str]:
        """Preemption notice: the resource manager WILL revoke these nodes
        `notice_s` from now, ready or not; the artifacts that schedule the
        revocation under that deadline."""
        raise NotImplementedError(f"{self.name} backend is not elastic")
