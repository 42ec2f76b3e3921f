"""The port's deployment backends: its own copies of the JAX package's
`AllocationRequest`, `Backend` and `ContainerSpec`, and the Slurm and
Kubernetes GPU backends that render a Syndeo cluster and the port's
training ranks on H100 nodes."""
from repro_torch.backends.base import AllocationRequest, Backend
from repro_torch.backends.containers import ContainerSpec
from repro_torch.backends.kubernetes_gpu import KubernetesGpuBackend
from repro_torch.backends.slurm_gpu import EXIT_PREEMPTED, SlurmGpuBackend

__all__ = ["AllocationRequest", "Backend", "ContainerSpec", "EXIT_PREEMPTED",
           "KubernetesGpuBackend", "SlurmGpuBackend"]
