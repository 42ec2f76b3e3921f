"""The container a GPU allocation runs: the port's own copies of the JAX
package's `ContainerSpec` (`repro/core/cluster.py`) and of its Apptainer
renderers (`repro/core/containers.py`), changed for NVIDIA cards.

Builds are root-privileged and happen on a development machine; the cluster
only ever *runs* the immutable image as an unprivileged user process, as in
the reference. What changes for the cards:

  * the run command passes `--nv` when the allocation has GPUs, which binds
    the host's NVIDIA driver into the unprivileged container (no
    `--privileged`; `--writable-tmpfs` as before);
  * the base image carries CUDA, `nvcc` and a CUDA build of torch (NVIDIA's
    PyTorch image by default);
  * `%post` builds the port's kernels into the image. They build at first
    use into `build/kernels/` at the repository root
    (`repro_torch/kernels/build.py`), which in the image is
    `/opt/syndeo/build/kernels`, read-only at run time: built at `%post`
    (which needs `nvcc`, not a card), every rank loads them from there,
    instead of each compiling into its tmpfs at every start;
  * no `pip install`: `pyproject.toml` declares no package, so the image
    runs the sources from `PYTHONPATH`, as the reference's `%environment`
    sets it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

CUDA_BASE = "docker://nvcr.io/nvidia/pytorch:25.01-py3"


@dataclass(frozen=True)
class ContainerSpec:
    """What every node must have a copy of (paper phase 1)."""
    image: str = "syndeo.sif"
    base: str = CUDA_BASE
    env: Dict[str, str] = field(default_factory=dict)
    binds: List[str] = field(default_factory=list)     # host:container
    sandbox_writable: bool = True                       # Apptainer --writable-tmpfs
    entrypoint: str = "python -m repro.core.worker"


def apptainer_definition(spec: ContainerSpec) -> str:
    env_lines = "\n".join(f"    export {k}={v}" for k, v in spec.env.items())
    return f"""\
Bootstrap: docker
From: {spec.base.removeprefix('docker://')}

%files
    src /opt/syndeo/src
    pyproject.toml /opt/syndeo/pyproject.toml

%post
    # the port's CUDA kernels are built here, into the image
    # (/opt/syndeo/build/kernels): nvcc needs no card, and every rank then
    # loads them read-only instead of compiling at each start
    cd /opt/syndeo && PYTHONPATH=/opt/syndeo/src python -c \\
        "from repro_torch.kernels import build; build.build()"
    # containers are immutable after build; runtime writes go to the
    # sandbox tmpfs (--writable-tmpfs) and the bound scratch dir only

%environment
    export PYTHONPATH=/opt/syndeo/src
{env_lines}

%runscript
    exec {spec.entrypoint} "$@"
"""


def apptainer_exec(spec: ContainerSpec, *, rendezvous_dir: str, gpus: int = 0) -> str:
    """`apptainer exec` of the image with the rendezvous directory and the
    spec's binds, `--nv` where the node has GPUs."""
    binds = " ".join(f"--bind {b}" for b in
                     ([f"{rendezvous_dir}:{rendezvous_dir}"] + list(spec.binds)))
    nv = "--nv " if gpus > 0 else ""
    writable = "--writable-tmpfs" if spec.sandbox_writable else ""
    return f"apptainer exec {nv}{writable} {binds} {spec.image}"


def apptainer_run_command(spec: ContainerSpec, *, role: str, rendezvous_dir: str,
                          cluster_id: str, gpus: int = 0) -> str:
    return (f"{apptainer_exec(spec, rendezvous_dir=rendezvous_dir, gpus=gpus)} "
            f"{spec.entrypoint} --role {role} "
            f"--rendezvous {rendezvous_dir} --cluster-id {cluster_id}")
