"""Device meshes, the port of the JAX package's `launch/mesh.py`.

`make_mesh` lays the ranks of the initialised process group out as a mesh
with named axes (`torch.distributed.device_mesh.init_device_mesh`,
row-major). `Mesh(shape, axis_names)` without a device mesh is an abstract
mesh: enough for the sharding rules (`sharding/`), which read only the axis
names and sizes, as the reference's read `mesh.axis_names` and
`mesh.devices.shape`.

`make_production_mesh` gives the dry-run's (`launch/dryrun.py`) abstract
meshes of H100s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch.distributed as dist

from repro_torch.device import resolve_device

DP_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device_mesh: Optional[Any] = None   # a DeviceMesh over the process group

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def group(self, axis: str):
        """The process group of the ranks that differ only along `axis`."""
        return self.device_mesh.get_group(axis)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract production mesh: one node's four H100s, (4, 1) over
    ("data", "model"), or with `multi_pod` two such nodes, (2, 4, 1) over
    ("pod", "data", "model"). Not the reference's 16x16 and 2x16x16 TPU
    meshes: those put 16 ways of tensor parallelism on "model", and the
    port runs none (`dp_group`), so its meshes are data-parallel only."""
    if multi_pod:
        return Mesh((2, 4, 1), ("pod", "data", "model"))
    return Mesh((4, 1), ("data", "model"))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device="cuda") -> Mesh:
    """A mesh over every rank of the initialised process group (the tests'
    small meshes, e.g. (2, 1) over ("data", "model"))."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the group has {dist.get_world_size()}")
    return Mesh(tuple(shape), tuple(axes),
                init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes)))


def dp_degree(mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return sizes.get("data", 1) * sizes.get("pod", 1)


def dp_group(mesh):
    """The process group over the mesh's data-parallel axes ("pod", "data").
    The port runs no tensor parallelism, so every other axis must have size
    1, and the group is every rank of the mesh: the default group."""
    extra = {a: n for a, n in zip(mesh.axis_names, mesh.shape) if a not in DP_AXES and n > 1}
    if extra:
        raise ValueError(f"axes {extra} are not data-parallel: the port runs no tensor "
                         "parallelism")
    return dist.group.WORLD
