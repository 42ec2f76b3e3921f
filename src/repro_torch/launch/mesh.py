"""Device meshes, the port of the JAX package's `launch/mesh.py`.

`make_mesh` lays the ranks of the initialised process group out as a mesh
with named axes (`torch.distributed.device_mesh.init_device_mesh`,
row-major). `Mesh(shape, axis_names)` without a device mesh is an abstract
mesh: enough for the sharding rules (`sharding/`), which read only the axis
names and sizes, as the reference's read `mesh.axis_names` and
`mesh.devices.shape`.

`make_production_mesh` gives the dry-run's (`launch/dryrun.py`) abstract
meshes of H100s.

`dp_group` and `tp_group` are the process groups of the data-parallel axes
and of the "model" axis (tensor parallelism, `models/tensor_parallel.py`);
`group_over` that of any of its axes (FSDP's gathers and the experts'
all-to-all, `models/data_parallel.py`).
On a mesh whose other axes have size 1 the group is every rank of the
process group, so an abstract mesh has one too (the dry-run's, over its
fake process group).
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
    meshes, which put 16 ways of tensor parallelism on "model": the dry-run
    adds the tensor-parallel (1, 4) and the (2, 4) of one 8-card node
    (`launch/dryrun.py::MESHES`), on which the port trains and serves over
    both axes (`models/tensor_parallel.py`, `models/data_parallel.py`)."""
    if multi_pod:
        return Mesh((2, 4, 1), ("pod", "data", "model"))
    return Mesh((4, 1), ("data", "model"))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device="cuda") -> Mesh:
    """A mesh over every rank of the initialised process group (the tests'
    small meshes, e.g. (2, 1) over ("data", "model"); under the dry-run's
    fake process group, an abstract mesh's groups, with device "cpu")."""
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


def tp_degree(mesh) -> int:
    return dict(zip(mesh.axis_names, mesh.shape)).get("model", 1)


def group_over(mesh, axes: Tuple[str, ...]):
    """The process group of the ranks that differ only along `axes`: every
    rank when the mesh's other axes have size 1, else the device mesh's
    group of those axes (flattened where two have size > 1)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if all(n == 1 for a, n in sizes.items() if a not in axes):
        return dist.group.WORLD
    if mesh.device_mesh is None:
        raise ValueError(f"an abstract {mesh.shape} mesh has no process group over {axes}")
    live = tuple(a for a in mesh.axis_names if a in axes and sizes[a] > 1)
    if len(live) == 1:
        return mesh.group(live[0])
    return mesh.device_mesh[live]._flatten().get_group()


def dp_group(mesh):
    """The process group over the mesh's data-parallel axes ("pod", "data"),
    or None where they have size 1 under a "model" axis: no rank shares a
    data-parallel group with another."""
    if dp_degree(mesh) == 1 and tp_degree(mesh) > 1:
        return None
    return group_over(mesh, DP_AXES)


def tp_group(mesh):
    """The process group over the mesh's "model" axis, or None where it has
    size 1."""
    if tp_degree(mesh) == 1:
        return None
    return group_over(mesh, ("model",))
