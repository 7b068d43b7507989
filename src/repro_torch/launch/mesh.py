"""Mesh builders (counterpart of `repro/launch/mesh.py`).

A mesh names its axes and their sizes: ``("data", "model")`` on one pod,
``("pod", "data", "model")`` across pods (`sharding.rules`). Two kinds:

  * `make_abstract_mesh` — axis names and sizes only, no process group
    and no device, as the reference's `AbstractMesh`. The sharding rules
    take it to compute placements for any size (16x16, 2x16x16).
  * `make_host_mesh` / `make_production_mesh` — a
    `torch.distributed.device_mesh.DeviceMesh` over the default process
    group, one rank a device: the world size must equal the mesh's size.

Nothing here initialises a process group: the caller starts the world
(`torch.distributed.init_process_group` with a `FileStore` or a
`HashStore`, one process a rank) and builds the mesh in every rank.
Importing this module touches no process group and no device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device


def _validate_axes(shape: tuple, axes: tuple) -> None:
    """Reject malformed mesh requests up front, naming the bad axis: the
    sharding rules key on axis names and divide by axis sizes."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                         "in length")
    seen = set()
    for name, size in zip(axes, shape):
        if name in seen:
            raise ValueError(f"duplicate mesh axis name {name!r} in {axes}")
        seen.add(name)
        if not isinstance(size, int) or size < 1:
            raise ValueError(f"mesh axis {name!r} has non-positive size "
                             f"{size!r}; every axis needs an int >= 1")


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, with no process group and no device."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_abstract_mesh(shape: tuple, axes: tuple) -> AbstractMesh:
    """An `AbstractMesh` of `shape` over the axis names `axes`."""
    _validate_axes(tuple(shape), tuple(axes))
    return AbstractMesh(tuple(axes), tuple(shape))


def _world_size() -> int:
    """Ranks of the default process group; 0 when none is initialised."""
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 0)


def _device_mesh(shape: tuple, axes: tuple, device, what: str):
    """A DeviceMesh of `shape` over the default group's ranks in order."""
    _validate_axes(shape, axes)
    dev = resolve_device(device)
    n, world = math.prod(shape), _world_size()
    if n != world:
        have = (f"the default process group has {world} ranks" if world
                else "no process group is initialised")
        raise ValueError(
            f"{what} needs a world of {n} ranks but {have}; start a world "
            f"of {n} ranks (torch.distributed.init_process_group with a "
            "FileStore or HashStore, one process a rank) before building "
            "the mesh")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = DEFAULT_DEVICE):
    """16x16 = 256 ranks on one pod; 2x16x16 = 512 ranks across two pods.
    The world must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device,
                        f"make_production_mesh(multi_pod={multi_pod})")


def data_parallel_size(mesh) -> int:
    """Total extent of the client/data axes ('pod' x 'data' on multi-pod):
    the shard count of MemoryBank rows and the MIFA update array.
    Delegates to `sharding.rules`, so mesh helpers and partition rules
    cannot diverge."""
    from repro_torch.sharding.rules import data_axis_size
    return data_axis_size(mesh)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: str | torch.device = DEFAULT_DEVICE):
    """A small ("data", "model") DeviceMesh over the default process group,
    whose world must have data·model ranks. `device="cpu"` for a gloo
    world of CPU processes; "cuda" raises without a GPU."""
    return _device_mesh((data, model), ("data", "model"), device,
                        f"make_host_mesh({data}, {model})")
