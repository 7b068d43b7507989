"""A client (or trial) axis split over a mesh's data ranks at run time.

`client_shard(mesh, n, device)` says which block of an axis of n rows this
rank holds: rows [lo, hi) of n / D, D the mesh's data extent
(`rules.data_axis_size`), block d for the rank at data coordinate d. The
ranks of one data group hold the blocks of one axis; ranks that differ
only in their `model` coordinate hold the same rows. Where there is
nothing to split it returns None, and the run is the unmeshed run, bit for
bit, with no collective:
  * data extent 1 (a 1x1 mesh, every mesh on one card);
  * D does not divide n: `rules.sanitize` replicates such an axis.

`ClientShard` reduces over the whole axis from the rank's block: `sum`
(over the axis), `total` (over every element), `all` — each the rank's
partial, all-reduced over the data group. The dense server steps take it
as `clients=`; `LOCAL` stands for a whole axis held on this rank with no
collective, the same calls each rank would make without a mesh. A shard
whose rows are whole (`group` None: only the param dims are split) reduces
as `LOCAL` does. Its `specs` and `mesh`, when set, say how the client
state's leaves are placed (`sharding.params.carry_state_specs`), for a
server step that must draw or reduce over the whole leaf (int8 memory).

Runs at data extent > 1 are worlds of CPU processes (gloo): one H100 has
no second rank. CUDA tensors there raise NotImplementedError; nothing on
the card falls back to a plain version. Params placed over mesh axes are
`sharding.params`'.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.rules import (axis_names, data_axes,
                                        data_axis_size, mesh_shape)


class _Local:
    """A whole client axis on this rank: the reductions without a
    collective."""

    def n(self, x: torch.Tensor) -> int:
        return x.shape[0]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(0)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum()

    def all(self, x: torch.Tensor) -> torch.Tensor:
        return x.all()


LOCAL = _Local()


class ClientShard:
    """Rows [lo, hi) of an axis of `n` rows, and the data group whose
    ranks hold the other blocks (None: the rows are whole here)."""

    def __init__(self, n: int, lo: int, hi: int, group):
        self.n_rows, self.lo, self.hi, self.group = n, lo, hi, group
        self.specs = self.mesh = None

    def n(self, x: torch.Tensor) -> int:
        """Length of the whole axis that `x`'s leading dim is a block of."""
        return self.n_rows

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole (n, ...) tensor."""
        return x[self.lo:self.hi]

    def reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum) `x` in place over the data group."""
        import torch.distributed as dist
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the whole axis of a block (rows, ...) -> (...)."""
        return self.reduce_(x.sum(0))

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over every element of the whole axis' tensor."""
        return self.reduce_(x.sum())

    def all(self, x: torch.Tensor) -> torch.Tensor:
        """All true over the whole axis."""
        import torch.distributed as dist
        if self.group is None:
            return x.all()
        v = x.all().to(torch.int32)
        dist.all_reduce(v, op=dist.ReduceOp.MIN, group=self.group)
        return v.bool()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole (n, ...) tensor from every rank's (hi - lo, ...)
        block."""
        import torch.distributed as dist
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(
            dist.get_world_size(self.group))]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


def data_coordinate(mesh) -> int:
    """This rank's index along the mesh's data axes (row-major over
    ('pod', 'data'))."""
    names = axis_names(mesh)
    coord = mesh.get_coordinate()
    shape = mesh_shape(mesh)
    c = 0
    for a in data_axes(mesh):
        c = c * shape[a] + coord[names.index(a)]
    return c


def data_group(mesh):
    """The process group of the ranks that share this rank's non-data
    coordinates: the holders of the other blocks of a client axis."""
    dax = data_axes(mesh)
    if len(dax) == 1:
        return mesh.get_group(dax[0])
    return mesh[dax]._flatten().get_group()


def check_data_ranks(mesh, device: torch.device, *, what: str) -> None:
    """Raise unless `what` can run over `mesh`'s data ranks: CUDA tensors
    at data extent > 1 (one card is a world of one rank) and a mesh there
    that is not a DeviceMesh."""
    d = data_axis_size(mesh)
    if d == 1:
        return
    if device.type == "cuda":
        raise NotImplementedError(
            f"{what} over {d} data ranks on CUDA tensors: one card "
            "runs a world of one rank, so a mesh on the card has data "
            "extent 1; data extent > 1 runs on CPU ranks (gloo)")
    if not hasattr(mesh, "get_group"):
        raise ValueError(
            f"a mesh of data extent {d} must be a DeviceMesh over a world "
            "of ranks (launch.mesh.make_host_mesh); an abstract mesh "
            "places nothing")


def client_shard(mesh, n: int, device: torch.device, *,
                 what: str = "the client axis") -> ClientShard | None:
    """This rank's block of an axis of `n` rows under `mesh` (None when
    there is nothing to split: module docstring). Raises for CUDA tensors
    at data extent > 1 and for a mesh that is not a DeviceMesh there."""
    d = data_axis_size(mesh)
    if d == 1 or n % d:
        return None
    check_data_ranks(mesh, device, what=what + " split")
    size = n // d
    lo = data_coordinate(mesh) * size
    return ClientShard(n, lo, lo + size, data_group(mesh))
