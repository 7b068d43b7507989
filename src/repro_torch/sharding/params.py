"""A leaf placed over a mesh's axes: this rank's block of it, and the whole
leaf back from every rank's block (what the reference's
`jax.device_put(x, NamedSharding(mesh, spec))` and a global array's gather
do, held here as plain local tensors and explicit collectives).

Block rule. A spec (`sharding.rules.PartitionSpec`) has an entry per
leading tensor dim (dims past its length are whole). A dim whose entry
names axes (a1, a2, ...) is split row-major over them in the order the
entry names them, as JAX's `NamedSharding` splits it: the rank at
coordinates (c1, c2, ...) holds block ((c1·n2 + c2)·n3 + ...) of
dim / (n1·n2·...) consecutive indices. `rules.sanitize` has already
dropped every axis that does not divide its dim, so blocks are even.

Whole from blocks: an `all_gather` over the group of each mesh axis that
splits the leaf (`DeviceMesh.get_group(axis)`, the last-named axis of a
dim first), the parts concatenated in coordinate order. The meshes of
`launch.mesh` number their ranks row-major, so a group's ranks rise with
the axis' coordinate.

Where every axis a spec names has extent 1 (a mesh of a world of one)
both directions are the identity: the same tensor object comes back and no
collective is issued, so the kernels see the tensors they see without a
mesh. At extent > 1 an abstract mesh raises ValueError (it places
nothing), as `sharding.clients.client_shard` does, and CUDA tensors raise
NotImplementedError, except where a caller that computes on blocks (the
split steps of `sharding.tensor_parallel`, a `StepPlacement` that holds a
split, a `DenseBank(mesh=)`'s rows) passes `split=True` on a DeviceMesh of
CUDA ranks (gloo carries the CUDA tensors of a world of ranks on one
card). The message names the entries that will take the rest: ROADMAP
entries 12d–12f (the architectures the split does not take,
`tensor_parallel.unsupported`) at data extent 1, entry 12g beyond (the
data axis on the card, fsdp params, the sequential step at data extent
> 1).

`carry_state_specs` gives the scan carry's algorithm state its specs
(client-indexed leaves of the params' shape split over the data axes and,
by `client_state_specs`, over `model`); `StepPlacement` converts between
the carry's placed params and what a round computes on: the params' own
blocks for the local update where `model` splits and the config is one
the split takes (`tensor_parallel.train_split`), else whole params (CPU
ranks only); the state's column blocks for the server step.
`FleetPlacement` does the same for a fleet's stacked trial params: the
local update of every trial on the params' blocks, the server step on
whole params and the whole state (`fleet_axis_specs`: whole beyond the
trial axis).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.sharding.rules import (P, _entry_axes, axis_names,
                                        client_state_specs, data_axis_size,
                                        fleet_trial_specs, mesh_shape,
                                        param_specs, scan_carry_specs,
                                        sharded_axes)
from repro_torch.tree import tree_map


def split_dims(spec, mesh) -> list:
    """(dim, axes) of every dim `spec` splits over axes of extent > 1, the
    axes in the entry's order."""
    shape = mesh_shape(mesh)
    out = []
    for d, entry in enumerate(spec):
        axes = tuple(a for a in _entry_axes(entry) if shape[a] > 1)
        if axes:
            out.append((d, axes))
    return out


def _check(device: torch.device, mesh, what: str,
           split: bool = False) -> None:
    if device.type == "cuda" and not (
            split and getattr(mesh, "device_type", None) == "cuda"):
        later = ("the data axis on the card, fsdp params and the sequential "
                 "train step at data extent > 1 are ROADMAP entry 12g"
                 if data_axis_size(mesh) > 1 else
                 "MLA, Mamba2, padded heads and the encoder under split "
                 "products are ROADMAP entries 12d-12f")
        raise NotImplementedError(
            f"{what} split over mesh axes of extent > 1 on CUDA tensors: "
            "only what computes on blocks takes them on the card (the "
            "serving steps, the train step, the federated round and the "
            "fleets of the GQA stack with a dense MLP or MoE experts, "
            "sharding.tensor_parallel, on a "
            f"DeviceMesh of CUDA ranks); {later}, and run on CPU ranks "
            "(gloo)")
    if not hasattr(mesh, "get_group"):
        raise ValueError(
            f"{what}: a mesh of extent > 1 must be a DeviceMesh over a world "
            "of ranks (launch.mesh.make_host_mesh); an abstract mesh places "
            "nothing")


def block_slices(spec, shape: tuple, mesh, coord=None) -> tuple:
    """The index into a whole tensor of `shape` of the block under `spec`
    of the rank at `coord` (its coordinate on each mesh axis, in axis
    order; default: this rank's, `mesh.get_coordinate()`)."""
    mshape, names = mesh_shape(mesh), axis_names(mesh)
    if coord is None:
        coord = mesh.get_coordinate()
    idx = [slice(None)] * len(shape)
    for d, axes in split_dims(spec, mesh):
        k, n = 0, 1
        for a in axes:
            k = k * mshape[a] + coord[names.index(a)]
            n *= mshape[a]
        size = shape[d] // n
        idx[d] = slice(k * size, (k + 1) * size)
    return tuple(idx)


def block_shape(shape: tuple, spec, mesh, device: torch.device,
                what: str = "a leaf", split: bool = False) -> tuple:
    """The shape of this rank's block of a whole tensor of `shape` on
    `device` (raising where `block` would)."""
    dims = split_dims(spec, mesh)
    if dims:
        _check(torch.device(device), mesh, what, split)
    mshape, out = mesh_shape(mesh), list(shape)
    for d, axes in dims:
        for a in axes:
            out[d] //= mshape[a]
    return tuple(out)


def whole_shape(shape: tuple, spec, mesh) -> tuple:
    """The whole tensor's shape from a block's `shape` under `spec`."""
    mshape = mesh_shape(mesh)
    out = list(shape)
    for d, axes in split_dims(spec, mesh):
        for a in axes:
            out[d] *= mshape[a]
    return tuple(out)


def block(x: torch.Tensor, spec, mesh, what: str = "a leaf",
          split: bool = False):
    """This rank's block of the whole `x` under `spec`: `x` itself where
    nothing is split, else a view of it. `split`: the caller is a split
    step's (module docstring)."""
    if not isinstance(x, torch.Tensor) or not split_dims(spec, mesh):
        return x
    _check(x.device, mesh, what, split)
    return x[block_slices(spec, tuple(x.shape), mesh)]


def take(x, spec, mesh, what: str = "a leaf", split: bool = False):
    """`block` as a tensor of its own (the whole's storage is not kept)."""
    b = block(x, spec, mesh, what, split)
    return b if b is x else b.clone()


def whole(x, spec, mesh, what: str = "a leaf", split: bool = False):
    """The whole tensor from every rank's block `x` under `spec` (`x`
    itself where nothing is split)."""
    dims = split_dims(spec, mesh) if isinstance(x, torch.Tensor) else []
    if not dims:
        return x
    _check(x.device, mesh, what, split)
    import torch.distributed as dist
    for d, axes in dims:
        for a in reversed(axes):
            group = mesh.get_group(a)
            parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=d)
    return x


def relayout(x, src, dst, mesh, what: str = "a leaf",
             split: bool = False):
    """This rank's block under `dst` from its block `x` under `src`."""
    if tuple(src) == tuple(dst):
        return x
    return take(whole(x, src, mesh, what, split), dst, mesh, what, split)


def amax_(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """All-reduce (max) `x` in place over the groups of `axes`."""
    import torch.distributed as dist
    for a in axes:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return x


# --------------------------------------------------------------------------- #
# trees
# --------------------------------------------------------------------------- #

def take_tree(tree: Any, specs: Any, mesh, what: str = "a leaf",
              split: bool = False) -> Any:
    """`take` leaf by leaf against a PartitionSpec tree of `tree`'s
    structure."""
    return tree_map(lambda x, s: take(x, s, mesh, what, split), tree,
                    specs)


def whole_tree(tree: Any, specs: Any, mesh, what: str = "a leaf",
               split: bool = False) -> Any:
    return tree_map(lambda x, s: whole(x, s, mesh, what, split), tree,
                    specs)


def _pairwise(fn, values: Any, shardings: Any) -> Any:
    """`fn(value, NamedSharding)` over a value tree (a tuple at the top is
    taken element by element) and its sharding tree."""
    if isinstance(values, tuple):
        return tuple(_pairwise(fn, v, s) for v, s in zip(values, shardings))
    return tree_map(fn, values, shardings)


def place(values: Any, shardings: Any) -> Any:
    """Each rank's blocks of whole values under a tree of
    `rules.NamedSharding`s (each with its mesh)."""
    return _pairwise(lambda x, s: take(x, s.spec, s.mesh), values, shardings)


def gather(values: Any, shardings: Any) -> Any:
    """The whole values from each rank's blocks under `shardings`."""
    return _pairwise(lambda x, s: whole(x, s.spec, s.mesh), values,
                     shardings)


# --------------------------------------------------------------------------- #
# the scan carry
# --------------------------------------------------------------------------- #

def _same_structure(a: Any, b: Any) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return not isinstance(b, (dict, list))


def carry_state_specs(state: Any, params: Any, cfg, mesh,
                      n_clients: int) -> Any:
    """Specs of an algorithm's state in the scan carry.

    Every leaf gets `scan_carry_specs`' rule (a client-indexed leaf's
    leading axis over the data axes, the rest replicated). With `cfg`, a
    subtree of the params' structure is placed leaf by leaf against its
    param: an (N, *shape) leaf by `client_state_specs` (vmap mode: the
    client axis over data, the param dims by the model rules), a leaf of
    the param's own shape by that spec's param dims (the server step's
    layout, `StepPlacement.step_specs`)."""
    base = scan_carry_specs({"state": state}, mesh,
                            n_clients=n_clients)["state"]
    if cfg is None:
        return base
    cs = client_state_specs(params, cfg, mesh, n_clients=n_clients)

    def leaf(x, p, c, b):
        shape, ps = tuple(x.shape), tuple(p.shape)
        if shape == (n_clients,) + ps:
            return c
        if shape == ps:
            return P(*c[1:])
        return b

    def walk(sub, spec):
        if _same_structure(sub, params):
            return tree_map(leaf, sub, params, cs, spec)
        if isinstance(sub, dict):
            return {k: walk(sub[k], spec[k]) for k in sub}
        if isinstance(sub, list):
            return [walk(x, s) for x, s in zip(sub, spec)]
        return spec

    return walk(state, base)


class StepPlacement:
    """The params of a placed carry and the layouts a round computes in.

    `param_specs` place the params between rounds; the server step runs on
    the client state's column blocks: an update leaf is taken to
    `update_specs` (None on the client axis, then the param dims of
    `client_state_specs`, vmap mode) and the params to `step_specs` (those
    param dims alone); `from_step` takes the server step's new params back
    to their placement.

    Where `model` splits (extent > 1 on a DeviceMesh) and
    `tensor_parallel.unsupported` takes the config, `split` is the
    round's `TrainSplit`, built from these specs: the local update runs on
    the params' own blocks (`loss_fn(split=)`), and every move is
    `TrainSplit.move_tree` (an all-to-all where both layouts split one dim
    over `model`), so no leaf is gathered whole; on the card this is the
    only way in (`split=True` on a DeviceMesh of CUDA ranks). Else `split`
    is None and the local update runs on whole params (`whole`), gathered
    and cut on CPU ranks; CUDA params at model extent > 1 raise at
    construction, naming the ROADMAP entry that will take the config."""

    def __init__(self, params: Any, cfg, mesh, n_clients: int):
        from repro_torch.sharding import tensor_parallel as tp
        from repro_torch.tree import tree_leaves
        self.mesh = mesh
        self.param_specs = param_specs(params, cfg, mesh)
        cs = client_state_specs(params, cfg, mesh, n_clients=n_clients)
        self.state_specs = cs
        self.update_specs = tree_map(lambda s: P(None, *s[1:]), cs)
        self.step_specs = tree_map(lambda s: P(*s[1:]), cs)
        self.whole_specs = tree_map(lambda s: P(), cs)
        self.split = None
        if tp.model_axis(mesh) is not None:
            why = tp.unsupported(cfg, mesh, n_clients, train=True,
                                 fl_round=True)
            if why is None:
                self.split = tp.train_split(
                    cfg, mesh, n_clients, specs=(self.param_specs, cs))
            elif tree_leaves(params)[0].device.type == "cuda":
                raise NotImplementedError(
                    f"the federated round's local update on each rank's "
                    f"blocks: {why}")

    @property
    def _cuda(self) -> bool:
        """Blocks may be CUDA tensors: the round computes on them."""
        return self.split is not None

    def place(self, params: Any) -> Any:
        return take_tree(params, self.param_specs, self.mesh, "params",
                         self._cuda)

    def whole(self, params: Any) -> Any:
        """The whole params (evaluation, snapshots, the unsplit round)."""
        return whole_tree(params, self.param_specs, self.mesh, "params",
                          self._cuda)

    def updates(self, updates: Any, dst: Any = None, via: Any = None
                ) -> Any:
        """The local update's updates in `dst` (default `update_specs`;
        `whole_specs` for a bank held whole): from the params' blocks
        under the split (each leaf moved in `via`'s leaf's dtype where
        given, `TrainSplit.move_tree`), else cut from whole columns."""
        dst = self.update_specs if dst is None else dst
        if self.split is not None:
            return self.split.move_tree(updates, self.split.update_specs,
                                        dst, via=via)
        return tree_map(lambda u, s: block(u, s, self.mesh).contiguous(),
                        updates, dst)

    def to_step(self, params: Any) -> Any:
        """The server step's params from the carry's blocks (the split) or
        from whole params."""
        if self.split is not None:
            return self.split.move_tree(tree_map(lambda x: x, params),
                                        self.param_specs, self.step_specs)
        return tree_map(lambda w, s: block(w, s, self.mesh).contiguous(),
                        params, self.step_specs)

    def from_step(self, params: Any) -> Any:
        return self.to_params(params, self.step_specs)

    def to_params(self, tree: Any, specs: Any = None) -> Any:
        """The params' placement of a param-shaped tree placed by `specs`
        (None: whole on every rank)."""
        if specs is None:
            specs = tree_map(lambda s: P(), self.param_specs)
        if self.split is not None:
            return self.split.move_tree(tree_map(lambda x: x, tree), specs,
                                        self.param_specs)
        return tree_map(lambda x, s, p: relayout(x, s, p, self.mesh),
                        tree, specs, self.param_specs)


class FleetPlacement:
    """A fleet's stacked trial params placed by `fleet_trial_specs` and the
    layouts its round computes in (`fleet.executor`).

    `param_specs` place the (K, ...) params between rounds: the trial axis
    is this rank's block of trials (`FleetRunner.trial_shard` has cut it
    already), the param dims by the model rules. The algorithm state is
    whole beyond the trial axis on every rank (`fleet_axis_specs`), so the
    server step runs on whole params and whole updates (`whole_specs`).

    Where `model` splits (extent > 1 on a DeviceMesh) and
    `tensor_parallel.unsupported` takes the config, `split` is the
    `TrainSplit` of one trial (`fleet_trial_specs` without the trial axis;
    the whole state's specs as its state specs): every trial's local update
    runs on the params' blocks under vmap over trials (`loss_fn(split=)`),
    `updates` moves its (K, N, ...) updates to whole in the state's dtype,
    `to_step` gives the server step whole params, and `from_step` cuts the
    step's new params (or a cohort round's mean) back to the blocks with
    no collective: every rank computed the same whole values. All are
    `TrainSplit.move_tree`; on the card this is the only way in
    (`split=True` on a DeviceMesh of CUDA ranks). Else `split` is None and
    the round gathers whole params for the local update and cuts the new
    ones (CPU ranks only); CUDA params at model extent > 1 raise at
    construction, naming the ROADMAP entry that will take the config.
    `placed` is False where no param dim splits (nothing to move)."""

    def __init__(self, stacked: Any, cfg, mesh, n_clients: int):
        from repro_torch.sharding import tensor_parallel as tp
        from repro_torch.tree import tree_leaves
        self.mesh = mesh
        trial = tree_map(lambda s: P(*s[1:]),
                         fleet_trial_specs(stacked, cfg, mesh))
        self.param_specs = tree_map(lambda s: P(None, *s), trial)
        self.whole_specs = tree_map(lambda s: P(), trial)
        self.placed = bool(sharded_axes(self.param_specs, mesh))
        self.split = None
        if self.placed and tp.model_axis(mesh) is not None:
            why = tp.unsupported(cfg, mesh, n_clients, train=True,
                                 fl_round=True, fleet=True)
            if why is None:
                self.split = tp.train_split(
                    cfg, mesh, n_clients, specs=(trial, self.whole_specs))
            elif tree_leaves(stacked)[0].device.type == "cuda":
                raise NotImplementedError(
                    f"a fleet's local update on each rank's blocks: {why}")
        # the (K, N, ...) updates as every trial's local update leaves them
        self._update_src = tree_map(lambda s: P(None, None, *s), trial)

    def place(self, params: Any) -> Any:
        return take_tree(params, self.param_specs, self.mesh,
                         "the trial params", self.split is not None)

    def whole(self, params: Any) -> Any:
        """The whole stacked params (evaluation, `finalize`, the unsplit
        round)."""
        return whole_tree(params, self.param_specs, self.mesh,
                          "the trial params", self.split is not None)

    def updates(self, updates: Any, via: Any = None) -> Any:
        """The split local update's (K, N, ...) updates whole, each leaf
        moved in `via`'s leaf's dtype where given."""
        return self.split.move_tree(updates, self._update_src,
                                    self.whole_specs, via=via)

    def to_step(self, params: Any) -> Any:
        """Whole stacked params for the server step, from the blocks."""
        return self.split.move_tree(tree_map(lambda x: x, params),
                                    self.param_specs, self.whole_specs)

    def from_step(self, tree: Any) -> Any:
        """This rank's blocks of a whole (K, ...) param-shaped tree that
        every rank computed alike: a cut, no collective. The tree is cut in
        place, leaf by leaf, so one whole leaf is alive at a time."""
        return self.split.move_tree(tree, self.whole_specs,
                                    self.param_specs)
