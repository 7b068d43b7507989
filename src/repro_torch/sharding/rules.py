"""Partition rules: parameter / client-state / cache / batch specs
(counterpart of `repro/sharding/rules.py`).

Axis conventions (`launch.mesh`):
    single pod : ("data", "model")              16 x 16
    multi-pod  : ("pod", "data", "model")       2 x 16 x 16

* `model` carries tensor parallelism: attention heads, d_ff, experts, d_inner.
* `data` carries client parallelism (MIFA's client axis) and, for `fsdp`
  configs, a second parameter shard dim (2-D FSDP x TP).
* `pod` extends the client/data axis across pods (pure data parallel;
  parameters replicated across pods).

Rules are matched on the *trailing* dims of each leaf by parameter name, so
layer-stacked leaves (leading segment axis) reuse the same table.

A spec is a `PartitionSpec`: a tuple with one entry per tensor dim, each
None (replicated), an axis name, or a tuple of axis names (the dim split
over their product), canonicalised as the reference's `PartitionSpec`
canonicalises them (a one-name tuple becomes the name). Trees are the
port's nested dicts and lists (`repro_torch.tree`); a leaf is anything
with `shape` and `ndim` (a tensor, also on the meta device). A mesh is a
`launch.mesh.AbstractMesh` or a `DeviceMesh` with named dims; every
function takes either. `placements` turns a spec into DTensor placements.
"""
from __future__ import annotations

from typing import Any

from repro_torch.tree import tree_map

DATA = "data"
MODEL = "model"


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        def canon(entry):
            if isinstance(entry, (tuple, list)):
                entry = tuple(entry)
                return entry[0] if len(entry) == 1 else entry
            return entry
        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_names(mesh) -> tuple:
    """The mesh's axis names, in mesh-dim order."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"not a mesh with named axes: {mesh!r}; build one "
                        "with launch.mesh.make_abstract_mesh or "
                        "make_host_mesh")
    return tuple(names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of an AbstractMesh or a DeviceMesh."""
    names = axis_names(mesh)
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(names, shape))


def data_axes(mesh) -> tuple:
    """Client/data axes — ('pod','data') on the multi-pod mesh."""
    return ("pod", DATA) if "pod" in axis_names(mesh) else (DATA,)


# --------------------------------------------------------------------------- #
# trailing-dim rule table: name -> spec for the *trailing* dims
# --------------------------------------------------------------------------- #

def _trailing_spec(name: str, parent: str, ndim_trailing: int,
                   fsdp: bool) -> tuple:
    f = DATA if fsdp else None
    table: dict[str, tuple] = {
        # embeddings / head: d_model on `model` => local gather at lookup;
        # lm_head vocab on `model` => vocab-sharded logits
        "embed": (f, MODEL),
        "lm_head": (f, MODEL),
        "frontend_proj": (None, MODEL),
        # attention (GQA), FLAT layout: (d, H*hd) / (H*hd, d) / biases (H*hd,)
        "wq": (f, MODEL),
        "wk": (f, MODEL),
        "wv": (f, MODEL),
        "wo": (MODEL, f),
        "bq": (MODEL,),
        "bk": (MODEL,),
        "bv": (MODEL,),
        # MLA (flat)
        "w_dkv": (f, None),
        "w_kpe": (f, None),
        "w_uk": (None, MODEL),
        "w_uv": (None, MODEL),
        # ssm (mamba2)
        "in_proj": (f, MODEL),
        "out_proj": (MODEL, f),
        "conv_w": (None, MODEL),
        "conv_b": (MODEL,),
        "A_log": (MODEL,),
        "D": (MODEL,),
        "dt_bias": (MODEL,),
        "norm_scale": (MODEL,),
        # router
        "router": (None, None),
        # norms
        "scale": (None,),
        # tabular models
        "w": (None, None) if ndim_trailing == 2 else (None,),
        "b": (None,),
    }
    if name in ("w1", "w3"):
        if ndim_trailing == 3:            # moe experts (E, d, f)
            return (MODEL, None, None)
        return (f, MODEL)                 # dense mlp (d, f)
    if name == "w2":
        if ndim_trailing == 3:            # (E, f, d)
            return (MODEL, None, None)
        return (MODEL, f)                 # (f, d)
    if name in table:
        spec = table[name]
        if len(spec) == ndim_trailing:
            return spec
        # tolerate rank differences (e.g. tabular "w" 2d vs bias 1d)
        if len(spec) > ndim_trailing:
            return spec[-ndim_trailing:]
        return (None,) * (ndim_trailing - len(spec)) + spec
    return (None,) * ndim_trailing


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axis_size(mesh, entry) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for a in _entry_axes(entry):
        n *= shape[a]
    return n


def sanitize(spec: tuple, shape: tuple, mesh) -> tuple:
    """Drop sharding on dims the mesh axis size does not divide — and on
    entries naming an axis this mesh does not have (a multi-pod spec reused
    on a single-pod mesh replicates those dims instead of raising)."""
    names = set(axis_names(mesh))
    out = []
    for dim, entry in zip(shape, spec):
        axes = _entry_axes(entry)
        if any(a not in names for a in axes):
            out.append(None)
            continue
        n = _axis_size(mesh, entry)
        out.append(entry if (n > 1 and dim % n == 0) or n == 1 else None)
    return tuple(out)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """`fn(path, leaf)` over a tree of dicts and lists; `path` holds the
    dict keys and list indices from the root to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _path_names(path) -> list[str]:
    """The path's dict keys and list indices as strings, as the reference
    reads its key paths' `.key` and `.idx`."""
    return [str(part) for part in path]


def _base_ndim(name: str, parent: str) -> int:
    """Rank of the *unstacked* parameter (trailing dims the table describes)."""
    ranks = {
        "embed": 2, "lm_head": 2, "frontend_proj": 2,
        "wq": 2, "wk": 2, "wv": 2, "wo": 2, "bq": 1, "bk": 1, "bv": 1,
        "w_dkv": 2, "w_kpe": 2, "w_uk": 2, "w_uv": 2,
        "in_proj": 2, "out_proj": 2, "conv_w": 2, "conv_b": 1,
        "A_log": 1, "D": 1, "dt_bias": 1, "norm_scale": 1,
        "router": 2, "scale": 1,
    }
    if name in ("w1", "w2", "w3"):
        return 3 if parent == "moe" else 2
    if name == "w":
        return 2
    if name == "b":
        return 1
    return ranks.get(name, 0)


def _spec_for(path, leaf, fsdp: bool, extra_leading: int = 0):
    names = _path_names(path)
    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    base = _base_ndim(name, parent)
    nd = leaf.ndim - extra_leading
    trailing = min(base, nd) if base else nd
    spec = _trailing_spec(name, parent, trailing, fsdp)
    lead = (None,) * (leaf.ndim - len(spec) - extra_leading)
    return spec, lead


def param_specs(params: Any, cfg, mesh) -> Any:
    """PartitionSpec tree matching `params`."""
    def fn(path, leaf):
        spec, lead = _spec_for(path, leaf, cfg.fsdp)
        full = lead + tuple(spec)
        return P(*sanitize(full, tuple(leaf.shape), mesh))
    return tree_map_with_path(fn, params)


def client_state_specs(params: Any, cfg, mesh,
                       sequential_clients: bool = False,
                       n_clients: int = 0) -> Any:
    """Specs for MIFA's update array: leaves (N_clients, *param_shape).

    vmap mode: client axis -> data (and pod); param dims use model-only rules
    (the data axis is taken by clients, so fsdp is dropped).
    sequential mode: clients unsharded; param dims keep full 2-D
    (data x model) sharding — per-client grads are computed on the whole mesh.
    """
    dax = data_axes(mesh)

    def fn(path, leaf):
        if sequential_clients:
            spec, lead = _spec_for(path, leaf, True, extra_leading=1)
            full = (None,) + lead + tuple(spec)
        else:
            spec, lead = _spec_for(path, leaf, False, extra_leading=1)
            full = (dax,) + lead + tuple(spec)
        # the leaves are (N_clients, *param_shape); sanitize with that shape
        return P(*sanitize(full, (n_clients,) + tuple(leaf.shape), mesh))

    return tree_map_with_path(fn, params)


def data_axis_size(mesh) -> int:
    """Total extent of the client/data axes — the shard count for MemoryBank
    rows and the MIFA update array."""
    shape = mesh_shape(mesh)
    d = 1
    for a in data_axes(mesh):
        d *= shape[a]
    return d


def padded_bank_rows(n_clients: int, mesh) -> int:
    """Row count for a sharded MemoryBank: N real rows + the dummy pad row,
    rounded up so the client axis divides the mesh's data extent (otherwise
    `sanitize` would silently replicate the whole bank)."""
    d = data_axis_size(mesh)
    return -((n_clients + 1) // -d) * d


def bank_row_specs(params: Any, cfg, mesh, n_rows: int) -> Any:
    """Specs for MemoryBank rows: leaves (n_rows, *param_shape), the client
    axis sharded over data (and pod) — the same layout as the dense MIFA
    update array, so the cohort scatter is a local row exchange."""
    return client_state_specs(params, cfg, mesh, n_clients=n_rows)


def fleet_trial_specs(stacked_params: Any, cfg, mesh) -> Any:
    """Specs for fleet-stacked parameters: leaves (K, *param_shape). The
    trial axis shards over the mesh's data (and pod) axes; the param dims
    reuse the model-only trailing rules. Indivisible trial counts fall back
    to replication via `sanitize`."""
    dax = data_axes(mesh)

    def fn(path, leaf):
        spec, lead = _spec_for(path, leaf, False, extra_leading=1)
        full = (dax,) + lead + tuple(spec)
        return P(*sanitize(full, tuple(leaf.shape), mesh))

    return tree_map_with_path(fn, stacked_params)


def fleet_axis_specs(stacked_state: Any, mesh) -> Any:
    """Generic trial-axis specs for opaque fleet state (algorithm state,
    memory-bank rows, generators' keys): axis 0 over data/pod, the rest
    replicated. Scalar leaves (per-fleet counters) replicate."""
    dax = data_axes(mesh)

    def fn(leaf):
        if leaf.ndim == 0:
            return P()
        full = (dax,) + (None,) * (leaf.ndim - 1)
        return P(*sanitize(full, tuple(leaf.shape), mesh))

    return tree_map(fn, stacked_state)


def scan_carry_specs(carry: dict, mesh, *, cfg=None, n_clients: int = 0,
                     row_counts: tuple = ()) -> dict:
    """Specs for the whole-run scan carry (`core.scan_engine`).

    The carry is ``{"state", "params", "rng"}`` plus the scenario keys
    ``{"scen_state", "scen_key"}`` and the τ accumulators ``{"tau",
    "tau_max"}``. Placement:

      * ``params`` — `param_specs` when `cfg` is given; replicated
        otherwise (the paper models replicate anyway).
      * client-indexed state — any leaf whose leading dim is `n_clients`,
        `n_clients + 1` (dense bank rows with the dummy row) or one of
        `row_counts` (padded bank rows) shards axis 0 over the mesh's
        data (and pod) axes.
      * everything else (generators, scalars, running sums) — replicated.
    """
    dax = data_axes(mesh)
    rows = {n_clients, n_clients + 1, *row_counts} - {0, 1}

    def client_leaf(leaf):
        if leaf.ndim and leaf.shape[0] in rows:
            full = (dax,) + (None,) * (leaf.ndim - 1)
            return P(*sanitize(full, tuple(leaf.shape), mesh))
        return P()

    def replicated(tree):
        return tree_map(lambda _: P(), tree)

    out = {}
    for key, sub in carry.items():
        if key == "params":
            out[key] = (param_specs(sub, cfg, mesh) if cfg is not None
                        else replicated(sub))
        elif key in ("rng", "scen_key"):
            out[key] = replicated(sub)
        else:   # state / scen_state / tau / tau_max
            out[key] = tree_map(client_leaf, sub)
    return out


def fleet_carry_specs(carry: dict, mesh, *, cfg=None) -> dict:
    """Specs for the fleet scan carry: every leaf carries a leading (K,)
    trial axis, sharded over data/pod (`fleet_axis_specs`); stacked params
    keep their model-dim rules via `fleet_trial_specs` when `cfg` is
    given."""
    out = {}
    for key, sub in carry.items():
        if key == "params" and cfg is not None:
            out[key] = fleet_trial_specs(sub, cfg, mesh)
        else:
            out[key] = fleet_axis_specs(sub, mesh)
    return out


def cache_specs(cache: Any, cfg, mesh, batch_size: int) -> Any:
    """KV/SSM cache specs.

    Stacked entries: (n_layers, B, C, KV, hd) etc. Batch shards over data when
    divisible; for the single-request long-context shape (B=1) the *sequence*
    dim of attention caches shards over data instead (flash-decode style).
    """
    dax = data_axes(mesh)
    shape = mesh_shape(mesh)
    n_dev_data = 1
    for a in dax:
        n_dev_data *= shape[a]
    batch_sharded = batch_size % n_dev_data == 0 and batch_size >= n_dev_data
    bspec = dax if batch_sharded else None
    sspec = None if batch_sharded else dax

    model_size = shape[MODEL]

    def fn(path, leaf):
        names = _path_names(path)
        name = names[-1]
        stacked = leaf.ndim == {"k": 5, "v": 5, "c": 4, "pe": 4,
                                "state": 5, "conv": 4}.get(name, -1)
        lead = (None,) if stacked else ()
        dims = tuple(leaf.shape)
        if name in ("k", "v"):      # (B, C, KV, hd)
            kv = leaf.shape[-2]
            if kv % model_size == 0:
                full = lead + (bspec, sspec, MODEL, None)
            elif batch_sharded:
                # too few kv heads for the model axis: seq-shard the cache
                # over `model` instead (flash-decode style partial softmax)
                full = lead + (bspec, MODEL, None, None)
            else:
                dd = tuple(dax) + (MODEL,)
                full = lead + (bspec, dd, None, None)
            return P(*sanitize(full, dims, mesh))
        if name in ("c", "pe"):     # (B, S, r) — MLA compressed cache
            full = lead + (bspec, sspec if sspec else MODEL, None)
            return P(*sanitize(full, dims, mesh))
        if name == "state":         # (B, H, P, N)
            full = lead + (bspec, MODEL, None, None)
            return P(*sanitize(full, dims, mesh))
        if name == "conv":          # (B, W-1, conv_ch)
            full = lead + (bspec, None, MODEL)
            return P(*sanitize(full, dims, mesh))
        return P()

    return tree_map_with_path(fn, cache)


def batch_specs(batch: Any, mesh, *, client_axis: bool = True,
                sequential_clients: bool = False) -> Any:
    """Training batches (N, K, mb, ...) or serving batches (B, ...).

    vmap mode shards the leading client axis over data; sequential mode shards
    the per-client minibatch dim (axis 2) instead.
    """
    dax = data_axes(mesh)

    def fn(leaf):
        if client_axis and sequential_clients:
            # the per-client minibatch dim over `data` only (pods hold the
            # fsdp replica axis in sequential mode)
            spec = [None, None, DATA] + [None] * (leaf.ndim - 3)
        else:
            spec = [dax] + [None] * (leaf.ndim - 1)
        return P(*sanitize(tuple(spec), tuple(leaf.shape), mesh))

    return tree_map(fn, batch)


# --------------------------------------------------------------------------- #
# from specs to placements
# --------------------------------------------------------------------------- #

def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh dim:
    `Shard(d)` on each mesh dim that tensor dim d is split over,
    `Replicate()` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


class NamedSharding:
    """A spec on a mesh, as the reference's `jax.sharding.NamedSharding`:
    the placement of one leaf (`launch.specs` fills its plans' in and out
    placements with them; `launch.steps.make_train_step(update_spec=)`
    takes a tree of them; `placements(s.spec, s.mesh)` gives the DTensor
    placements on a DeviceMesh)."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def named(mesh, specs: Any) -> Any:
    """A tree of PartitionSpecs as a tree of `NamedSharding`s on `mesh`
    (the reference's `launch/specs.py::_ns`)."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def sharded_axes(specs: Any, mesh) -> set:
    """The axes of size > 1 that any spec of the tree `specs` splits a
    dim over (empty: the tree is whole on every rank)."""
    shape = mesh_shape(mesh)
    found: set = set()

    def visit(spec):
        for entry in spec:
            found.update(a for a in _entry_axes(entry) if shape[a] > 1)
        return spec
    tree_map(visit, specs)
    return found
