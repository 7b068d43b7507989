"""The port's sharding rules and mesh builders against the JAX package's.

No process group: every mesh here is abstract (`make_abstract_mesh` on
both sides), and the param, cache and carry trees are shapes only — the
reference's from `jax.eval_shape` of `Model.init` / `init_cache`, the
port's on `torch.device("meta")` (built under a `FakeTensorMode`, then as
meta tensors), so no full-size weights are allocated.

* For every config of `configs.all_configs` and both paper models, on the
  abstract meshes (1,1), (2,2), (8,1), (16,16) and (2,16,16), every spec
  function of `sharding/rules.py` gives the reference's `PartitionSpec`s
  read as tuples: `param_specs`, `client_state_specs` (vmap and
  sequential), `bank_row_specs`, `fleet_trial_specs`,
  `fleet_axis_specs`, `scan_carry_specs`, `fleet_carry_specs`,
  `cache_specs` (the decoders) and `batch_specs`.
* `launch/mesh.py`'s validation errors match the reference's word for
  word; the concrete builders without a world name the remedy.
* `sanitize`, `padded_bank_rows` and `fleet_axis_specs` on
  hypothesis-drawn shapes equal the reference's.
* `param_specs` that split a param over a mesh axis are placed by
  `sharding.params`: each rank's block of every leaf, and the blocks tile
  each leaf exactly once; the paper models' specs keep every leaf whole.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.launch.mesh import make_abstract_mesh as jax_mesh
from repro.models import build_model as jax_build
from repro.sharding import rules as jrules
from repro_torch.configs import all_configs, get_config
from repro_torch.launch.mesh import (make_abstract_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import build_model
from repro_torch.sharding import rules
from repro_torch.sharding.params import block_slices
from repro_torch.tree import tree_map

CONFIGS = list(all_configs()) + ["paper_logistic", "paper_mlp"]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
N_CLIENTS, K_TRIALS, BATCH, CACHE_LEN = 16, 32, 8, 64


def _meta(fn):
    """fn() built as fake tensors, returned as meta tensors of the same
    shapes and dtypes."""
    with FakeTensorMode():
        tree = fn()
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


@functools.lru_cache(maxsize=None)
def _trees(arch: str):
    """(reference params, port params, reference cache, port cache), all
    shapes only; the caches None for a config that does not decode."""
    jmodel = jax_build(jax_config(arch))
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    model = build_model(get_config(arch))
    params = _meta(lambda: model.init(0, device="cpu"))
    jcache = cache = None
    if model.cfg.family != "tabular" and model.cfg.supports_decode:
        jcache = jax.eval_shape(lambda: jmodel.init_cache(BATCH, CACHE_LEN))
        cache = _meta(lambda: model.init_cache(BATCH, CACHE_LEN,
                                               device="cpu"))
    return jparams, params, jcache, cache


def _tuples(specs):
    """The reference's PartitionSpec tree with tuple leaves."""
    return jax.tree.map(tuple, specs, is_leaf=lambda s: isinstance(s, JP))


def _lead(tree, n, jax_side):
    """The tree's leaves with a leading axis of n (shapes only)."""
    if jax_side:
        return jax.tree.map(lambda leaf: jax.ShapeDtypeStruct(
            (n,) + tuple(leaf.shape), leaf.dtype), tree)
    return tree_map(lambda leaf: torch.empty((n,) + tuple(leaf.shape),
                                             dtype=leaf.dtype,
                                             device="meta"), tree)


def _batch(cfg, jax_side):
    """A training batch (N, K, mb, S) and a serving batch (B, S)."""
    shapes = {"tokens": (N_CLIENTS, 5, 2, 16), "serve": (BATCH, 16)}
    if jax_side:
        return {k: jax.ShapeDtypeStruct(s, jnp.int32)
                for k, s in shapes.items()}
    return {k: torch.empty(s, dtype=torch.int32, device="meta")
            for k, s in shapes.items()}


def _all_specs(r, cfg, mesh, params, cache, jax_side):
    """Every spec function of `r` (either package's rules) on one config."""
    rows = r.padded_bank_rows(N_CLIENTS, mesh)
    stacked = _lead(params, K_TRIALS, jax_side)
    vec = ((lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)) if jax_side
           else (lambda *s: torch.empty(s, dtype=torch.int32,
                                        device="meta")))
    carry = {"state": {"G": _lead(params, N_CLIENTS, jax_side),
                       "rows": _lead(params, rows, jax_side),
                       "t": vec()},
             "params": params, "rng": vec(2), "scen_key": vec(2),
             "scen_state": {"chain": vec(N_CLIENTS)},
             "tau": vec(N_CLIENTS), "tau_max": vec(N_CLIENTS)}
    out = {
        "param": r.param_specs(params, cfg, mesh),
        "client": r.client_state_specs(params, cfg, mesh,
                                       n_clients=N_CLIENTS),
        "client_seq": r.client_state_specs(params, cfg, mesh,
                                           sequential_clients=True,
                                           n_clients=N_CLIENTS),
        "bank_rows": r.bank_row_specs(params, cfg, mesh, rows),
        "fleet_trial": r.fleet_trial_specs(stacked, cfg, mesh),
        "fleet_axis": r.fleet_axis_specs(stacked, mesh),
        "scan_carry": r.scan_carry_specs(carry, mesh, cfg=cfg,
                                         n_clients=N_CLIENTS,
                                         row_counts=(rows,)),
        "scan_carry_nocfg": r.scan_carry_specs(carry, mesh,
                                               n_clients=N_CLIENTS),
        "fleet_carry": r.fleet_carry_specs({"params": stacked}, mesh,
                                           cfg=cfg),
        "batch": r.batch_specs(_batch(cfg, jax_side), mesh),
        "batch_seq": r.batch_specs(_batch(cfg, jax_side), mesh,
                                   sequential_clients=True),
        "batch_serve": r.batch_specs(_batch(cfg, jax_side), mesh,
                                     client_axis=False)}
    if cache is not None:
        out["cache"] = r.cache_specs(cache, cfg, mesh, BATCH)
        out["cache_b1"] = r.cache_specs(cache, cfg, mesh, 1)
    return out


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", CONFIGS)
def test_specs_equal_the_reference(arch, mesh_id):
    shape, axes = MESHES[mesh_id]
    jparams, params, jcache, cache = _trees(arch)
    want = _all_specs(jrules, jax_config(arch), jax_mesh(shape, axes),
                      jparams, jcache, True)
    got = _all_specs(rules, get_config(arch), make_abstract_mesh(shape, axes),
                     params, cache, False)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == _tuples(want[key]), (arch, mesh_id, key)


BAD_MESHES = [((4, 4), ("data", "data")), ((4, 0), ("data", "model")),
              ((4, -2), ("data", "model")), ((4, 3.0), ("data", "model")),
              ((4, 4, 2), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", BAD_MESHES,
                         ids=["duplicate", "zero", "negative", "float",
                              "length"])
def test_mesh_validation_errors_are_the_reference_s(shape, axes):
    with pytest.raises(ValueError) as want:
        jax_mesh(shape, axes)
    with pytest.raises(ValueError) as got:
        make_abstract_mesh(shape, axes)
    assert str(got.value) == str(want.value)


def test_concrete_meshes_need_a_world_and_name_the_remedy():
    """Without a process group the builders raise before they touch any
    device or group, naming the world they need; an abstract mesh has
    the reference's axis names, shape and size."""
    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    ref = jax_mesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh.axis_names == ref.axis_names
    assert mesh.shape == dict(ref.shape) and mesh.size == ref.size
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs a world of 4 ranks but no "
                                         "process group is initialised; "
                                         "start a world of 4 ranks"):
        make_host_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="axis 'data' has non-positive"):
        make_host_mesh(0, 1, device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["granite_3_8b", "qwen1_5_110b"])
def test_split_params_raise_when_placed(arch):
    """The zoo's tensor-parallel (and qwen's fsdp) specs split params over
    `model` (and `data`); `sharding.params` takes each rank's block of
    every leaf, and the four ranks' distinct blocks tile it exactly once.
    The paper models' specs are whole on any mesh: every rank's block is
    the whole leaf."""
    import itertools

    import numpy as np
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    coords = list(itertools.product(range(2), range(2)))

    def tiles(specs, params):
        counts = []

        def visit(path, leaf):
            spec = specs
            for k in path:
                spec = spec[k]
            shape = tuple(leaf.shape)
            blocks = {block_slices(spec, shape, mesh, coord=c)
                      for c in coords}
            cover = np.zeros(shape, np.int8)
            for b in blocks:
                cover[b] += 1
            assert (cover == 1).all(), (path, spec)
            counts.append(len(blocks))
        rules.tree_map_with_path(visit, params)
        return counts

    _, params, _, _ = _trees(arch)
    specs = rules.param_specs(params, get_config(arch), mesh)
    assert rules.sharded_axes(specs, mesh) == (
        {"data", "model"} if arch == "qwen1_5_110b" else {"model"})
    assert max(tiles(specs, _small(params))) > 1
    for paper in ("paper_logistic", "paper_mlp"):
        _, pp, _, _ = _trees(paper)
        specs = rules.param_specs(pp, get_config(paper), mesh)
        assert not rules.sharded_axes(specs, mesh)
        assert set(tiles(specs, pp)) == {1}
        assert all(all(e is None for e in s) for s in
                   jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
                       s, tuple)))


def _small(params):
    """The leaves with each dim cut to at most 64, so the coverage arrays
    stay small (64 divides over the 2x2 mesh as the whole dims do; the
    specs were taken at the whole shapes)."""
    return tree_map(lambda p: torch.empty(tuple(min(n, 64) for n in p.shape),
                                          device="meta"), params)


_MESH_IDS = ["2x2", "16x16", "2x16x16"]
_ENTRIES = [None, "data", "model", "pod", ("data", "model"),
            ("pod", "data"), ("pod", "data", "model")]


def _both(mesh_id):
    shape, axes = MESHES[mesh_id]
    return jax_mesh(shape, axes), make_abstract_mesh(shape, axes)


@settings(max_examples=50, deadline=None)
@given(st.sampled_from(_MESH_IDS),
       st.lists(st.tuples(st.sampled_from(_ENTRIES), st.integers(1, 4096)),
                min_size=1, max_size=4))
def test_sanitize_equals_the_reference(mesh_id, dims):
    jm, m = _both(mesh_id)
    spec = tuple(e for e, _ in dims)
    shape = tuple(d for _, d in dims)
    assert rules.sanitize(spec, shape, m) == jrules.sanitize(spec, shape, jm)


@settings(max_examples=50, deadline=None)
@given(st.sampled_from(_MESH_IDS), st.integers(1, 10**6))
def test_padded_bank_rows_equals_the_reference(mesh_id, n_clients):
    jm, m = _both(mesh_id)
    assert (rules.padded_bank_rows(n_clients, m)
            == jrules.padded_bank_rows(n_clients, jm))
    assert rules.data_axis_size(m) == jrules.data_axis_size(jm)


@settings(max_examples=50, deadline=None)
@given(st.sampled_from(_MESH_IDS),
       st.lists(st.lists(st.integers(1, 64), min_size=0, max_size=3),
                min_size=1, max_size=4))
def test_fleet_axis_specs_equals_the_reference(mesh_id, shapes):
    jm, m = _both(mesh_id)
    jtree = {str(i): jax.ShapeDtypeStruct(tuple(s), jnp.float32)
             for i, s in enumerate(shapes)}
    tree = {str(i): torch.empty(tuple(s), device="meta")
            for i, s in enumerate(shapes)}
    assert rules.fleet_axis_specs(tree, m) == _tuples(
        jrules.fleet_axis_specs(jtree, jm))
