"""`sharding/params.py` on the CPU, with no process group: the block rule,
the identity at extent 1, what raises, and the specs a placed scan carry
takes.

* The block rule: for every param spec of qwen1.5-110b's smoke config with
  fsdp (two axes on one dim, `data` then `model`, and `pod` on the
  two-pod mesh) and of granite-3-8b's (tensor parallelism over `model`),
  on the abstract shapes 2x2 and 2x16x16, the block `block_slices` gives
  each coordinate equals a by-hand row-major split (the dim cut into the
  first axis' extent, that part into the next axis' extent, ...), and the
  distinct blocks tile each leaf exactly once.
* Extent 1: `block`, `take`, `whole` and `relayout` give back the same
  tensor object; a spec naming only axes of extent 1 places nothing.
* Extent > 1: CUDA tensors raise NotImplementedError and an abstract mesh
  ValueError, as `sharding.clients.client_shard` does.
* `carry_state_specs` and `StepPlacement`: MIFA's update array takes
  `client_state_specs`, its param-shaped leaves the server step's layout,
  and its counters stay replicated.
"""
import itertools

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_smoke_config
from repro_torch.core import MIFA
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import build_model
from repro_torch.sharding import rules
from repro_torch.sharding.params import (StepPlacement, block, block_shape,
                                         block_slices, carry_state_specs,
                                         relayout, take, whole, whole_shape)
from repro_torch.sharding.rules import P, tree_map_with_path
from repro_torch.tree import tree_leaves, tree_map

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = {"qwen1_5_110b": {"fsdp": True}, "granite_3_8b": {}}


def _meta_params(cfg):
    with FakeTensorMode():
        tree = build_model(cfg).init(0, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _by_hand(spec, shape, mesh_shape, axes, coord):
    """Row-major nested split: for each dim, cut it into the first named
    axis' extent and keep the coordinate's part, then that part into the
    next axis' extent, and so on."""
    size = dict(zip(axes, mesh_shape))
    at = dict(zip(axes, coord))
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        lo, hi = 0, n
        for a in names:
            part = (hi - lo) // size[a]
            lo, hi = lo + at[a] * part, lo + (at[a] + 1) * part
        out.append((lo, hi))
    return out


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_blocks_are_the_row_major_split_and_tile_each_leaf(arch, mesh_id):
    cfg = get_smoke_config(arch).replace(**ARCHS[arch])
    mshape, axes = MESHES[mesh_id]
    mesh = make_abstract_mesh(mshape, axes)
    params = _meta_params(cfg)
    specs = rules.param_specs(params, cfg, mesh)
    split = rules.sharded_axes(specs, mesh)
    assert split == ({"data", "model"} if arch == "qwen1_5_110b"
                     else {"model"})
    coords = list(itertools.product(*(range(n) for n in mshape)))
    checked = []

    def check(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        shape = tuple(leaf.shape)
        blocks = set()
        for c in coords:
            got = block_slices(spec, shape, mesh, coord=c)
            want = _by_hand(spec, shape, mshape, axes, c)
            assert [(s.start or 0, n if s.stop is None else s.stop)
                    for s, n in zip(got, shape)] == want, (path, spec, c)
            blocks.add(tuple(want))
        cover = np.zeros(shape, np.int32)
        for b in blocks:
            cover[tuple(slice(lo, hi) for lo, hi in b)] += 1
        assert (cover == 1).all(), (path, spec)
        bshape = tuple(hi - lo for lo, hi in next(iter(blocks)))
        assert whole_shape(bshape, spec, mesh) == shape
        checked.append(len(blocks) > 1)
    tree_map_with_path(check, params)
    assert any(checked)


def test_extent_one_is_the_identity():
    cfg = get_smoke_config("qwen1_5_110b").replace(fsdp=True)
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    x = torch.arange(24.0).reshape(4, 6)
    spec = P(("data", "model"), "model")
    for fn in (block, take, whole):
        assert fn(x, spec, mesh) is x
    assert relayout(x, P("data", None), P(None, "model"), mesh) is x
    assert not rules.sharded_axes(rules.param_specs(
        _meta_params(cfg), cfg, mesh), mesh)


def test_a_split_leaf_raises_for_cuda_and_abstract_meshes():
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="CUDA tensors"):
        block_shape((4, 6), P(None, "model"), mesh, torch.device("cuda"))
    with pytest.raises(ValueError, match="abstract mesh places nothing"):
        block(torch.zeros(4, 6), P(None, "model"), mesh)
    with pytest.raises(ValueError, match="abstract mesh places nothing"):
        whole(torch.zeros(4, 6), P("data", None), mesh)
    # an axis of extent 1 splits nothing, even for CUDA
    one = make_abstract_mesh((1, 2), ("data", "model"))
    assert block_shape((4, 6), P("data", None), one,
                       torch.device("cuda")) == (4, 6)


@pytest.mark.parametrize("memory", ["array", "delta", "int8"])
def test_carry_state_specs_of_mifa(memory):
    cfg = get_smoke_config("granite_3_8b")
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    params = _meta_params(cfg)
    n = 4
    state = MIFA(memory=memory).init_state(params, n)
    specs = carry_state_specs(state, params, cfg, mesh, n)
    placement = StepPlacement(params, cfg, mesh, n)
    client = rules.client_state_specs(params, cfg, mesh, n_clients=n)
    assert specs["t"] == P()
    key = {"array": "G", "delta": "G_prev", "int8": "G_q"}[memory]
    assert tree_leaves(specs[key]) == tree_leaves(client)
    assert all(s[0] == "data" for s in tree_leaves(specs[key]))
    if memory == "delta":
        assert tree_leaves(specs["G_bar"]) == tree_leaves(
            placement.step_specs)
    if memory == "int8":
        assert all(s == P("data") for s in tree_leaves(specs["G_scale"]))
    assert tree_leaves(placement.update_specs) == [
        P(None, *s[1:]) for s in tree_leaves(client)]
    # without a config only the client axis is split
    plain = carry_state_specs(state, params, None, mesh, n)
    assert all(all(e is None for e in s[1:]) for s in tree_leaves(plain))
