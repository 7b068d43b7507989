"""The port's dry-run planner (`launch/specs.py`) and `make_train_step(
update_spec=)` against the JAX package's, on the CPU.

* Plans: for every id of `ARCH_IDS` x `INPUT_SHAPES` on both abstract
  production meshes (16x16 ``data, model`` and 2x16x16 ``pod, data,
  model``, `make_abstract_mesh` on both sides), and for qwen1.5-110b and
  llava-next-34b with `pad_heads`, `fsdp=False` and
  `inner_update_constraint` overrides, the port's plan equals the
  reference's: Skip or kind, and the reason; every argument's shape and
  dtype (the reference's ShapeDtypeStructs, the port's meta tensors);
  every in and out placement's spec read as a tuple; `donate_argnums` and
  `meta`. Each side plans from its own config registry.
* `update_spec`: on a 1x1 mesh the sequential round with the plan's
  update constraint is bit-equal to the one without, and holds the
  reference's round with its constraint (a 1-device jax Mesh) at the
  training bounds (rtol 2e-4, atol 2e-5 scaled by the leaf's largest
  magnitude, f32); on an abstract mesh whose spec splits leaves over
  axes of extent > 1 the step places nothing and runs whole, as the dry
  run traces it: on fake tensors it gives the unconstrained step's
  output shapes and dtypes. A world of ranks places the update
  (`tests/test_torch_param_placement_world.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNS

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.launch.mesh import make_abstract_mesh as jax_mesh
from repro.models import build_model as jax_build
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
OVERRIDES = [{"pad_heads": True}, {"fsdp": False},
             {"inner_update_constraint": True},
             {"inner_update_constraint": False}]


def _leaves_ref(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JNS))


def _leaves_port(tree) -> list:
    """Leaves of a value or placement tree, or a tuple of such trees."""
    if isinstance(tree, tuple) and not isinstance(tree, rules.PartitionSpec):
        return [leaf for t in tree for leaf in _leaves_port(t)]
    return tree_leaves(tree)


def _same_plan(ref, port):
    assert type(ref).__name__ == type(port).__name__
    assert (ref.arch, ref.shape) == (port.arch, port.shape)
    if isinstance(ref, jspecs.Skip):
        assert ref.reason == port.reason
        return
    assert ref.kind == port.kind
    assert tuple(ref.donate_argnums) == tuple(port.donate_argnums)
    assert ref.meta == port.meta
    ref_args = [(tuple(a.shape), str(a.dtype))
                for a in _leaves_ref(ref.args)]
    port_args = [(tuple(a.shape), str(a.dtype).removeprefix("torch."))
                 for a in _leaves_port(port.args)]
    assert ref_args == port_args
    assert all(a.device.type == "meta" for a in _leaves_port(port.args))
    for ref_sh, port_sh in ((ref.in_shardings, port.in_shardings),
                            (ref.out_shardings, port.out_shardings)):
        assert ([tuple(s.spec) for s in _leaves_ref(ref_sh)]
                == [tuple(s.spec) for s in _leaves_port(port_sh)])


def test_input_shapes_are_the_reference_s():
    assert {k: vars(v) for k, v in INPUT_SHAPES.items()} == {
        k: vars(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_equal_the_reference_s(arch, mesh):
    shape, axes = MESHES[mesh]
    jm, tm = jax_mesh(shape, axes), make_abstract_mesh(shape, axes)
    for name in INPUT_SHAPES:
        _same_plan(jspecs.plan(arch, name, jm), specs.plan(arch, name, tm))


@pytest.mark.parametrize("override", OVERRIDES,
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items()))
@pytest.mark.parametrize("arch", ["qwen1_5_110b", "llava_next_34b"])
def test_plans_with_overrides_equal_the_reference_s(arch, override):
    for mesh in MESHES.values():
        jm, tm = jax_mesh(*mesh), make_abstract_mesh(*mesh)
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            _same_plan(jspecs.plan(arch, name, jm, **override),
                       specs.plan(arch, name, tm, **override))


def test_plan_config_plans_a_depth_cut_config():
    """`plan_config` on a cut config: the arguments follow the cut and
    the placements split nothing on a 1x1 mesh; its skips are `plan`'s."""
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    cfg = specs.get_config("qwen1.5-110b").replace(n_layers=2)
    p = specs.plan_config(cfg, "decode_32k", mesh)
    assert p.arch == "qwen1_5_110b" and p.kind == "decode"
    k = p.args[1]["0"]["k"]
    assert tuple(k.shape) == (2, 128, 32768, 8, 128)
    assert k.dtype == torch.bfloat16 and k.device.type == "meta"
    # on a 1x1 mesh the specs name axes of extent 1 only: nothing splits
    assert not rules.sharded_axes(
        [s.spec for s in _leaves_port(p.in_shardings)], mesh)
    skip = specs.plan_config(specs.get_config("hubert_xlarge"),
                             "decode_32k", mesh)
    assert isinstance(skip, specs.Skip) and "encoder-only" in skip.reason


# --------------------------------------------------------------------------- #
# update_spec
# --------------------------------------------------------------------------- #

N, K, MB, S = 2, 1, 1, 16
F32 = {"compute_dtype": "float32", "param_dtype": "float32",
       "memory_dtype": "float32"}


def _round_inputs(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (N, K, MB, S)).astype(np.int32)
    active = np.array([True, False])
    return tokens, active, 0.05


def _port_round(cfg, pnp, update_spec):
    tokens, active, eta = _round_inputs(cfg)
    model = build_model(cfg)
    params = params_from_jax(pnp, "cpu")
    G = tree_map(lambda p: torch.zeros((N,) + tuple(p.shape)), params)
    step = make_train_step(model, cfg, N, K, update_spec=update_spec)
    return step(params, G, {"tokens": torch.from_numpy(tokens)},
                torch.from_numpy(active), eta)


def test_update_spec_at_1x1_is_bit_equal_and_holds_the_reference():
    jc, tc = jax_smoke("qwen1_5_110b"), get_smoke_config("qwen1_5_110b")
    jc, tc = jc.replace(**F32), tc.replace(**F32)
    assert tc.sequential_clients
    params = build_model(tc).init(3, device="cpu")
    pnp = params_to_numpy(params)
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    spec = rules.named(mesh, rules.param_specs(params, tc.replace(fsdp=True),
                                               mesh))
    p0, G0, m0 = _port_round(tc, pnp, None)
    p1, G1, m1 = _port_round(tc, pnp, spec)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(tree_leaves(p0) + tree_leaves(G0),
                    tree_leaves(p1) + tree_leaves(G1)):
        assert torch.equal(a, b)
    # the reference's round with its constraint on a 1-device mesh
    dev = np.array(jax.devices()[:1]).reshape(1, 1)
    jmesh = jax.sharding.Mesh(dev, ("data", "model"))
    jparams = jax.tree.map(jnp.asarray, pnp)
    jspec = jax.tree.map(lambda s: JNS(jmesh, s), jrules.param_specs(
        jparams, jc.replace(fsdp=True), jmesh),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    tokens, active, eta = _round_inputs(tc)
    jstep = jax.jit(jsteps.make_train_step(jax_build(jc), jc, N, K,
                                           update_spec=jspec))
    jp, jG, jm = jstep(jparams, jax.tree.map(
        lambda p: jnp.zeros((N,) + p.shape, jnp.float32), jparams),
        {"tokens": jnp.asarray(tokens)}, jnp.asarray(active),
        jnp.float32(eta))
    np.testing.assert_allclose(float(m1["loss"]), float(jm["loss"]),
                               rtol=2e-4, atol=2e-5)
    for a, b in zip(jax.tree.leaves(jp) + jax.tree.leaves(jG),
                    tree_leaves(p1) + tree_leaves(G1)):
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(
            b.numpy(), a, rtol=2e-4,
            atol=2e-5 * max(float(np.abs(a).max()), 1e-30))


@pytest.mark.parametrize("mesh", [((16, 16), ("data", "model")),
                                  ((2, 1), ("data", "model")),
                                  ((1, 2), ("data", "model"))])
def test_update_spec_that_splits_a_leaf_raises_naming_19e(mesh):
    """The spec splits leaves over the abstract mesh's axes; the step runs
    whole on fake tensors, as `roofline.analysis.trace` runs a plan."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tc = get_smoke_config("qwen1_5_110b").replace(**F32)
    m = make_abstract_mesh(*mesh)
    model = build_model(tc)
    outs = []
    with FakeTensorMode():
        params = model.init(3, device="cpu")
        specs = rules.param_specs(params, tc.replace(fsdp=True), m)
        assert rules.sharded_axes(specs, m)
        for spec in (None, rules.named(m, specs)):
            step = make_train_step(model, tc, N, K, update_spec=spec)
            G = tree_map(lambda p: torch.zeros((N,) + tuple(p.shape)),
                         params)
            tokens = torch.zeros((N, K, MB, S), dtype=torch.int32)
            new, G, metrics = step(params, G, {"tokens": tokens},
                                   torch.tensor([True, False]), 0.05)
            outs.append([(tuple(t.shape), t.dtype) for t in tree_leaves(
                [new, G, metrics["loss"]])])
    assert outs[0] == outs[1]
    assert outs[0][:len(tree_leaves(params))] == [
        (tuple(p.shape), p.dtype) for p in tree_leaves(params)]
