"""The port's step builders (`launch.steps`) against the JAX package's, on the
CPU, mirroring `tests/test_launch_steps.py`: `make_train_step` in its vmap
mode (server step through `mifa_aggregate_tree`) and its sequential mode
(qwen's client loop) against the reference's jitted steps from the same
params (the port's init, as numpy) and batch; the two modes against each
other (granite-3-8b and olmoe-1b-7b); inactive clients keep their memory;
the serve-step wrappers.

Tolerance: the f32 model bounds, rtol 2e-4 and atol 2e-5 scaled by each
leaf's largest |value| (`test_torch_train.py`): K=2 local steps in f32 on
both sides, blocked differently.

The `cuda` cases run the vmap step and `train()` on the card (the
`mifa_aggregate` kernel) against the CPU and skip here; JAX is imported
only inside the reference tests, so on the card they run with
`--noconftest -m cuda`.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mifa_aggregate import mifa_aggregate
from repro_torch.launch.steps import (make_decode_step, make_encoder_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

N, K, MB, S = 4, 2, 2, 32
ACTIVE = np.array([True, False, True, True])
ETA = 0.05
RTOL, ATOL = 2e-4, 2e-5


def _cfg(arch="granite_3_8b", sequential=False):
    return get_smoke_config(arch).replace(
        compute_dtype="float32", param_dtype="float32", fl_clients=N,
        fl_local_steps=K, sequential_clients=sequential)


def _inputs(cfg, device="cpu", g_fill=0.0):
    """Params (the port's init), the batch, G and the mask on `device`."""
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (N, K, MB, S)).astype(np.int32)
    params = tree_map(lambda p: p.to(device), params)
    G = tree_map(lambda p: torch.full((N,) + tuple(p.shape), g_fill,
                                      device=device), params)
    return (model, params, {"tokens": torch.from_numpy(toks).to(device)}, G,
            torch.from_numpy(ACTIVE).to(device))


def _close(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL * max(float(np.abs(ref).max()),
                                               1e-30))


@pytest.mark.parametrize("sequential", [False, True])
def test_train_step_matches_reference(sequential):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.steps import make_train_step as jax_make_train_step
    from repro.models import build_model as jax_build
    from repro_torch.convert import params_to_numpy
    cfg = _cfg(sequential=sequential)
    model, params, batch, G, active = _inputs(cfg)
    jcfg = jax_smoke("granite_3_8b").replace(
        compute_dtype="float32", param_dtype="float32", fl_clients=N,
        fl_local_steps=K, sequential_clients=sequential)
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(params))
    jstep = jax.jit(jax_make_train_step(jax_build(jcfg), jcfg, N, K))
    jp, jG, jm = jstep(
        jparams, jax.tree.map(lambda p: jnp.zeros((N,) + p.shape), jparams),
        {"tokens": jnp.asarray(batch["tokens"].numpy())},
        jnp.asarray(ACTIVE), jnp.float32(ETA))
    step = make_train_step(model, cfg, N, K)
    tp, tG, tm = step(params, G, batch, active, ETA)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL, atol=ATOL)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        _close(a, b)
    for a, b in zip(jax.tree.leaves(jG), tree_leaves(tG)):
        _close(a, b)


def test_sequential_train_step_matches_vmap():
    """The memory-saving client loop computes the same round (within f32:
    it sums G rows one by one where the kernel's plain version takes the
    mean)."""
    _vmap_vs_sequential("granite_3_8b")


def test_sequential_train_step_matches_vmap_moe():
    """The same for olmoe-1b-7b: MoE routing of each client's tokens under
    `torch.func.vmap` against one client at a time."""
    _vmap_vs_sequential("olmoe_1b_7b")


def _vmap_vs_sequential(arch):
    cfg = _cfg(arch)
    model, params, batch, G, active = _inputs(cfg)
    p1, G1, m1 = make_train_step(model, cfg, N, K)(params, G, batch, active,
                                                   ETA)
    cfg_s = cfg.replace(sequential_clients=True)
    _, params, batch, G, active = _inputs(cfg_s)
    p2, G2, m2 = make_train_step(model, cfg_s, N, K)(params, G, batch,
                                                     active, ETA)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p1) + tree_leaves(G1),
                    tree_leaves(p2) + tree_leaves(G2)):
        _close(a.numpy(), b)


@pytest.mark.parametrize("sequential", [False, True])
def test_inactive_clients_do_not_move_their_memory(sequential):
    cfg = _cfg(sequential=sequential)
    model, params, batch, G, active = _inputs(cfg, g_fill=7.0)
    _, G1, _ = make_train_step(model, cfg, N, K)(params, G, batch, active,
                                                 ETA)
    for leaf in tree_leaves(G1):
        # client 1 is inactive: its stored update stays the sentinel
        assert bool((leaf[1] == 7.0).all())
        assert not bool((leaf[0] == 7.0).all())


def test_update_spec_is_not_ported():
    """update_spec= is ported, and so is its placement: a spec that keeps
    every leaf whole changes nothing, and on an abstract
    2x2 mesh, whose spec splits leaves over `data` and `model`, the spec
    places nothing and the whole step runs, bit-equal to the step
    without it (a world of ranks places it:
    `tests/test_torch_param_placement_world.py`)."""
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.sharding import rules
    cfg = _cfg(sequential=True)
    model, params, batch, G, active = _inputs(cfg)
    fsdp = cfg.replace(fsdp=True)
    plain = make_train_step(model, cfg, N, K)(
        params, tree_map(torch.clone, G), batch, active, ETA)
    for shape in ((1, 1), (2, 2)):
        mesh = make_abstract_mesh(shape, ("data", "model"))
        specs = rules.param_specs(params, fsdp, mesh)
        assert bool(rules.sharded_axes(specs, mesh)) == (shape == (2, 2))
        spec = rules.named(mesh, specs)
        out = make_train_step(model, cfg, N, K, update_spec=spec)(
            params, tree_map(torch.clone, G), batch, active, ETA)
        for a, b in zip(tree_leaves([*plain[:2], plain[2]["loss"]]),
                        tree_leaves([*out[:2], out[2]["loss"]])):
            assert torch.equal(a, b)


def test_serve_steps_wrap_the_model():
    cfg = get_smoke_config("zamba2_7b").replace(
        compute_dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17)))
    want, cache = model.prefill(params, {"tokens": toks[:, :16]},
                                model.init_cache(2, 17, device="cpu"))
    got, cache2 = make_prefill_step(model)(
        params, model.init_cache(2, 17, device="cpu"),
        {"tokens": toks[:, :16]})
    assert torch.equal(got, want)
    want, _ = model.decode_step(params, toks[:, 16:], 16, cache)
    got, _ = make_decode_step(model)(params, cache2, toks[:, 16:], 16)
    assert torch.equal(got, want)
    ce = make_encoder_step(model)(params, {"tokens": toks})
    assert torch.equal(ce, model.loss_fn(params, {"tokens": toks})[1]["ce"])


# --------------------------------------------------------------------------- #
# on the card: the server step through the mifa_aggregate kernel
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mifa_aggregate kernel has no "
                    "CPU or interpret mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """The vmap step on the card (one kernel launch for the tree's one
    leaf table) against the CPU's plain server step, f32."""
    cfg = _cfg()
    step = make_train_step(build_model(cfg), cfg, N, K)
    outs = {}
    for dev in ("cpu", cuda_device):
        _, params, batch, G, active = _inputs(cfg, device=dev)
        before = mifa_aggregate.launches
        outs[dev] = step(params, G, batch, active, ETA)
        launched = mifa_aggregate.launches - before
        assert launched == (1 if dev == cuda_device else 0)
    for a, b in zip(tree_leaves(list(outs["cpu"][:2])),
                    tree_leaves(list(outs[cuda_device][:2]))):
        _close(a.numpy(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_3_8b", "zamba2_7b",
                                  "olmoe_1b_7b", "deepseek_v2_lite_16b"])
def test_cuda_train_matches_cpu(cuda_device, arch):
    """Three rounds of `train()` on the card (the server step through the
    kernel, one launch a round) against the CPU from the same params,
    f32; olmoe's and deepseek's MoE layers route every client's tokens on
    the card, and deepseek's MLA trains through `blockwise_attention`."""
    from repro_torch.launch.train import train
    cfg = get_smoke_config(arch).replace(compute_dtype="float32",
                                         param_dtype="float32")
    params = build_model(cfg).init(0, device="cpu")
    outs = {}
    for dev in ("cpu", cuda_device):
        before = mifa_aggregate.launches
        outs[dev] = train(cfg=cfg, rounds=3, clients=N, k_steps=K, mb=MB,
                          seq=S, device=dev,
                          params=tree_map(lambda p: p.to(dev), params))
        assert mifa_aggregate.launches - before == (
            3 if dev == cuda_device else 0)
    np.testing.assert_allclose(outs[cuda_device]["losses"],
                               outs["cpu"]["losses"], rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_leaves(outs["cpu"]["params"]),
                    tree_leaves(outs[cuda_device]["params"])):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-4 * float(a.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert_xlarge", "llava_next_34b"])
def test_cuda_stub_frontend_train_step_matches_cpu(cuda_device, arch):
    """One `make_train_step` round of the stub-frontend models on the card
    against the CPU, f32: hubert's vmap mode (frames and labels; one
    kernel launch, its unread `embed` leaf's zero update included) and
    llava's sequential mode (tokens and patches, no kernel)."""
    cfg = get_smoke_config(arch).replace(
        compute_dtype="float32", param_dtype="float32", fl_clients=N,
        fl_local_steps=K)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(1)
    if cfg.modality == "audio":
        batch = {"frames": rng.normal(size=(N, K, MB, S, cfg.d_model)),
                 "labels": rng.integers(0, cfg.vocab_size, (N, K, MB, S))}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (N, K, MB, S)),
                 "patches": 0.02 * rng.normal(
                     size=(N, K, MB, cfg.n_patches, cfg.d_model))}
    step = make_train_step(model, cfg, N, K)
    outs = {}
    for dev in ("cpu", cuda_device):
        G = tree_map(lambda p: torch.zeros((N,) + tuple(p.shape),
                                           device=dev), params)
        before = mifa_aggregate.launches
        outs[dev] = step(
            tree_map(lambda p: p.to(dev), params), G,
            {k: torch.from_numpy(v.astype(np.float32 if v.dtype.kind == "f"
                                          else np.int32)).to(dev)
             for k, v in batch.items()},
            torch.from_numpy(ACTIVE).to(dev), ETA)
        assert mifa_aggregate.launches - before == (
            1 if dev == cuda_device and not cfg.sequential_clients else 0)
    for a, b in zip(tree_leaves(list(outs["cpu"][:2])),
                    tree_leaves(list(outs[cuda_device][:2]))):
        _close(a.numpy(), b)
