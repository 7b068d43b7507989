"""Parity of the port's tabular model and K-step local SGD with the JAX
package's: the same params (carried across with `convert.params_from_jax`)
and the same numpy batches give the same loss, accuracy, gradients and
client updates. Tolerance: rtol 1e-5 (atol 1e-6 for the updates) — both
sides compute in fp32 on the CPU, with matmuls and reductions blocked
differently."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.local_update import client_updates as jax_client_updates
from repro.models import build_model as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.local_update import client_updates
from repro_torch.models import build_model
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

MODELS = ["paper_logistic", "paper_mlp"]


def _params(name, seed=0):
    """Reference params (random init for both models, so the logistic case
    does not sit at its zero init) as numpy."""
    jm = jax_build(jax_smoke(name))
    params = jm.init(jax.random.PRNGKey(seed))
    if name == "paper_logistic":
        params = jax.tree.map(
            lambda p: 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                              p.shape), params)
    return jm, jax.tree.map(np.asarray, params)


def _batch(cfg, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (cfg.d_model,)).astype(np.float32)
    y = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    return {"x": x, "y": y}


def _close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", MODELS)
def test_loss_accuracy_and_gradients_match(name):
    jm, p_np = _params(name)
    tm = build_model(get_smoke_config(name))
    batch = _batch(tm.cfg, (16,))
    p_t = params_from_jax(p_np, "cpu")
    for leaf in tree_leaves(p_t):
        leaf.requires_grad_(True)
    loss_t, aux_t = tm.loss_fn(p_t, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    grads_t = torch.autograd.grad(loss_t, tree_leaves(p_t))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, aux_j), grads_j = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, p_np), jb)
    _close(loss_t.item(), loss_j, 1e-5)
    _close(aux_t["ce"].item(), aux_j["ce"], 1e-5)
    for gt, gj in zip(grads_t, jax.tree.leaves(grads_j)):
        _close(gt, gj, 1e-5, 1e-7)
    with torch.no_grad():
        acc_t = tm.accuracy(p_t, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert acc_t.item() == pytest.approx(float(jm.accuracy(
        jax.tree.map(jnp.asarray, p_np), jb)))
    assert tm.param_count(p_t) == jm.param_count(p_np)


@pytest.mark.parametrize("name", MODELS)
def test_client_updates_match(name):
    jm, p_np = _params(name, seed=3)
    tm = build_model(get_smoke_config(name))
    n, k, mb = tm.cfg.fl_clients, 5, 8
    batch = _batch(tm.cfg, (n, k, mb), seed=1)
    eta, wd = 0.3, 1e-3
    u_j, l_j = jax_client_updates(jm.loss_fn, jax.tree.map(jnp.asarray, p_np),
                                  {k_: jnp.asarray(v) for k_, v in
                                   batch.items()}, jnp.float32(eta), K=k,
                                  weight_decay=wd)
    u_t, l_t = client_updates(tm.loss_fn, params_from_jax(p_np, "cpu"),
                              {k_: torch.from_numpy(v) for k_, v in
                               batch.items()}, eta, K=k, weight_decay=wd)
    _close(l_t, l_j, 1e-5, 1e-6)
    for a, b in zip(tree_leaves(params_to_numpy(u_t)), jax.tree.leaves(u_j)):
        assert a.shape == b.shape and a.dtype == np.float32
        _close(a, b, 1e-5, 1e-6)


def test_init_shapes_match_and_logistic_starts_at_zero():
    for name in MODELS:
        jp = jax_build(jax_smoke(name)).init(jax.random.PRNGKey(0))
        tp = build_model(get_smoke_config(name)).init(0, device="cpu")
        assert ([tuple(x.shape) for x in jax.tree.leaves(jp)]
                == [tuple(x.shape) for x in tree_leaves(tp)])
        if name == "paper_logistic":
            assert all(not x.any() for x in tree_leaves(tp))


def test_convert_round_trip():
    _, p_np = _params("paper_mlp")
    back = params_to_numpy(params_from_jax(p_np, "cpu"))
    for a, b in zip(jax.tree.leaves(p_np), tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", MODELS)
def test_configs_match_reference(name):
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    for port, ref in ((get_config(name), jax_config(name)),
                      (get_smoke_config(name), jax_smoke(name))):
        for field in port.__dataclass_fields__:
            assert getattr(port, field) == getattr(ref, field), field
