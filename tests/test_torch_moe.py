"""Parity of the port's MoE block (`repro_torch.models.moe`) with the JAX
package's `repro/models/moe.py`, on the CPU.

The same numpy inputs, made from a seed, go through both. Cases:
* `no_drop`: capacity_factor 2 at E=4, k=2, so C = T and nothing drops;
* `overflow`: a skewed router sends every token to experts 0 and 1, whose
  runs pass C; the reference writes the pad token and gate 0 into slot
  C-1 after the last kept assignment, so an overflowing expert keeps C-1
  tokens (pinned here, slot by slot);
* `shared`: two shared experts beside E=8;
* `decode`: T=4 tokens (a decode step of 4 sequences) at E=8, k=4: C=3.

The reference's router probabilities and its (E, C) routing table and
gates are read from its own jaxpr (the input of its `top_k` and the
outputs of its two `scatter`s). The port's router probabilities are held
to the f32 bound (the two router products are blocked differently, so
their last bits differ), and the port's `route` of the reference's
probabilities must give the reference's table and gates exactly.
Outputs and the load-balance loss are held at the model bounds of
`test_torch_models.py` (f32 rtol 2e-4 / atol 2e-5, bf16 rtol 3e-2 / atol
0.1), gradients of (y·r).sum() + aux at the f32 bound
with atol scaled by each leaf's largest |value| (`test_torch_train.py`),
and `torch.func.vmap` of the gradient over a client axis against a loop.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.models import moe as jax_moe
from repro_torch.models import moe
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

TOL = {"float32": (2e-4, 2e-5), "bfloat16": (3e-2, 0.1)}
# name -> (B, S, d, E, k, capacity_factor, n_shared, skewed router)
CASES = {"no_drop": (2, 16, 16, 4, 2, 2.0, 0, False),
         "overflow": (1, 64, 16, 4, 2, 1.25, 0, True),
         "shared": (2, 16, 16, 8, 2, 1.25, 2, False),
         "decode": (4, 1, 16, 8, 4, 1.25, 0, False)}
F_EXPERT = 12


def _inputs(name, seed=0):
    """x (B,S,d), params and a cotangent r, numpy f32."""
    B, S, d, E, k, _, n_shared, skewed = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    p = {"router": (0.02 * rng.normal(size=(d, E))).astype(np.float32),
         "w1": (rng.normal(size=(E, d, F_EXPERT)) / 4).astype(np.float32),
         "w3": (rng.normal(size=(E, d, F_EXPERT)) / 4).astype(np.float32),
         "w2": (rng.normal(size=(E, F_EXPERT, d)) / 3).astype(np.float32)}
    if n_shared:
        w = F_EXPERT * n_shared
        p["shared"] = {
            "w1": (rng.normal(size=(d, w)) / 4).astype(np.float32),
            "w3": (rng.normal(size=(d, w)) / 4).astype(np.float32),
            "w2": (rng.normal(size=(w, d)) / 5).astype(np.float32)}
    if skewed:
        # feature 0 is large and positive for every token, and experts 0
        # and 1 weigh it heavily: every token picks both
        x[..., 0] = 3.0 + np.abs(x[..., 0])
        p["router"][0, :2] = [2.0, 1.9]
    r = rng.normal(size=(B, S, d)).astype(np.float32)
    return x, p, r


def _kw(name):
    _, _, _, _, k, cf, _, _ = CASES[name]
    return dict(top_k=k, capacity_factor=cf, aux_coef=0.01)


def _t(tree, dtype=torch.float32):
    """numpy tree -> torch, the router kept in f32 as the reference keeps
    it."""
    def conv(path_key, a):
        t = torch.from_numpy(np.asarray(a))
        return t if path_key == "router" else t.to(dtype)
    if isinstance(tree, dict):
        return {k: (_t(v, dtype) if isinstance(v, dict) else conv(k, v))
                for k, v in tree.items()}
    return conv(None, tree)


def _j(tree, dtype=jnp.float32):
    if isinstance(tree, dict):
        return {k: (_j(v, dtype) if isinstance(v, dict) else
                    jnp.asarray(v) if k == "router" else
                    jnp.asarray(v, dtype)) for k, v in tree.items()}
    return jnp.asarray(tree, dtype)


def reference_routing(params, x, **kw):
    """The reference's router probabilities (T,E) and its (E, C) routing
    table and gates: the input of the `top_k` equation and the outputs of
    the two `scatter` equations of its `moe_apply`, read by evaluating its
    jaxpr equation by equation."""
    closed = jax.make_jaxpr(functools.partial(jax_moe.moe_apply, **kw))(
        params, x)

    @jax.jit
    def run(leaves):
        env = dict(zip(closed.jaxpr.constvars, closed.consts))
        env.update(zip(closed.jaxpr.invars, leaves))
        picked = []
        for eqn in closed.jaxpr.eqns:
            args = [v.val if hasattr(v, "val") else env[v]
                    for v in eqn.invars]
            subfuns, bind_params = eqn.primitive.get_bind_params(eqn.params)
            outs = eqn.primitive.bind(*subfuns, *args, **bind_params)
            outs = outs if eqn.primitive.multiple_results else [outs]
            env.update(zip(eqn.outvars, outs))
            if eqn.primitive.name == "top_k":
                picked.append(args[0])
            if eqn.primitive.name == "scatter":
                picked.append(outs[0])
        return picked

    probs, table, gates = map(np.asarray, run(jax.tree.leaves((params, x))))
    assert table.dtype == np.int32 and gates.dtype == np.float32
    return probs, table, gates


def _close(ref, got, dtype="float32", scaled=False):
    rtol, atol = TOL[dtype]
    ref = np.asarray(ref, np.float32)
    if scaled:
        atol = atol * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_routing_table_and_gates_exact(name):
    x, p, _ = _inputs(name)
    B, S, d, E, k, cf, _, skewed = CASES[name]
    probs, table, gates = reference_routing(_j(p), _j(x), **_kw(name))
    _close(probs, moe.router_probs(_t(p)["router"],
                                   _t(x).reshape(B * S, d)))
    r = moe.route(torch.tensor(probs), k, cf)
    C = moe.capacity(B * S, k, E, cf)
    assert table.shape == (E, C) == tuple(r.table.shape)
    np.testing.assert_array_equal(r.table.numpy(), table)
    np.testing.assert_array_equal(r.table_gates.numpy(), gates)
    # the assignments that hold a slot are the table's filled slots
    assert int(r.kept().sum()) == int((table < B * S).sum())
    if skewed:
        for e in (0, 1):
            # every token picked expert e: C-1 slots kept, slot C-1 the pad
            assert list(table[e, :C - 1]) == list(range(C - 1))
            assert table[e, C - 1] == B * S and gates[e, C - 1] == 0.0
            assert int((r.kept() & (r.expert_ids == e)).sum()) == C - 1
    if name == "no_drop":
        assert bool(r.kept().all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_reference(name, dtype):
    x, p, _ = _inputs(name, seed=1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jy, jaux = jax.jit(functools.partial(jax_moe.moe_apply, **_kw(name)))(
        _j(p, jdt), _j(x, jdt))
    ty, taux = moe.moe_apply(_t(p, tdt), _t(x, tdt), **_kw(name))
    assert ty.dtype == tdt and taux.dtype == torch.float32
    assert tuple(ty.shape) == x.shape
    _close(jy, ty, dtype)
    _close(jaux, taux, dtype)


def _loss_j(params, x, r, kw):
    y, aux = jax_moe.moe_apply(params, x, **kw)
    return (y * r).sum() + aux


def _loss_t(params, x, r, kw):
    y, aux = moe.moe_apply(params, x, **kw)
    return (y * r).sum() + aux


@pytest.mark.parametrize("name", list(CASES))
def test_moe_grads_match_reference(name):
    """Gradients for x, the router, w1, w2, w3 (and the shared experts')."""
    x, p, r = _inputs(name, seed=2)
    kw = _kw(name)
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(
        functools.partial(_loss_j, kw=kw), argnums=(0, 1)))(
        _j(p), _j(x), _j(r))
    (tgp, tgx), tl = grad_and_value(
        functools.partial(_loss_t, kw=kw), argnums=(0, 1))(
        _t(p), _t(x), _t(r))
    _close(jl, tl)
    _close(jgx, tgx, scaled=True)
    jleaves, tleaves = jax.tree.leaves(jgp), tree_leaves(tgp)
    assert len(jleaves) == len(tleaves) == len(tree_leaves(_t(p)))
    for a, b in zip(jleaves, tleaves):
        assert float(np.abs(np.asarray(a)).max()) > 0
        _close(a, b, scaled=True)


@pytest.mark.parametrize("name", ["overflow", "shared", "decode"])
def test_moe_vmap_grad_matches_loop(name):
    """`torch.func.vmap` of the gradient over a client axis of 3 (each
    client its own params and tokens), as the training step vmaps clients,
    against one call a client."""
    trees = [_inputs(name, seed=s) for s in (3, 4, 5)]
    kw = _kw(name)
    fn = grad_and_value(functools.partial(_loss_t, kw=kw), argnums=(0, 1))
    stack = functools.partial(torch.stack, dim=0)
    params = tree_map(lambda *a: stack(list(a)), *[_t(t[1]) for t in trees])
    xs = stack([_t(t[0]) for t in trees])
    rs = stack([_t(t[2]) for t in trees])
    (gp, gx), loss = vmap(fn)(params, xs, rs)
    for c, (x, p, r) in enumerate(trees):
        (lgp, lgx), ll = fn(_t(p), _t(x), _t(r))
        _close(ll.numpy(), loss[c])
        _close(lgx.numpy(), gx[c], scaled=True)
        for a, b in zip(tree_leaves(lgp), tree_leaves(gp)):
            _close(a.numpy(), b[c], scaled=True)


def test_capacity_is_the_reference_formula():
    """C = ceil(T·k/E · capacity_factor) per call: a decode step of 4
    sequences at olmoe's and moonshot's served factor has one slot an
    expert; their 4 × 2048-token prefills 1280 and 960."""
    assert moe.capacity(4, 8, 64, 1.25) == 1
    assert moe.capacity(4, 6, 64, 1.25) == 1
    assert moe.capacity(4 * 2048, 8, 64, 1.25) == 1280
    assert moe.capacity(4 * 2048, 6, 64, 1.25) == 960
    assert moe.capacity(288, 8, 64, 64 / 8) == 288
