"""The port's int8 memory against the JAX package's: the quantizer
(`core.quantized_memory`), `MIFA(memory="int8")`, `Int8PagedBank` and
`PagedDeviceBank(dtype="int8")`.

The scale is deterministic and must be array-equal to the reference's.
The rounding noise comes from a torch generator here and from
`jax.random` there, so everything that depends on it is held by
statistics: each stored value is floor(x/scale) or one step above it, the
round trip is within one quantum, the mean over generator seeds is within
4·quantum/√reps of x (the reference's own bound), and a 20-round MIFA(int8)
run stays near MIFA(array).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantized_memory as jqm
from repro_torch.bank import BankedMIFA, Int8PagedBank, PagedDeviceBank
from repro_torch.core import MIFA, BernoulliParticipation, run_fl
from repro_torch.core import quantized_memory as qm
from repro_torch.optim import inv_t
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-4, 1.0, 37.0])
def test_scale_equals_reference_and_rounding_brackets(scale):
    x = _x(0, (5, 3, 11), scale)
    q, s = qm.quantize_leaf(_gen(1), torch.from_numpy(x))
    _, js = jqm.quantize_leaf(jax.random.PRNGKey(1), jnp.asarray(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    lo = np.floor(x / s.numpy()[:, None, None])
    step = q.numpy().astype(np.float64) - lo
    clipped = np.abs(q.numpy()) == 127
    assert np.isin(step[~clipped], (0.0, 1.0)).all()
    back = qm.dequantize_leaf(q, s).numpy()
    quantum = s.numpy()[:, None, None]
    assert (np.abs(back - x) <= quantum + 1e-12).all()


def test_stochastic_rounding_unbiased_over_generator_seeds():
    x = torch.from_numpy(_x(7, (2, 24), 0.5))
    reps = 400
    acc = torch.zeros_like(x)
    for i in range(reps):
        acc += qm.dequantize_leaf(*qm.quantize_leaf(_gen(i), x))
    quantum = float(x.abs().max()) / 127.0
    np.testing.assert_allclose((acc / reps).numpy(), x.numpy(),
                               atol=4 * quantum / np.sqrt(reps) + 1e-7)


def test_zero_rows_clip_and_tree():
    q, s = qm.quantize_leaf(_gen(0), torch.zeros(3, 16))
    assert not q.any() and bool((s > 0).all())
    assert not qm.dequantize_leaf(q, s).any()
    q, s = qm.quantize_leaf(_gen(1), torch.tensor([[3.0, -3.0, 1.5, 0.0]]))
    assert q[0, 0] == 127 and q[0, 1] == -127 and q.abs().max() <= 127
    np.testing.assert_allclose(qm.dequantize_leaf(q, s)[0, :2].numpy(),
                               [3.0, -3.0], rtol=1e-6)
    tree = {"w": torch.from_numpy(_x(3, (4, 3, 2))),
            "b": [torch.from_numpy(_x(4, (4, 5)))]}
    qt, st = qm.quantize_tree(_gen(2), tree)
    for leaf, orig in zip(tree_leaves(qm.dequantize_tree(qt, st)),
                          tree_leaves(tree)):
        n = orig.shape[0]
        quantum = orig.reshape(n, -1).abs().amax(1) / 127.0
        err = (leaf - orig).reshape(n, -1).abs()
        assert bool((err <= quantum[:, None] + 1e-12).all())
    assert all(q.dtype == torch.int8 for q in tree_leaves(qt))


def _params():
    return {"w": torch.from_numpy(_x(10, (4, 3))),
            "b": torch.from_numpy(_x(11, (3,)))}


def _updates(seed, c):
    return {"w": torch.from_numpy(_x(seed, (c, 4, 3))),
            "b": torch.from_numpy(_x(seed + 1, (c, 3)))}


def _check_g_sum(mean_g, n, rows):
    """G_sum (read as n · mean_g) against the sum of the dequantized rows:
    the same values summed in another order."""
    for g, r in zip(tree_leaves(mean_g), tree_leaves(rows)):
        assert torch.allclose(g.double() * n, r.double().sum(0), rtol=1e-5,
                              atol=1e-6)


@pytest.mark.parametrize("bank_kind", ["int8_paged", "paged_device_int8"])
def test_int8_banks_keep_g_sum_of_dequantized_rows(bank_kind):
    n = 8
    bank = (Int8PagedBank(page_size=2, device="cpu")
            if bank_kind == "int8_paged"
            else PagedDeviceBank(page_size=2, n_slots=2, dtype="int8",
                                 device="cpu"))
    state = bank.init(_params(), n)
    gen = _gen(5)
    cohorts = [[0, 1, 4], [2, 6], [1, 5], [0, 7], [3]]
    for r, ids in enumerate(cohorts):
        ids = np.array(ids)
        upd = _updates(20 + r, len(ids))
        state = bank.scatter(state, ids, upd, rng=gen)
        rows = bank.gather(state, ids)
        for leaf, u in zip(tree_leaves(rows), tree_leaves(upd)):
            quantum = u.reshape(len(ids), -1).abs().amax(1) / 127.0
            err = (leaf - u).reshape(len(ids), -1).abs()
            assert bool((err <= quantum[:, None] + 1e-12).all())
    _check_g_sum(bank.mean_g(state), n, bank.gather(state, np.arange(n)))
    if bank_kind == "paged_device_int8":
        assert bank.evictions > 0 and bank.refaults > 0
        bank.check_invariants(state)


def test_int8_scatter_needs_a_generator():
    bank = PagedDeviceBank(page_size=2, dtype="int8", device="cpu")
    state = bank.init(_params(), 4)
    with pytest.raises(ValueError, match="rng="):
        bank.scatter(state, np.array([0]), _updates(0, 1))
    with pytest.raises(ValueError, match="rng="):
        MIFA(memory="int8").round_step(
            MIFA(memory="int8").init_state(_params(), 2), _params(),
            _updates(0, 2), torch.zeros(2), torch.ones(2, dtype=bool), 0.1)


def _problem():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import (ClientBatcher, label_skew_partition,
                                  make_classification)
    from repro_torch.models import build_model
    cfg = get_smoke_config("paper_mlp")
    n = cfg.fl_clients
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    idx, labels = label_skew_partition(y, n, seed=0)
    from repro_torch.core import label_correlated_probs
    probs = label_correlated_probs(labels, p_min=0.1)
    batcher = ClientBatcher(X, y, idx, batch_size=8, k_steps=5, seed=0)
    return build_model(cfg), batcher, probs


# The int8 memory's rounding moves each stored update by at most one
# quantum (absmax/127 of its row), so over 20 rounds an int8 run's losses
# stay within a few per mille of the float run's. From the reference's
# params, the largest relative gaps to the reference's MIFA(array) losses
# measured on this problem: port MIFA(int8) 3.4e-3,
# BankedMIFA(PagedDeviceBank(int8)) 2.5e-3, BankedMIFA(Int8PagedBank)
# 2.2e-3, the reference's own MIFA(int8) 1.9e-3 (from the port's seeds 0-2
# and its own init: up to 1.1e-2). The bound sits above all of them.
INT8_LOSS_RTOL = 2e-2


def test_mifa_int8_run_stays_near_mifa_array():
    from repro.configs import get_smoke_config as jax_smoke
    from repro.core import BernoulliParticipation as JBernoulli
    from repro.core import MIFA as JMIFA
    from repro.core import run_fl as jax_run_fl
    from repro.models import build_model as jax_build
    from repro_torch.convert import params_from_jax
    model, batcher, probs = _problem()
    jmodel = jax_build(jax_smoke("paper_mlp"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    ref = {}
    for memory in ("array", "int8"):
        ref[memory] = jax_run_fl(model=jmodel, algo=JMIFA(memory=memory),
                                 participation=JBernoulli(probs, seed=1),
                                 batcher=batcher, schedule=inv_t(1.0),
                                 n_rounds=20, weight_decay=1e-3,
                                 params=jparams)[1]
    want = np.asarray(ref["array"].train_loss)
    np.testing.assert_allclose(ref["int8"].train_loss, want,
                               rtol=INT8_LOSS_RTOL)
    for algo in (MIFA(memory="int8"),
                 BankedMIFA(PagedDeviceBank(page_size=4, dtype="int8",
                                            device="cpu")),
                 BankedMIFA(Int8PagedBank(page_size=4, device="cpu"))):
        _, hist = run_fl(model=model, algo=algo, batcher=batcher,
                         participation=BernoulliParticipation(probs, seed=1),
                         schedule=inv_t(1.0), n_rounds=20, weight_decay=1e-3,
                         params=params_from_jax(
                             jax.tree.map(np.asarray, jparams), "cpu"),
                         device="cpu")
        got = np.asarray(hist.train_loss)
        assert np.isfinite(got).all()
        assert hist.n_active == ref["array"].n_active
        np.testing.assert_allclose(got, want, rtol=INT8_LOSS_RTOL)
        assert not np.array_equal(got, want)      # the rounding did act
