"""The port's FedAvg baselines, SGD and update clock against the JAX package's.

  (a) each baseline's `round_step` against the reference's on the same numpy
      inputs over several rounds: BiasedFedAvg, FedAvgIS (with a p = 0
      client that is active anyway), FedAvgSampling and SCAFFOLDSampling;
  (b) `sgd_step` with and without momentum and weight decay;
  (c) `run_fl(uses_update_clock=True)` with FedAvgSampling end to end.

The sampling baselines draw their selection from the round generator, and
torch cannot reproduce the reference's threefry bits: the port's
`FedAvgSampling._resample` is monkeypatched to return the reference's own
`_resample` on the reference's key stream. Selections, masks, counters and
`global_updates` must then be identical; params, state and losses are f32
on both sides, reduced in another order, and agree within atol 1e-6 per
round step and rtol 1e-4, atol 1e-6 over a 10-round run (as
`tests/test_torch_run_fl.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_run_fl import _close, _problem

from repro.configs import get_smoke_config as jax_smoke
from repro.core import BiasedFedAvg as JBiasedFedAvg
from repro.core import FedAvgIS as JFedAvgIS
from repro.core import FedAvgSampling as JFedAvgSampling
from repro.core import SCAFFOLDSampling as JSCAFFOLD
from repro.core import run_fl as jax_run_fl
from repro.models import build_model as jax_build
from repro.optim import sgd_init as jsgd_init
from repro.optim import sgd_step as jsgd_step
from repro_torch.convert import params_from_jax
from repro_torch.core import (BernoulliParticipation, BiasedFedAvg, CAFed,
                              FedAR, FedAvgIS, FedAvgSampling, FedBuffAvg,
                              SCAFFOLDSampling, run_fl)
from repro_torch.models import build_model
from repro_torch.optim import inv_t, sgd_init, sgd_step
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

N = 8
ROUNDS = 6
# client 3 has p = 0 but shows up in some rounds' masks anyway
PROBS = np.array([0.9, 0.5, 0.7, 0.0, 0.3, 1.0, 0.6, 0.4])


def _tree(rng, lead=()):
    return {"w": rng.normal(size=lead + (4, 3)).astype(np.float32),
            "b": rng.normal(size=lead + (3,)).astype(np.float32)}


def _t(tree):
    return params_from_jax(tree, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _assert_trees(port, ref, atol):
    for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


@pytest.fixture
def injected_selection(monkeypatch):
    """Make the port's FedAvgSampling select what the reference selects on
    its key stream. Returns put(selection), which sets what the next round
    step selects."""
    box = {}

    def fake(self, rng, n):
        return torch.from_numpy(np.array(box["sel"]))

    monkeypatch.setattr(FedAvgSampling, "_resample", fake)

    def put(sel):
        box["sel"] = sel
    return put


ALGOS = {
    "biased_fedavg": (lambda: JBiasedFedAvg(), lambda: BiasedFedAvg()),
    "fedavg_is": (lambda: JFedAvgIS(PROBS), lambda: FedAvgIS(PROBS)),
    "fedavg_sampling": (lambda: JFedAvgSampling(s=3),
                        lambda: FedAvgSampling(s=3)),
    "scaffold": (lambda: JSCAFFOLD(s=3, k_steps=2),
                 lambda: SCAFFOLDSampling(s=3, k_steps=2)),
}


@pytest.mark.parametrize("name", list(ALGOS))
def test_round_step_matches_reference(name, injected_selection):
    make_j, make_t = ALGOS[name]
    ja, ta = make_j(), make_t()
    rng = np.random.default_rng(7)
    params = _tree(rng)
    js, ts = ja.init_state(_j(params), N), ta.init_state(_t(params), N)
    jp, tp = _j(params), _t(params)
    key = jax.random.PRNGKey(3)
    n_updates = 0
    for t in range(ROUNDS):
        upd = _tree(rng, (N,))
        losses = rng.random(N).astype(np.float32)
        active = np.ones(N, bool) if t == 0 else rng.random(N) < PROBS
        active[3] = t % 2 == 1              # the p = 0 client, now and then
        eta = 0.5 / (t + 1)
        key, sub = jax.random.split(key)
        injected_selection(JFedAvgSampling(s=3)._resample(sub, N))
        js, jp, jm = ja.round_step(js, jp, _j(upd), jnp.asarray(losses),
                                   jnp.asarray(active), eta, sub)
        ts, tp, tm = ta.round_step(ts, tp, _t(upd), torch.from_numpy(losses),
                                   torch.from_numpy(active), eta,
                                   rng=torch.Generator().manual_seed(0))
        _assert_trees(tp, jp, 1e-6)
        assert sorted(ts) == sorted(js)
        _assert_trees(ts, js, 1e-6)
        assert sorted(tm) == sorted(jm)
        for k in tm:
            np.testing.assert_allclose(_np(tm[k]), _np(jm[k]), atol=1e-6)
        if "t_updates" in ts:
            n_updates = int(ts["t_updates"])
    if name in ("fedavg_sampling", "scaffold"):
        assert 1 < n_updates < ROUNDS   # some rounds waited, some updated


def test_fedavg_is_excludes_zero_probability_clients():
    params = _tree(np.random.default_rng(0))
    algo = FedAvgIS(PROBS)
    state = algo.init_state(_t(params), N)
    upd = _t(_tree(np.random.default_rng(1), (N,)))
    only3 = torch.zeros(N, dtype=torch.bool)
    only3[3] = True
    _, new, _ = algo.round_step(state, _t(params), upd, torch.ones(N),
                                only3, 0.1)
    for a, b in zip(tree_leaves(new), tree_leaves(_t(params))):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_sampling_needs_the_round_generator_and_draws_every_round():
    algo = FedAvgSampling(s=3)
    params = _t(_tree(np.random.default_rng(0)))
    state = algo.init_state(params, N)
    upd = _t(_tree(np.random.default_rng(1), (N,)))
    args = (state, params, upd, torch.ones(N), torch.zeros(N, dtype=bool),
            0.1)
    with pytest.raises(ValueError, match="rng="):
        algo.round_step(*args)
    gen = torch.Generator().manual_seed(5)
    new_state, _, _ = algo.round_step(*args, rng=gen)
    assert int(new_state["selected"].sum()) == 3
    # the draw advanced the generator although nobody completed the round
    assert not bool(new_state["need_resample"])
    assert not torch.equal(gen.get_state(),
                           torch.Generator().manual_seed(5).get_state())


@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.0, 1e-2),
                                         (0.9, 0.0), (0.9, 1e-2)])
def test_sgd_step_matches_reference(momentum, wd):
    rng = np.random.default_rng(11)
    params = _tree(rng)
    jp, tp = _j(params), _t(params)
    jst, tst = jsgd_init(jp, momentum), sgd_init(tp, momentum)
    assert sorted(tst) == sorted(jst)
    for _ in range(3):
        grads = _tree(rng)
        jp, jst = jsgd_step(jp, _j(grads), jst, eta=0.05, momentum=momentum,
                            weight_decay=wd)
        tp, tst = sgd_step(tp, _t(grads), tst, eta=0.05, momentum=momentum,
                           weight_decay=wd)
        _assert_trees(tp, jp, 1e-6)
        _assert_trees(tst, jst, 1e-6)


def _reference_selections(seed: int, rounds: int, s: int, n: int) -> list:
    """What the reference's FedAvgSampling selects in each round of a run
    seeded with `seed`: its round key splits once a round from
    PRNGKey(seed)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(JFedAvgSampling(s)._resample(sub, n)))
    return out


def inject_reference_selections(monkeypatch, seeds, rounds, s, n):
    """Patch the port's `_resample` to replay, for the run whose round
    generator was seeded with seed, the reference's selections."""
    streams = {seed: iter(_reference_selections(seed, rounds, s, n))
               for seed in seeds}
    monkeypatch.setattr(
        FedAvgSampling, "_resample",
        lambda self, rng, n: torch.from_numpy(
            np.array(next(streams[rng.initial_seed()]))))


def test_run_fl_update_clock_matches_reference(monkeypatch):
    name, rounds, seed = "paper_logistic", 10, 4
    cfg, batcher, probs, _ = _problem(name)
    n = cfg.fl_clients
    inject_reference_selections(monkeypatch, [seed], rounds, n // 2, n)
    jparams = jax_build(jax_smoke(name)).init(jax.random.PRNGKey(0))
    from repro.core import BernoulliParticipation as JBernoulli
    kw = dict(batcher=batcher, schedule=inv_t(1.0), n_rounds=rounds,
              weight_decay=1e-3, seed=seed, uses_update_clock=True)
    pj, hj = jax_run_fl(model=jax_build(jax_smoke(name)),
                        algo=JFedAvgSampling(s=n // 2),
                        participation=JBernoulli(probs, seed=1),
                        params=jparams, **kw)
    pt, ht = run_fl(model=build_model(cfg), algo=FedAvgSampling(s=n // 2),
                    participation=BernoulliParticipation(probs, seed=1),
                    params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                           "cpu"), device="cpu", **kw)
    assert ht.global_updates == hj.global_updates
    assert 1 < ht.global_updates[-1] < rounds     # the clock lags the rounds
    assert ht.n_active == hj.n_active
    _close(ht.train_loss, hj.train_loss, 1e-4, 1e-6)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        _close(a.numpy(), np.asarray(b), 1e-4, 1e-6)


@pytest.mark.parametrize("cls", [FedAR, CAFed, FedBuffAvg])
def test_other_algorithms_are_not_ported(cls):
    """ROADMAP Queue 1 item 14 is ported: each algorithm builds and runs a
    round (its parity tests are in `tests/test_torch_algorithms.py`); with
    every client active FedAR and FedBuffAvg take the plain mean step, and
    CAFed weights it by 1/π̂ with π̂ = 0.5 + 0.1·(1 − 0.5) after a round."""
    algo = cls()
    params = {"w": torch.zeros(3)}
    upd = {"w": torch.arange(12, dtype=torch.float32).reshape(4, 3)}
    state = algo.init_state(params, 4)
    state, new, metrics = algo.round_step(
        state, params, upd, torch.ones(4), torch.ones(4, dtype=torch.bool),
        0.5)
    assert int(state["t"]) == 1 and float(metrics["n_active"]) == 4
    scale = 1.0 / 0.55 if cls is CAFed else 1.0
    assert torch.allclose(new["w"], -0.5 * upd["w"].mean(0) * scale)
