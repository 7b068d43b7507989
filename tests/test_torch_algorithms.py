"""The port's other algorithms (FedAR, CAFed, FedBuffAvg) and the algorithm
registry against the JAX package's, on the CPU.

  (a) each algorithm's `round_step` against the reference's on the same
      numpy inputs over several rounds (CAFed with its exclusion rule
      firing, FedBuffAvg with a bool mask and with f32 weights): state,
      params and metrics within atol 1e-6 per step (f32, reduced in
      another order);
  (b) the registry: names, `assumes` tags, factories' kwargs and errors
      equal to the reference's;
  (c) `run_fl(scenario=)` against the reference's from the reference's
      params: n_active and τ equal, losses and params within
      `tests/test_torch_run_fl.py`'s bounds (rtol 1e-4, atol 1e-6);
  (d) within the port, FedAR at decay 0 is BiasedFedAvg and FedBuffAvg
      with a bool mask is BiasedFedAvg, bit for bit; FedAR at decay 1 is
      MIFA's memory average within rtol 1e-6;
  (e) every registered algorithm × every registered scenario × both
      engines runs and stays finite, as the reference's
      `tests/test_baseline_atlas.py` holds its atlas.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scenarios import (N, _jax_run, _jparams, _run, _tparams,
                                  assert_matches_reference)

from repro.core import CAFed as JCAFed
from repro.core import FedAR as JFedAR
from repro.core import FedBuffAvg as JFedBuffAvg
from repro.core import algorithm_assumes as jalgorithm_assumes
from repro.core import algorithm_names as jalgorithm_names
from repro.core import make_algorithm as jmake_algorithm
from repro.scenarios import make_scenario as jmake_scenario
from repro_torch.bank import BankedMIFA
from repro_torch.convert import params_from_jax
from repro_torch.core import (MIFA, BiasedFedAvg, CAFed, FedAR, FedBuffAvg,
                              algorithm_assumes, algorithm_names,
                              make_algorithm, register_algorithm)
from repro_torch.scenarios import make_scenario, scenario_names
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ROUNDS = 8


def _tree(rng, lead=()):
    return {"w": rng.normal(size=lead + (4, 3)).astype(np.float32),
            "b": rng.normal(size=lead + (3,)).astype(np.float32)}


def _assert_trees(port, ref, atol):
    for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.double().numpy(),
                                       np.asarray(b, np.float64), rtol=0,
                                       atol=atol)


STEP_CASES = {
    "fedar": (lambda: JFedAR(), lambda: FedAR(), "mask"),
    "fedar_decay0": (lambda: JFedAR(decay=0.0), lambda: FedAR(decay=0.0),
                     "mask"),
    "fedar_decay0.9": (lambda: JFedAR(decay=0.9), lambda: FedAR(decay=0.9),
                       "mask"),
    "ca_fed": (lambda: JCAFed(), lambda: CAFed(), "mask"),
    "ca_fed_excluding": (lambda: JCAFed(rho=0.5, d_max=0.55),
                         lambda: CAFed(rho=0.5, d_max=0.55), "mask"),
    "fedbuff_mask": (lambda: JFedBuffAvg(), lambda: FedBuffAvg(), "mask"),
    "fedbuff_weights": (lambda: JFedBuffAvg(), lambda: FedBuffAvg(),
                        "weights"),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_round_step_matches_reference(name):
    make_j, make_t, kind = STEP_CASES[name]
    ja, ta = make_j(), make_t()
    rng = np.random.default_rng(5)
    params = _tree(rng)
    js = ja.init_state(jax.tree.map(jnp.asarray, params), N)
    ts = ta.init_state(params_from_jax(params, "cpu"), N)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_jax(params,
                                                                "cpu")
    excluded = 0
    for t in range(ROUNDS):
        upd = _tree(rng, (N,))
        losses = rng.random(N).astype(np.float32)
        active = np.ones(N, bool) if t == 0 else rng.random(N) < 0.5
        active[0] = t < 2                       # one long absence
        if kind == "weights":   # staleness discounts, 0 for the absent
            active = np.where(active, 1.0 / np.sqrt(1.0 + rng.integers(
                0, 4, N)), 0.0).astype(np.float32)
        eta = 0.5 / (t + 1)
        js, jp, jm = ja.round_step(js, jp, jax.tree.map(jnp.asarray, upd),
                                   jnp.asarray(losses), jnp.asarray(active),
                                   eta)
        ts, tp, tm = ta.round_step(ts, tp, params_from_jax(upd, "cpu"),
                                   torch.from_numpy(losses),
                                   torch.from_numpy(active), eta)
        assert sorted(ts) == sorted(js) and sorted(tm) == sorted(jm)
        _assert_trees(tp, jp, 1e-6)
        _assert_trees(ts, js, 1e-6)
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, atol=1e-6)
        if "stay_dn" in ts:
            excluded += int((ts["stay_dn"] > ta.d_max).sum())
    if name == "ca_fed_excluding":
        assert excluded > 0                     # the rule fired


def test_registry_matches_reference():
    assert algorithm_names() == jalgorithm_names()
    for name in algorithm_names():
        assert algorithm_assumes(name) == jalgorithm_assumes(name)
    assert MIFA.assumes == BankedMIFA.assumes == "arbitrary"
    assert FedAR.assumes == "arbitrary"
    assert CAFed.assumes == "stationary_mixing"
    assert FedBuffAvg.assumes == "none" and FedBuffAvg.weight_aware
    for name, kw in (("mifa", {"memory": "delta"}), ("fedar", {"decay": .3}),
                     ("ca_fed", {"rho": 0.2, "d_max": 0.7}), ("fedavg", {}),
                     ("fedavg_is", {"probs": 0.25})):
        got, ref = make_algorithm(name, n=4, **kw), jmake_algorithm(
            name, n=4, **kw)
        assert type(got).__name__ == type(ref).__name__
        for field in ("memory", "decay", "rho", "pi_min", "d_max", "probs"):
            assert getattr(got, field, None) == getattr(ref, field, None)
    banked = make_algorithm("banked_mifa", n=4, device="cpu")
    assert isinstance(banked, BankedMIFA) and banked.cohort_based
    paged = make_algorithm("banked_mifa", n=4, backend="paged_device",
                           page_size=2, device="cpu")
    assert type(paged.bank).__name__ == "PagedDeviceBank"
    with pytest.raises(KeyError, match="unknown algorithm"):
        make_algorithm("fedprox", n=4)
    with pytest.raises(ValueError, match="already registered"):
        register_algorithm("mifa", lambda **kw: None)
    # the host bank (ROADMAP Queue 1 item 9) is ported
    host = make_algorithm("banked_mifa", n=4, backend="host", device="cpu")
    assert type(host.bank).__name__ == "HostBank"


RUN_CASES = {
    "fedar": (JFedAR, FedAR, "gilbert_elliott", {"burst": 8.0}),
    "ca_fed": (JCAFed, CAFed, "cluster", {"n_clusters": 2}),
    "fedbuff": (JFedBuffAvg, FedBuffAvg, "bernoulli_drift", {"drift": -.05}),
}


@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_run_fl_scenario_matches_reference(name):
    make_j, make_t, scen, kw = RUN_CASES[name]
    jparams = _jparams()
    ref = _jax_run(make_j(), jmake_scenario(scen, n=N, seed=8, **kw),
                   jparams)
    port = _run(make_t(), make_scenario(scen, n=N, seed=8, **kw),
                params=_tparams(jparams))
    assert_matches_reference(port, ref)
    assert 0 < np.mean(port[1].n_active) < N


def test_limits_are_the_other_algorithms():
    scen = make_scenario("gilbert_elliott", n=N, seed=1, burst=6.0)
    biased = _run(BiasedFedAvg(), scen)
    for algo in (FedAR(decay=0.0), FedBuffAvg()):
        got = _run(algo, scen)
        assert got[1].train_loss == biased[1].train_loss
        for a, b in zip(tree_leaves(got[0]), tree_leaves(biased[0])):
            assert torch.equal(a, b)
    mifa, fedar1 = _run(MIFA(), scen), _run(FedAR(decay=1.0), scen)
    np.testing.assert_allclose(fedar1[1].train_loss, mifa[1].train_loss,
                               rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(fedar1[0]), tree_leaves(mifa[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def _atlas_algorithm(name):
    extra = {"device": "cpu"} if name == "banked_mifa" else {}
    return make_algorithm(name, n=N, **extra)


def _atlas_scenario(name):
    kw = {"staged_blackout": {"stage_len": 2},
          "cluster": {"n_clusters": 2}}.get(name, {})
    return make_scenario(name, n=N, seed=7, **kw)


@pytest.mark.parametrize("engine", ["loop", "scan"])
@pytest.mark.parametrize("scenario", scenario_names())
@pytest.mark.parametrize("algo_name", algorithm_names())
def test_every_algorithm_runs_every_scenario(algo_name, scenario, engine):
    params, hist = _run(_atlas_algorithm(algo_name),
                        _atlas_scenario(scenario), engine=engine,
                        n_rounds=3)
    assert len(hist.train_loss) == 3
    assert all(np.isfinite(x) for x in hist.train_loss)
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
