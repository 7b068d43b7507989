"""The port's host bank (`repro_torch.bank.HostBank`) against the JAX
package's, on the CPU.

* gather, scatter (padded cohorts, pad slots, repeated writes), `g_sum`,
  `mean_g` and `memory_bytes` array-equal to `repro.bank.HostBank` for the
  same numpy inputs; the staged scatter (the runner's path) equals the
  host-id one.
* BankedMIFA(HostBank) through `run_fl` against the reference's from its
  params (f32 bounds of `tests/test_torch_run_fl.py`), and against the
  port's BankedMIFA(DenseBank) within 1e-5; under `engine="scan"` it
  falls back to the loop (a host bank) with a warning, and "scan_strict"
  raises; it runs under the heap engine (`run_fl(sim=)`).
* On the CPU the rows are plain host tensors; on the card they are
  pinned (the `cuda` case in `tests/test_torch_scan_engine.py`, with the
  paged bank's pinned spill store).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bank import BankedMIFA as JBankedMIFA
from repro.bank import HostBank as JHostBank
from repro.configs import get_config as jax_config
from repro.core import run_fl as jax_run_fl
from repro.data import ClientBatcher as JClientBatcher
from repro.models import build_model as jax_build
from repro.scenarios import make_scenario as jmake_scenario
from repro_torch.bank import (BankedMIFA, DenseBank, HostBank,
                              PagedDeviceBank, make_bank)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import run_fl
from repro_torch.core.runner import _reset_fallback_warnings
from repro_torch.data import (ClientBatcher, label_skew_partition,
                              make_classification)
from repro_torch.models import build_model
from repro_torch.scenarios import make_scenario
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

N = 7
CPU = "cpu"


def _params(rng):
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32)}


def _pair():
    rng = np.random.default_rng(0)
    p = _params(rng)
    bank, jbank = HostBank(device=CPU), JHostBank()
    st = bank.init({k: torch.from_numpy(v) for k, v in p.items()}, N)
    jst = jbank.init({k: jnp.asarray(v) for k, v in p.items()}, N)
    return bank, st, jbank, jst, rng


def _assert_state_equal(st, jst):
    for a, b in zip(tree_leaves(st), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


COHORTS = [(np.array([0, 3, 5, N, N]), np.array([1, 1, 1, 0, 0], bool)),
           (np.array([3, 1, 6]), None),
           (np.array([5, 0, N, 2]), np.array([1, 1, 0, 1], bool)),
           (np.array([3, 4, 6, 1]), None)]


def test_scatter_gather_and_mean_equal_reference():
    bank, st, jbank, jst, rng = _pair()
    for ids, valid in COHORTS:
        u = {"w": rng.normal(size=(len(ids), 3, 4)).astype(np.float32),
             "b": rng.normal(size=(len(ids), 4)).astype(np.float32)}
        st = bank.scatter(st, ids, {k: torch.from_numpy(v)
                                    for k, v in u.items()}, valid=valid)
        jst = jbank.scatter(jst, ids, {k: jnp.asarray(v)
                                       for k, v in u.items()}, valid=valid)
        _assert_state_equal(st, jst)
        ask = np.array([6, 0, 3, 1])
        for a, b in zip(tree_leaves(bank.gather(st, ask)),
                        jax.tree.leaves(jbank.gather(jst, ask))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(bank.mean_g(st)),
                        jax.tree.leaves(jbank.mean_g(jst))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bank.memory_bytes(st) == jbank.memory_bytes(jst)
    assert bank.memory_bytes(st)["device"] == 0


def test_staged_scatter_equals_host_ids():
    bank, st, _, _, rng = _pair()
    other = HostBank(device=CPU)
    st2 = other.init({"w": torch.zeros(3, 4), "b": torch.zeros(4)}, N)
    for ids, valid in COHORTS:
        valid = np.ones(len(ids), bool) if valid is None else valid
        u = {"w": torch.from_numpy(rng.normal(size=(len(ids), 3, 4))
                                   .astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(len(ids), 4))
                                   .astype(np.float32))}
        st = bank.scatter(st, ids, u, valid=valid)
        rows = torch.from_numpy(other.stage_rows(ids, valid))
        st2 = other.scatter_staged(st2, rows, torch.from_numpy(valid), u)
        for a, b in zip(tree_leaves(st), tree_leaves(st2)):
            assert torch.equal(a, b)


def test_host_bank_checks_and_layout():
    bank, st, _, _, _ = _pair()
    assert isinstance(make_bank("host", device=CPU), HostBank)
    assert not bank.on_device and not bank.pinned
    assert all(not t.is_pinned() and t.device.type == "cpu"
               for t in tree_leaves(st))
    assert st["rows"]["w"].shape == (N, 3, 4)
    with pytest.raises(ValueError, match="duplicate"):
        bank.scatter(st, np.array([1, 1]), {"w": torch.zeros(2, 3, 4),
                                             "b": torch.zeros(2, 4)})
    with pytest.raises(IndexError):
        bank.scatter(st, np.array([N]), {"w": torch.zeros(1, 3, 4),
                                          "b": torch.zeros(1, 4)})


def _problem():
    cfg = get_config("paper_mlp").replace(fl_clients=6)
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    idx, _ = label_skew_partition(y, 6, seed=0)
    return cfg, X, y, idx


def _run(algo, engine="loop", **over):
    cfg, X, y, idx = _problem()
    jparams = jax_build(jax_config("paper_mlp").replace(fl_clients=6)).init(
        jax.random.PRNGKey(0))
    kw = dict(model=build_model(cfg), algo=algo,
              scenario=make_scenario("cluster", n=6, seed=5, n_clusters=2),
              batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                    seed=0),
              schedule=lambda t: 0.1 / (1 + t), n_rounds=10,
              weight_decay=1e-3, cohort_capacity=8, engine=engine,
              params=params_from_jax(jax.tree.map(np.asarray, jparams), CPU),
              device=CPU)
    kw.update(over)
    return run_fl(**kw), jparams


def test_banked_host_run_matches_reference_and_dense():
    (port, jparams) = _run(BankedMIFA(HostBank(device=CPU)))
    cfg, X, y, idx = _problem()
    ref = jax_run_fl(
        model=jax_build(jax_config("paper_mlp").replace(fl_clients=6)),
        algo=JBankedMIFA(JHostBank()),
        scenario=jmake_scenario("cluster", n=6, seed=5, n_clusters=2),
        batcher=JClientBatcher(X, y, idx, batch_size=8, k_steps=2, seed=0),
        schedule=lambda t: 0.1 / (1 + t), n_rounds=10, weight_decay=1e-3,
        cohort_capacity=8, params=jparams)
    (pt, ht), (pj, hj) = port, ref
    assert ht.n_active == hj.n_active
    np.testing.assert_allclose(ht.train_loss, hj.train_loss, rtol=1e-4,
                               atol=1e-6)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    (dense, _) = _run(BankedMIFA(DenseBank(device=CPU)))
    np.testing.assert_allclose(ht.train_loss, dense[1].train_loss,
                               rtol=1e-5, atol=1e-7)
    for a, b in zip(tree_leaves(pt), tree_leaves(dense[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_banked_host_scan_falls_back_to_loop():
    _reset_fallback_warnings()
    with pytest.warns(UserWarning, match="host-offloaded"):
        (scan, _) = _run(BankedMIFA(HostBank(device=CPU)), engine="scan")
    (loop, _) = _run(BankedMIFA(HostBank(device=CPU)))
    assert scan[1].train_loss == loop[1].train_loss
    with pytest.raises(ValueError, match="scan_strict"):
        _run(BankedMIFA(HostBank(device=CPU)), engine="scan_strict")


def test_banked_host_under_the_heap_engine():
    from repro_torch.sim import (Impatient, SimConfig, SimSpec,
                                 tiered_shifted_exponential)
    sim = SimSpec(Impatient(), tiered_shifted_exponential(6, seed=1,
                                                          device=CPU),
                  SimConfig(epoch_s=4.0, server_overhead_s=0.05,
                            max_lookahead_epochs=16))
    (host, _) = _run(BankedMIFA(HostBank(device=CPU)), sim=sim)
    (dense, _) = _run(BankedMIFA(DenseBank(device=CPU)), sim=sim)
    assert host[1].sim_seconds == dense[1].sim_seconds
    assert host[1].n_active == dense[1].n_active
    np.testing.assert_allclose(host[1].train_loss, dense[1].train_loss,
                               rtol=1e-5, atol=1e-7)


def test_paged_spill_store_on_the_cpu_is_plain_host_memory():
    bank = PagedDeviceBank(page_size=2, n_slots=2, device=CPU)
    st = bank.init({"w": torch.zeros(3)}, 12)
    for ids in ([0, 2], [4, 6], [8, 10], [0, 9]):
        u = {"w": torch.ones(len(ids), 3) * (ids[0] + 1)}
        st = bank.scatter(st, np.array(ids), u)
    assert bank.evictions > 0 and bank.refaults > 0
    assert all(not b.is_pinned() for blocks in bank._spill.values()
               for b in blocks)
    rows = bank.gather(st, np.array([0, 2, 4, 9]))["w"]
    np.testing.assert_array_equal(rows[:, 0].numpy(), [1, 1, 5, 1])
