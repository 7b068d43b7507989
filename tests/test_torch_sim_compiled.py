"""The port's compiled simulator (`repro_torch.sim.compiled`), its
simulated fleet (`repro_torch.fleet.run_sim_fleet`) and the device
batcher (`JitProceduralBatcher`), on the CPU.

* Within the port the compiled engine is bit-equal to the heap engine:
  close and open times, applied and cohort masks, the dispatched /
  applied / late / never counters, τ statistics, losses and params, for
  the five policies under independent and correlated availability, with
  a weight-aware algorithm under BufferedKofN and with MIFA(array).
* Against the reference: the compiled engine with `TraceLatency` gives
  the reference heap engine's close times bit for bit (and its masks).
* Each epoch is drawn once, in order: the fills the driver replays equal
  the epochs the window needed, and the driver reads k0 back once a
  round.
* `run_fl(sim=)` dispatches as the reference does: "scan" runs compiled
  and equals "loop"; an unsupported configuration falls back to the heap
  engine with a warning naming the blocker, and "scan_strict" raises.
* A simulated fleet's lanes (mixed policies) are bit-equal to single
  compiled runs, with batches drawn on the device by `batch_fn`; mixed
  latency classes are refused.
* `JitProceduralBatcher`: host against device surface bit-equal, and
  within 1e-5 of the reference's draws (threefry normals through torch's
  `erfinv`).

The card's cases are `cuda` cases in `tests/test_torch_scan_engine.py`,
which imports no JAX at the top.
"""
import numpy as np
import pytest
import torch

from repro.core import MIFA as JMIFA
from repro.data import JitProceduralBatcher as JJitProceduralBatcher
from repro.sim import FedSimEngine as JFedSimEngine
from repro.sim import SimConfig as JSimConfig
from repro.sim import TraceLatency as JTraceLatency
from repro.sim import WaitForS as JWaitForS
from repro_torch.core import (MIFA, BernoulliParticipation, BiasedFedAvg,
                              FedBuffAvg, RoundRunner, run_fl)
from repro_torch.core.runner import _reset_fallback_warnings
from repro_torch.data import ClientBatcher, JitProceduralBatcher
from repro_torch.fleet import SimTrial, make_fleet_eval, run_sim_fleet
from repro_torch.models import build_model
from repro_torch.optim import inv_t
from repro_torch.scenarios import Bernoulli, GilbertElliott, as_process
from repro_torch.sim import (BufferedKofN, Deadline, FedSimEngine, Impatient,
                             LognormalLatency, SimConfig, SimScanDriver,
                             SimSpec, TraceLatency, WaitForAll, WaitForS,
                             sim_scan_supported, tiered_shifted_exponential)
from repro_torch.sim.compiled import run_sim_scan
from repro_torch.tree import tree_leaves
from test_torch_sim import _data, _runners

torch.set_num_threads(1)

N, T = 9, 12
CPU = "cpu"
CONFIG = SimConfig(epoch_s=4.0, server_overhead_s=0.1,
                   max_lookahead_epochs=40)

POLICIES = [WaitForAll(), WaitForS(s=4), Deadline(deadline_s=3.0),
            Impatient(), BufferedKofN(k=3)]
SCENARIOS = {"bernoulli": lambda: Bernoulli(0.6, n=N, seed=5),
             "gilbert_elliott": lambda: GilbertElliott(0.3, 0.4, n=N,
                                                       seed=5)}


def _algo_for(policy):
    return FedBuffAvg() if getattr(policy, "stateful", False) \
        else BiasedFedAvg()


def _runner(algo, scenario, seed=0):
    cfg, X, y, idx = _data()
    return RoundRunner(model=build_model(cfg), algo=algo,
                       batcher=ClientBatcher(X, y, idx, batch_size=8,
                                             k_steps=2, seed=0),
                       schedule=inv_t(1.0), weight_decay=1e-3, seed=seed,
                       scenario=scenario, device=CPU)


def _run_both(policy, scenario, algo=None, n_rounds=T, config=CONFIG,
              scan_chunk=5, latency=None):
    """(heap engine, heap runner), (compiled driver, compiled runner)."""
    algo = algo or (lambda: _algo_for(policy))
    lat = latency or tiered_shifted_exponential(N, seed=7, device=CPU)
    sim = SimSpec(policy=policy, latency=lat, config=config)
    r_heap = _runner(algo(), scenario())
    eng = FedSimEngine(r_heap, policy, as_process(scenario()).host_sampler(),
                       lat, config, seed=0)
    eng.run(n_rounds)
    r_scan = _runner(algo(), scenario())
    ok, why = sim_scan_supported(r_scan, sim)
    assert ok, why
    drv = SimScanDriver(r_scan, sim, scan_chunk=scan_chunk, emit_masks=True)
    drv.run(n_rounds)
    return (eng, r_heap), (drv, r_scan)


def _assert_bit_equal(heap, scan):
    (eng, rh), (drv, rs) = heap, scan
    assert len(eng.round_log) == len(drv.round_log)
    for a, b in zip(eng.round_log, drv.round_log):
        assert a == b, a["round"]
    np.testing.assert_array_equal(np.stack(eng.applied_log),
                                  np.stack(drv.applied_log))
    assert rh.hist.train_loss == rs.hist.train_loss
    assert rh.hist.sim_seconds == rs.hist.sim_seconds
    assert rh.hist.n_active == rs.hist.n_active
    assert (rh.stats.tau_bar, rh.stats.tau_max, rh.stats.d_bar) == \
        (rs.stats.tau_bar, rs.stats.tau_max, rs.stats.d_bar)
    for a, b in zip(tree_leaves(rh.params), tree_leaves(rs.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("policy", POLICIES, ids=[p.name for p in POLICIES])
def test_heap_scan_parity(policy, scenario):
    heap, scan = _run_both(policy, SCENARIOS[scenario])
    _assert_bit_equal(heap, scan)
    drv = scan[0]
    # the heap engine's cohorts are the policy's select(t) on the host
    if not getattr(policy, "stateful", False):
        for t, c in enumerate(drv.cohort_log):
            np.testing.assert_array_equal(c, policy.select(t, N, None))


def test_parity_with_mifa_and_trace_latency():
    rng = np.random.default_rng(2)
    lat = TraceLatency(rng.exponential(2.0, (T, N)) + 0.1, device=CPU)
    heap, scan = _run_both(Impatient(), SCENARIOS["gilbert_elliott"],
                           algo=MIFA, latency=lat)
    _assert_bit_equal(heap, scan)


def test_fills_each_epoch_once_and_syncs_once_a_round():
    cfg = SimConfig(epoch_s=1.0, server_overhead_s=0.1,
                    max_lookahead_epochs=6)
    heap, scan = _run_both(WaitForAll(), SCENARIOS["gilbert_elliott"],
                           config=cfg, scan_chunk=4)
    _assert_bit_equal(heap, scan)
    drv, eng = scan[0], heap[0]
    chunks = drv.chunks
    last_k0 = int(np.floor(np.float32(eng.now) / np.float32(1.0)))
    assert chunks.syncs == T
    # round t fills up to the epoch k0(t) + W: the last round's k0 is the
    # clock before it opened
    k0_last = int(np.floor(np.float32(drv.round_log[-1]["t_open"])))
    assert chunks.fills == k0_last + 6 + 1 == int(chunks.e_next)
    assert int(chunks.k0) == last_k0
    assert len(eng._avail_cache) <= chunks.fills


def test_compiled_matches_reference_heap_with_trace_latency():
    """Across the packages: the port's compiled engine against the
    reference's heap engine from the same params; with exact RTTs the
    close times are bit-equal."""
    rng = np.random.default_rng(5)
    tr = np.round(rng.exponential(1.5, (10, N)) + 0.2, 2)
    cfg = dict(epoch_s=4.0, server_overhead_s=0.05, max_lookahead_epochs=40)
    r, jr = _runners(MIFA(), JMIFA(),
                     scenario=GilbertElliott(0.3, 0.4, n=N, seed=5))
    drv = SimScanDriver(r, SimSpec(WaitForS(s=5), TraceLatency(tr,
                                                               device=CPU),
                                   SimConfig(**cfg)), scan_chunk=4,
                        emit_masks=True)
    drv.run(10)
    from repro.scenarios import GilbertElliott as JGilbertElliott
    jeng = JFedSimEngine(jr, JWaitForS(s=5),
                         JGilbertElliott(0.3, 0.4, n=N, seed=5)
                         .host_sampler(), JTraceLatency(tr),
                         JSimConfig(**cfg), seed=0)
    _, jh = jeng.run(10)
    assert r.hist.sim_seconds == jh.sim_seconds
    np.testing.assert_array_equal(np.stack(drv.applied_log),
                                  np.stack(jeng.applied_log))
    np.testing.assert_allclose(r.hist.train_loss, jh.train_loss, rtol=1e-4,
                               atol=1e-6)


def test_run_fl_sim_engines_agree():
    cfg, X, y, idx = _data()
    lat = tiered_shifted_exponential(N, seed=7, device=CPU)
    sim = SimSpec(policy=WaitForS(s=4), latency=lat, config=CONFIG)
    model = build_model(cfg)
    evals = {}

    def ev(p):
        return float(sum(v.sum() for v in tree_leaves(p))), 0.0

    kw = dict(model=model, algo=BiasedFedAvg(),
              batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                    seed=0),
              schedule=inv_t(1.0), n_rounds=T, sim=sim, seed=3, eval_fn=ev,
              eval_every=4, device=CPU)
    for engine in ("loop", "scan", "scan_strict"):
        evals[engine] = run_fl(engine=engine, scenario=SCENARIOS[
            "bernoulli"](), **kw)[1]
    for engine in ("scan", "scan_strict"):
        a, b = evals["loop"], evals[engine]
        assert a.train_loss == b.train_loss
        assert a.sim_seconds == b.sim_seconds
        assert a.n_active == b.n_active
        assert a.eval_seconds == b.eval_seconds and a.eval_loss == \
            b.eval_loss
    assert [t for t, _ in evals["loop"].eval_seconds] == [0, 4, 8, 11]


def test_sim_scan_supported_rejects_oversized_window():
    sim = SimSpec(policy=WaitForAll(),
                  latency=tiered_shifted_exponential(N, seed=7, device=CPU),
                  config=SimConfig(max_lookahead_epochs=1 << 24))
    ok, why = sim_scan_supported(_runner(BiasedFedAvg(),
                                         SCENARIOS["bernoulli"]()), sim)
    assert not ok and "window" in why


def test_run_fl_sim_falls_back_with_warning():
    """participation= (no device surface) and a cohort algorithm run on
    the heap engine under engine='scan', warning with the blocker."""
    from repro_torch.bank import BankedMIFA, DenseBank
    _reset_fallback_warnings()
    cfg, X, y, idx = _data()
    sim = SimSpec(policy=WaitForAll(),
                  latency=tiered_shifted_exponential(N, seed=7, device=CPU),
                  config=CONFIG)
    kw = dict(model=build_model(cfg), algo=BiasedFedAvg(),
              batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                    seed=0),
              schedule=inv_t(1.0), n_rounds=4, sim=sim, device=CPU)
    part = BernoulliParticipation(np.full(N, 0.6), seed=5)
    with pytest.warns(UserWarning, match="scenario"):
        _, hist = run_fl(engine="scan", participation=part, **kw)
    assert len(hist.sim_seconds) == 4
    with pytest.raises(ValueError, match="scan_strict"):
        run_fl(engine="scan_strict", participation=part, **kw)
    kw["algo"] = BankedMIFA(DenseBank(device=CPU))
    with pytest.warns(UserWarning, match="cohort"):
        _, hist = run_fl(engine="scan", scenario=SCENARIOS["bernoulli"](),
                         **kw)
    assert len(hist.sim_seconds) == 4


def test_buffered_pending_carry_over():
    heap, scan = _run_both(BufferedKofN(k=3), SCENARIOS["bernoulli"])
    eng, drv = heap[0], scan[0]
    assert all(r["n_late"] == 0 for r in eng.round_log)
    assert all(r["n_late"] == 0 for r in drv.round_log)
    applied, cohort = np.stack(drv.applied_log), np.stack(drv.cohort_log)
    assert (applied & ~cohort).any()


def test_run_sim_scan_wrapper():
    r = _runner(MIFA(), SCENARIOS["bernoulli"]())
    sim = SimSpec(Impatient(), tiered_shifted_exponential(N, seed=7,
                                                          device=CPU),
                  CONFIG)
    params, hist = run_sim_scan(r, sim, 5, scan_chunk=2)
    assert len(hist.sim_seconds) == 5 and hist.wall_time > 0
    assert params is r.params


# --------------------------------------------------------------------------- #
# the simulated fleet
# --------------------------------------------------------------------------- #

def _batcher():
    from repro_torch.configs import get_config
    return JitProceduralBatcher(n_clients=N,
                                dim=get_config("paper_logistic").d_model,
                                batch_size=8, k_steps=2, seed=3, device=CPU)


def test_sim_fleet_matches_single_runs():
    cfg, _, _, _ = _data()
    model = build_model(cfg)
    batcher = _batcher()
    lat = lambda: tiered_shifted_exponential(N, seed=7, device=CPU)
    trials = [
        SimTrial(seed=13, policy=WaitForAll(),
                 scenario=Bernoulli(0.6, n=N, seed=5), latency=lat()),
        SimTrial(seed=14, policy=Deadline(deadline_s=3.0, cohort_size=6),
                 scenario=Bernoulli(0.6, n=N, seed=6), latency=lat()),
        SimTrial(seed=15, policy=BufferedKofN(k=3),
                 scenario=Bernoulli(0.6, n=N, seed=7), latency=lat()),
    ]
    eval_fn = make_fleet_eval(model, batcher.eval_batch(128), device=CPU)
    _, hist = run_sim_fleet(
        model=model, algo=FedBuffAvg(), batcher=batcher,
        schedule=inv_t(1.0), n_rounds=T, trials=trials, config=CONFIG,
        scan_chunk=5, eval_fn=eval_fn, eval_every=4,
        batch_fn=batcher.batch_fn(), device=CPU)
    st = hist.stacked()
    assert st["sim_seconds"].shape == (3, T)
    assert st["eval_seconds"].shape == (3, 4)
    assert hist.sim.syncs == T
    for k, tr in enumerate(trials):
        sim = SimSpec(policy=tr.policy, latency=tr.latency, config=CONFIG)
        _, h1 = run_fl(model=model, algo=FedBuffAvg(), batcher=batcher,
                       schedule=inv_t(1.0), n_rounds=T,
                       scenario=tr.scenario, sim=sim, seed=tr.seed,
                       engine="scan_strict", scan_chunk=5, device=CPU)
        np.testing.assert_array_equal(st["sim_seconds"][k], h1.sim_seconds)
        np.testing.assert_array_equal(st["train_loss"][k], h1.train_loss)
        np.testing.assert_array_equal(st["n_active"][k], h1.n_active)
        assert hist.trial(k).sim_seconds == h1.sim_seconds


def test_sim_fleet_rejects_mixed_latency_classes():
    cfg, _, _, _ = _data()
    trials = [
        SimTrial(seed=1, policy=WaitForAll(),
                 scenario=Bernoulli(0.6, n=N, seed=5),
                 latency=tiered_shifted_exponential(N, seed=7, device=CPU)),
        SimTrial(seed=2, policy=WaitForAll(),
                 scenario=Bernoulli(0.6, n=N, seed=5),
                 latency=LognormalLatency(0.0, 0.5, comm=0.1, n=N, seed=7,
                                          device=CPU)),
    ]
    with pytest.raises(ValueError, match="latency"):
        run_sim_fleet(model=build_model(cfg), algo=BiasedFedAvg(),
                      batcher=_batcher(), schedule=inv_t(1.0), n_rounds=2,
                      trials=trials, config=CONFIG, device=CPU)


# --------------------------------------------------------------------------- #
# the device batcher
# --------------------------------------------------------------------------- #

def test_jit_batcher_host_matches_program():
    b = JitProceduralBatcher(n_clients=5, dim=4, batch_size=3, k_steps=2,
                             seed=9, device=CPU)
    draw = b.batch_fn()
    for t in (0, 7):
        host = b.sample_round(t)
        prog = {k: v.numpy() for k, v in draw(torch.tensor(t)).items()}
        np.testing.assert_array_equal(host["x"], prog["x"])
        np.testing.assert_array_equal(host["y"], prog["y"])
    assert host["x"].shape == (5, 2, 3, 4)
    assert host["y"].dtype == np.int32
    sub = b.sample_round(0, client_ids=[4, 1])
    np.testing.assert_array_equal(sub["x"], b.sample_round(0)["x"][[4, 1]])
    ev = b.eval_batch(64)
    assert ev["x"].shape == (64, 4) and ev["y"].shape == (64,)


def test_jit_batcher_against_reference():
    kw = dict(n_clients=5, dim=6, batch_size=3, k_steps=2, seed=9)
    b, jb = JitProceduralBatcher(device=CPU, **kw), JJitProceduralBatcher(**kw)
    for t in (0, 3):
        a, r = b.sample_round(t), jb.sample_round(t)
        np.testing.assert_allclose(a["x"], r["x"], rtol=1e-5, atol=1e-5)
    e, je = b.eval_batch(256), jb.eval_batch(256)
    np.testing.assert_allclose(e["x"], je["x"], rtol=1e-5, atol=1e-5)
    # labels follow an argmax: a near-tie may flip; the law is the same
    assert (e["y"] == je["y"]).mean() > 0.98
