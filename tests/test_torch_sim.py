"""The port's simulator (`repro_torch.sim`) against the JAX package's, on
the CPU.

* `_threefry.split`, `random_bits` and `permutation` are array-equal to
  `jax.random`'s, n > 1625 (two shuffle rounds) included; `exponential`
  is within 2 ulp and `normal` within rel 1e-5 (XLA's `log1p` and
  `erf_inv` against torch's).
* The policies' host cohorts are array-equal to the reference's;
  `unified_select` equals the host cohorts; `unified_resolve` on the same
  f32 arrivals gives a bit-equal close, equal masks and equal weights.
* The latency laws: `TraceLatency` array-equal, the exponential and
  lognormal laws within 2 ulp / rel 1e-5, the host surface equal to the
  device surface.
* The heap engine against `repro.sim.engine.FedSimEngine` from the
  reference's params: with `TraceLatency` close times bit-equal, masks
  and counters equal, losses and params within `tests/test_torch_run_fl.
  py`'s f32 bounds (rtol 1e-4, atol 1e-6); with
  `tiered_shifted_exponential` close times within rel 1e-6.
* The reference's `tests/test_sim.py` cases against the port: FIFO ties,
  a deterministic event log, strictly increasing seconds with the τ
  timeline, Impatient never slower than WaitForAll, Deadline drops,
  WaitForS applies exactly S, `max_sim_seconds`, zero latency, an empty
  cohort, trace exhaustion and the round-0 convention.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import MIFA as JMIFA
from repro.core import RoundRunner as JRoundRunner
from repro.data import ClientBatcher as JClientBatcher
from repro.models import build_model as jax_build
from repro.scenarios import make_process as jmake_process
from repro.sim import BufferedKofN as JBufferedKofN
from repro.sim import Deadline as JDeadline
from repro.sim import FedSimEngine as JFedSimEngine
from repro.sim import Impatient as JImpatient
from repro.sim import SimConfig as JSimConfig
from repro.sim import TraceLatency as JTraceLatency
from repro.sim import WaitForAll as JWaitForAll
from repro.sim import WaitForS as JWaitForS
from repro.sim import tiered_shifted_exponential as jtiered
from repro.sim.policies import _fold_in_cohort as j_fold_in_cohort
from repro.sim.policies import init_policy_state as jinit_policy_state
from repro.sim.policies import policy_params as jpolicy_params
from repro.sim.policies import unified_resolve as junified_resolve
from repro.sim.policies import unified_select as junified_select
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import (MIFA, AdversarialParticipation, BiasedFedAvg,
                              RoundRunner, TraceParticipation, tau_matrix)
from repro_torch.data import (ClientBatcher, label_skew_partition,
                              make_classification)
from repro_torch.models import build_model
from repro_torch.optim import inv_t
from repro_torch.scenarios import _threefry, make_process
from repro_torch.sim import (BufferedKofN, Deadline, EventQueue,
                             FedSimEngine, Impatient, LognormalLatency,
                             ShiftedExponentialLatency, SimConfig,
                             TraceLatency, WaitForAll, WaitForS,
                             init_policy_state, policy_params,
                             tiered_shifted_exponential, unified_resolve,
                             unified_select)
from repro_torch.sim.policies import _fold_in_cohort
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

N = 9
CPU = "cpu"


# --------------------------------------------------------------------------- #
# threefry: split, bits, permutation, exponential, normal
# --------------------------------------------------------------------------- #

def _keys(seed, t):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), t),
            _threefry.round_key(_threefry.seed_key(seed), t))


@pytest.mark.parametrize("seed", [0, 5, 12345])
def test_split_and_bits_equal_jax(seed):
    for t in (0, 7, 999):
        kj, kp = _keys(seed, t)
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(kj, 5)).astype(np.int64),
            _threefry.split(kp, 5).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(kj, (257,))).astype(np.int64),
            _threefry.random_bits(kp, 257).numpy())


@pytest.mark.parametrize("n", [1, 5, 100, 1625, 1626, 2000])
def test_permutation_equals_jax(n):
    for seed, t in ((0, 0), (3, 11), (17, 999)):
        kj, kp = _keys(seed, t)
        np.testing.assert_array_equal(
            np.asarray(jax.random.permutation(kj, n)),
            _threefry.permutation(kp, n).numpy())
    assert _threefry.shuffle_rounds(1625) == 1
    assert _threefry.shuffle_rounds(1626) == 2


def test_permutation_stacked_keys():
    keys = torch.stack([_keys(s, 4)[1] for s in (1, 2, 3)])
    perms = _threefry.permutation(keys, 40)
    for k, s in enumerate((1, 2, 3)):
        np.testing.assert_array_equal(
            perms[k].numpy(),
            np.asarray(jax.random.permutation(_keys(s, 4)[0], 40)))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b).max()


@pytest.mark.parametrize("seed", [0, 7])
def test_exponential_and_normal_within_tolerance(seed):
    kj, kp = _keys(seed, 3)
    assert _ulps(jax.random.exponential(kj, (4096,)),
                 _threefry.exponential(kp, 4096).numpy()) <= 2
    nj = np.asarray(jax.random.normal(kj, (4096,)))
    npt = _threefry.normal(kp, 4096).numpy()
    np.testing.assert_allclose(npt, nj, rtol=1e-5, atol=0)


# --------------------------------------------------------------------------- #
# latency laws
# --------------------------------------------------------------------------- #

def test_trace_latency_equals_reference_and_clamps():
    trace = np.arange(6, dtype=float).reshape(2, 3)
    lat, jlat = TraceLatency(trace, device=CPU), JTraceLatency(trace)
    for t in (0, 1, 7):
        np.testing.assert_array_equal(lat.sample(t), jlat.sample(t))
    np.testing.assert_array_equal(lat.sample(7), [3, 4, 5])
    trace[0, 0] = 99.0                      # no aliasing of caller's array
    assert lat.sample(0)[0] == 0.0


def test_random_latency_laws_against_reference():
    from repro.sim import LognormalLatency as JLognormal
    for t in range(4):
        a = tiered_shifted_exponential(N, seed=7, device=CPU).sample(t)
        b = jtiered(N, seed=7).sample(t)
        assert _ulps(a, b) <= 2 and a.dtype == np.float32
        a = LognormalLatency(0.0, 0.5, comm=0.1, n=N, seed=3,
                             device=CPU).sample(t)
        b = JLognormal(0.0, 0.5, comm=0.1, n=N, seed=3).sample(t)
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_latency_models_shapes_and_determinism():
    for make in (lambda s: ShiftedExponentialLatency(0.5, 1.0, n=N, seed=s,
                                                     device=CPU),
                 lambda s: LognormalLatency(0.0, 0.5, comm=0.1, n=N, seed=s,
                                            device=CPU),
                 lambda s: tiered_shifted_exponential(N, seed=s,
                                                      device=CPU)):
        a, b = make(3), make(3)
        sa = np.stack([a.sample(t) for t in range(5)])
        sb = np.stack([b.sample(t) for t in range(5)])
        assert sa.shape == (5, N) and np.all(sa > 0)
        np.testing.assert_array_equal(sa, sb)
        # the device surface on stacked lanes equals each lane's host one
        fn = a.sample_fn()
        keys = torch.stack([a.key, make(4).key])
        state = {k: torch.stack([v, v]) for k, v in a.init_state().items()}
        out = fn(keys, torch.tensor([2, 2]), state).numpy()
        np.testing.assert_array_equal(out[0], a.sample(2))
        np.testing.assert_array_equal(out[1], make(4).sample(2))


# --------------------------------------------------------------------------- #
# policies: host cohorts, the unified algebra
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,k", [(9, 4), (100, 10), (1700, 30)])
def test_host_cohorts_equal_reference(n, k):
    for seed in (0, 3):
        for t in (0, 1, 17):
            np.testing.assert_array_equal(_fold_in_cohort(seed, t, n, k),
                                          j_fold_in_cohort(seed, t, n, k))
    assert np.array_equal(
        WaitForS(s=4, sel_seed=2).select(5, N, None),
        JWaitForS(s=4, sel_seed=2).select(5, N, None))
    assert np.array_equal(
        Deadline(1.0, cohort_size=3).select(2, N, None),
        JDeadline(1.0, cohort_size=3).select(2, N, None))


PAIRS = [(WaitForAll(), JWaitForAll()), (WaitForS(s=4), JWaitForS(s=4)),
         (Deadline(deadline_s=1.5), JDeadline(deadline_s=1.5)),
         (Deadline(deadline_s=1.5, cohort_size=5),
          JDeadline(deadline_s=1.5, cohort_size=5)),
         (Impatient(), JImpatient()), (BufferedKofN(k=3), JBufferedKofN(k=3)),
         (BufferedKofN(k=3, deadline_s=0.7),
          JBufferedKofN(k=3, deadline_s=0.7))]
PAIR_IDS = ["wait_for_all", "wait_for_s", "deadline", "deadline_cohort",
            "impatient", "buffered", "buffered_deadline"]


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_unified_select_and_resolve_equal_reference(pair):
    import jax.numpy as jnp
    pol, jpol = pair
    rng = np.random.default_rng(3)
    pp, jpp = policy_params(pol, N), jpolicy_params(jpol, N)
    ps, jps = init_policy_state(N), jinit_policy_state(N)
    now = np.float32(0.0)
    for t in range(6):
        cohort = unified_select(t, pp, ps)
        jcohort = junified_select(jnp.int32(t), jpp, jps)
        np.testing.assert_array_equal(cohort.numpy(), np.asarray(jcohort))
        arr = (now + rng.exponential(1.0, N)).astype(np.float32)
        arr[rng.random(N) < 0.2] = np.inf
        arr = np.where(cohort.numpy(), arr, np.inf).astype(np.float32)
        avail = rng.random(N) < 0.7
        out = unified_resolve(pp, ps, cohort, torch.from_numpy(avail),
                              torch.from_numpy(arr), torch.tensor(now),
                              torch.tensor(np.float32(4.0)), t)
        jout = junified_resolve(jpp, jps, jcohort, jnp.asarray(avail),
                                jnp.asarray(arr), jnp.float32(now),
                                jnp.float32(4.0), jnp.int32(t))
        close, applied, weights, ps, info = out
        jclose, japplied, jweights, jps, jinfo = jout
        assert close.item() == float(jclose)
        np.testing.assert_array_equal(applied.numpy(), np.asarray(japplied))
        np.testing.assert_array_equal(weights.numpy(), np.asarray(jweights))
        np.testing.assert_array_equal(ps["pending"].numpy(),
                                      np.asarray(jps["pending"]))
        for k in ("n_late", "n_never"):
            assert int(info[k]) == int(jinfo[k])
        now = np.float32(close.item()) + np.float32(0.05)


def test_unified_select_equals_host_select():
    for pol in (WaitForAll(), WaitForS(s=4, sel_seed=9),
                Deadline(2.0, cohort_size=6, sel_seed=1), Impatient()):
        pp, ps = policy_params(pol, N), init_policy_state(N)
        for t in range(5):
            np.testing.assert_array_equal(unified_select(t, pp, ps).numpy(),
                                          pol.select(t, N, None))


def test_buffered_policy_weights_match_reference():
    pol, jpol = BufferedKofN(k=3), JBufferedKofN(k=3)
    st, jst = pol.init_pstate(N), jpol.init_pstate(N)
    cohort = np.ones(N, bool)
    arrivals = np.full(N, np.inf, np.float32)
    arrivals[:4] = np.float32([0.5, 1.0, 1.5, 9.0])
    for t, (arr, co) in enumerate(((arrivals, cohort),
                                   (np.full(N, np.inf, np.float32),
                                    np.zeros(N, bool)))):
        now = np.float32(1.6 * t)
        a = pol.resolve_pending(st, co, cohort, arr, now, np.float32(4.0), t)
        b = jpol.resolve_pending(jst, co, cohort, arr, now, np.float32(4.0),
                                 t)
        assert a[0] == b[0]
        for x, y in zip(a[1:3], b[1:3]):
            np.testing.assert_array_equal(x, y)
        st, jst = a[3], b[3]
    assert a[2][3] == np.float32(1.0 / np.sqrt(2.0))


# --------------------------------------------------------------------------- #
# the heap engine against the reference's
# --------------------------------------------------------------------------- #

def _data(n_clients=N):
    cfg = get_config("paper_logistic").replace(fl_clients=n_clients)
    X, y = make_classification(10, cfg.d_model, 60, noise=1.0, seed=0)
    idx, _ = label_skew_partition(y, n_clients, seed=0)
    return cfg, X, y, idx


def _runners(algo, jalgo, seed=0, scenario=None):
    """(port runner, reference runner) on one problem from the
    reference's params (the port's with `scenario`, for the compiled
    engine)."""
    cfg, X, y, idx = _data()
    jmodel = jax_build(jax_config("paper_logistic").replace(fl_clients=N))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    jr = JRoundRunner(model=jmodel, algo=jalgo,
                      batcher=JClientBatcher(X, y, idx, batch_size=8,
                                             k_steps=2, seed=0),
                      schedule=inv_t(1.0), weight_decay=1e-3, seed=seed,
                      params=jparams)
    r = RoundRunner(model=build_model(cfg), algo=algo,
                    batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                          seed=0),
                    schedule=inv_t(1.0), weight_decay=1e-3, seed=seed,
                    params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                           CPU), scenario=scenario,
                    device=CPU)
    return r, jr


def _trace_latency(seed=0, rounds=16):
    rng = np.random.default_rng(seed)
    tr = np.round(rng.exponential(1.5, (rounds, N)) + 0.2, 2)
    return TraceLatency(tr, device=CPU), JTraceLatency(tr)


def _engines(pol, jpol, lat, jlat, algo=MIFA, jalgo=JMIFA, config=None,
             scen=("gilbert_elliott", {"burst": 3.0})):
    r, jr = _runners(algo(), jalgo())
    cfg = config or dict(epoch_s=4.0, server_overhead_s=0.05,
                         max_lookahead_epochs=40)
    name, kw = scen
    eng = FedSimEngine(r, pol, make_process(name, n=N, seed=5, **kw)
                       .host_sampler(), lat, SimConfig(**cfg), seed=13)
    jeng = JFedSimEngine(jr, jpol, jmake_process(name, n=N, seed=5, **kw)
                         .host_sampler(), jlat, JSimConfig(**cfg), seed=13)
    return eng, jeng


def _assert_params_close(eng, jeng):
    np.testing.assert_allclose(eng.runner.hist.train_loss,
                               jeng.runner.hist.train_loss, rtol=1e-4,
                               atol=1e-6)
    for a, b in zip(tree_leaves(eng.runner.params),
                    jax.tree.leaves(jeng.runner.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("pair", PAIRS[:6], ids=PAIR_IDS[:6])
def test_heap_engine_matches_reference_trace_latency(pair):
    pol, jpol = pair
    lat, jlat = _trace_latency()
    algo = (MIFA, JMIFA)
    if getattr(pol, "stateful", False):
        from repro.core import FedBuffAvg as JFedBuffAvg
        from repro_torch.core import FedBuffAvg
        algo = (FedBuffAvg, JFedBuffAvg)
    eng, jeng = _engines(pol, jpol, lat, jlat, *algo)
    _, hist = eng.run(10)
    _, jhist = jeng.run(10)
    assert hist.sim_seconds == jhist.sim_seconds          # bit-equal f32
    for a, b in zip(eng.round_log, jeng.round_log):
        assert {k: v for k, v in a.items() if k != "train_loss"} == \
            {k: v for k, v in b.items() if k != "train_loss"}
    np.testing.assert_array_equal(np.stack(eng.applied_log),
                                  np.stack(jeng.applied_log))
    assert eng.event_log == jeng.event_log
    assert hist.n_active == jhist.n_active
    assert (hist.tau_bar, hist.tau_max) == (jhist.tau_bar, jhist.tau_max)
    _assert_params_close(eng, jeng)


def test_heap_engine_matches_reference_tiered_latency():
    eng, jeng = _engines(Impatient(), JImpatient(),
                         tiered_shifted_exponential(N, seed=7, device=CPU),
                         jtiered(N, seed=7))
    _, hist = eng.run(10)
    _, jhist = jeng.run(10)
    np.testing.assert_allclose(hist.sim_seconds, jhist.sim_seconds,
                               rtol=1e-6)
    np.testing.assert_array_equal(np.stack(eng.applied_log),
                                  np.stack(jeng.applied_log))
    _assert_params_close(eng, jeng)


def test_run_fl_sim_heap_matches_reference():
    """The entry point, `run_fl(sim=..., engine="loop")`, with evals
    stamped in simulated seconds."""
    from repro.core import run_fl as jrun_fl
    from repro.scenarios import make_scenario as jmake_scenario
    from repro.sim import SimSpec as JSimSpec
    from repro_torch.core import run_fl
    from repro_torch.scenarios import make_scenario
    from repro_torch.sim import SimSpec
    r, jr = _runners(MIFA(), JMIFA())
    lat, jlat = _trace_latency(1)
    cfg = dict(epoch_s=4.0, server_overhead_s=0.05, max_lookahead_epochs=40)

    def ev(p):
        return float(sum(v.sum() for v in tree_leaves(p))), 0.5

    def jev(p):
        return float(sum(np.asarray(v).sum() for v in jax.tree.leaves(p))), .5

    _, h = run_fl(model=r.model, algo=MIFA(), batcher=r.batcher,
                  schedule=inv_t(1.0), n_rounds=9, weight_decay=1e-3,
                  scenario=make_scenario("cluster", n=N, seed=2),
                  sim=SimSpec(WaitForS(s=5), lat, SimConfig(**cfg)),
                  params=r.params, eval_fn=ev, eval_every=4, device=CPU)
    _, jh = jrun_fl(model=jr.model, algo=JMIFA(), batcher=jr.batcher,
                    schedule=inv_t(1.0), n_rounds=9, weight_decay=1e-3,
                    scenario=jmake_scenario("cluster", n=N, seed=2),
                    sim=JSimSpec(JWaitForS(s=5), jlat, JSimConfig(**cfg)),
                    params=jr.params, eval_fn=jev, eval_every=4)
    assert h.sim_seconds == jh.sim_seconds
    assert h.eval_seconds == jh.eval_seconds
    assert [t for t, _ in h.eval_loss] == [0, 4, 8]
    assert h.n_active == jh.n_active
    assert set(h.as_dict()) == set(jh.as_dict())
    assert h.eval_curve()[1][0] == jh.eval_curve()[1][0]


# --------------------------------------------------------------------------- #
# the reference's tests/test_sim.py cases, against the port
# --------------------------------------------------------------------------- #

def blackout(seed=0):
    periods = np.array([4] * 3 + [3] * 3 + [8] * 3)
    offs = np.array([3] * 3 + [1] * 3 + [1] * 3)
    phases = np.random.default_rng(seed).integers(0, 8, N)
    return AdversarialParticipation(N, periods, offs, phases)


@pytest.fixture(scope="module")
def make_engine():
    cfg, X, y, idx = _data()
    model = build_model(cfg)

    def make(policy, algo, seed=0, participation=None, latency=None,
             config=None):
        runner = RoundRunner(
            model=model, algo=algo,
            batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                  seed=0),
            schedule=inv_t(1.0), weight_decay=1e-3, seed=seed, device=CPU)
        return FedSimEngine(
            runner, policy,
            participation if participation is not None else blackout(),
            latency if latency is not None
            else tiered_shifted_exponential(N, seed=7, device=CPU),
            config=config or SimConfig(epoch_s=4.0), seed=13 + seed)
    return make


def test_event_queue_fifo_on_ties():
    q = EventQueue()
    q.push(5.0, "arrival", client=0)
    q.push(1.0, "arrival", client=1)
    q.push(1.0, "arrival", client=2)
    popped = [q.pop() for _ in range(3)]
    assert [e.client for e in popped] == [1, 2, 0]
    assert popped[0].seq < popped[1].seq


def test_engine_deterministic_event_sequence(make_engine):
    logs = []
    for _ in range(2):
        eng = make_engine(Impatient(), MIFA(memory="array"))
        _, hist = eng.run(8)
        logs.append((list(eng.event_log), list(hist.sim_seconds)))
    assert logs[0] == logs[1]


def test_sim_seconds_strictly_increasing(make_engine):
    eng = make_engine(WaitForS(s=3), BiasedFedAvg())
    _, hist = eng.run(10)
    t = np.asarray(hist.sim_seconds)
    assert len(t) == 10 and np.all(np.diff(t) > 0)
    assert len(eng.runner.stats.times) == 10
    times, taus = eng.runner.stats.timeline()
    assert taus.shape == (10, N) and np.all(np.diff(times) > 0)


def test_impatient_never_slower_than_wait_for_all(make_engine):
    eng_imp = make_engine(Impatient(), BiasedFedAvg())
    eng_all = make_engine(WaitForAll(), BiasedFedAvg())
    eng_imp.run(10)
    eng_all.run(10)
    imp = [r["duration_s"] for r in eng_imp.round_log]
    al = [r["duration_s"] for r in eng_all.round_log]
    assert all(a <= b + 1e-9 for a, b in zip(imp, al))
    assert eng_imp.now < eng_all.now


def test_deadline_drops_late_responders(make_engine):
    eng = make_engine(Deadline(deadline_s=0.5), BiasedFedAvg())
    eng.run(6)
    assert all(r["duration_s"] == pytest.approx(0.5) for r in eng.round_log)
    assert any(r["n_late"] > 0 for r in eng.round_log[1:])
    assert all(r["n_applied"] < N for r in eng.round_log[1:])


def test_wait_for_s_applies_exactly_s(make_engine):
    eng = make_engine(WaitForS(s=4), BiasedFedAvg())
    eng.run(6)
    assert all(r["n_applied"] == 4 for r in eng.round_log)


def test_max_sim_seconds_stops_at_first_round_close_past_budget(make_engine):
    ref = make_engine(WaitForS(s=3), BiasedFedAvg())
    ref.run(20)
    budget = ref.round_log[4]["t_close"]
    eng = make_engine(WaitForS(s=3), BiasedFedAvg())
    _, hist = eng.run(20, max_sim_seconds=budget)
    assert len(hist.rounds) == 5
    assert hist.sim_seconds[-1] >= budget > hist.sim_seconds[-2]


def test_round0_all_devices_respond(make_engine):
    eng = make_engine(Impatient(), MIFA(memory="array"))
    assert eng.run_round(0)["n_applied"] == N


def test_simultaneous_arrivals_resolve_fifo(make_engine):
    always_on = TraceParticipation(np.ones((1, N), bool))
    lat = TraceLatency(np.full((1, N), 1.5), device=CPU)
    logs = []
    for _ in range(2):
        eng = make_engine(WaitForAll(), BiasedFedAvg(),
                          participation=always_on, latency=lat)
        eng.run(3)
        logs.append(list(eng.event_log))
        arrivals = [e for e in eng.event_log if e[2] == "arrival"
                    and e[4] == 1]
        assert [e[3] for e in arrivals] == list(range(N))
        assert len({e[0] for e in arrivals}) == 1
        seqs = [e[1] for e in arrivals]
        assert seqs == sorted(seqs)
    assert logs[0] == logs[1]


def test_zero_latency_devices_close_instantly(make_engine):
    always_on = TraceParticipation(np.ones((1, N), bool))
    lat = TraceLatency(np.zeros((1, N)), device=CPU)
    cfg = SimConfig(epoch_s=4.0, server_overhead_s=0.25)
    eng = make_engine(WaitForAll(), BiasedFedAvg(), participation=always_on,
                      latency=lat, config=cfg)
    _, hist = eng.run(4)
    assert all(r["duration_s"] == 0.0 for r in eng.round_log)
    assert all(r["n_applied"] == N for r in eng.round_log)
    np.testing.assert_allclose(hist.sim_seconds, [0.0, 0.25, 0.5, 0.75])


def test_deadline_with_empty_cohort(make_engine):
    eng = make_engine(Deadline(deadline_s=1.0, cohort_size=0),
                      BiasedFedAvg())
    eng.run(3)
    assert all(r["n_applied"] == 0 for r in eng.round_log)
    assert all(r["n_dispatched"] == 0 for r in eng.round_log)
    assert all(r["duration_s"] == pytest.approx(1.0) for r in eng.round_log)


def test_trace_participation_exhaustion_mid_run(make_engine):
    trace = np.ones((2, N), bool)
    trace[1, 0] = False                      # device 0 dark from epoch 1 on
    lat = TraceLatency(np.full((1, N), 0.5), device=CPU)
    cfg = SimConfig(epoch_s=1.0, max_lookahead_epochs=25)
    eng = make_engine(WaitForAll(), BiasedFedAvg(),
                      participation=TraceParticipation(trace), latency=lat,
                      config=cfg)
    with pytest.warns(UserWarning, match="max_lookahead_epochs"):
        eng.run(5)
    assert eng.round_log[0]["n_applied"] == N
    assert all(r["n_applied"] == N - 1 for r in eng.round_log[2:])
    assert np.isfinite(eng.now) and eng.n_never_total > 0


def test_engine_masks_have_bounded_staleness_under_blackouts(make_engine):
    """Impatient under the periodic blackouts: every applied mask's τ stays
    within the blackout length plus the rounds one epoch can hold."""
    eng = make_engine(Impatient(), MIFA())
    eng.run(12)
    tau = tau_matrix(np.stack(eng.applied_log), strict=False)
    assert tau.max() <= 8 and np.stack(eng.applied_log)[0].all()


def test_sim_requires_matching_widths(make_engine):
    with pytest.raises(ValueError, match="latency model has 4 devices"):
        make_engine(WaitForAll(), MIFA(),
                    latency=TraceLatency(np.ones((1, 4)), device=CPU))
