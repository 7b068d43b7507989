"""The port's scenarios (`repro_torch.scenarios`) and the runs under them,
against the JAX package's, on the CPU.

* `_threefry.uniform(round_key(seed_key(s), t), n)` is array-equal to
  `jax.random.uniform(fold_in(PRNGKey(s), t), (n,))`.
* For each of the seven registered processes and three seeds, 64 rounds at
  N = 6 and N = 100: the host surface and the device surface (run on CPU
  tensors) are array-equal to the reference's `host_sampler()`, and a
  fleet's stacked sample equals each trial's host surface.
* `stationary_rate`, `tau_bound`, `expected_tau` and
  `from_rate_and_burst`'s raise equal the reference's; the stateful order
  check, the round-0 convention and the registry's tags and errors.
* `run_fl(scenario=)` against the reference's from the reference's params
  (MIFA(array), BankedMIFA(dense), BiasedFedAvg here; FedAR, CAFed and
  FedBuffAvg in `tests/test_torch_algorithms.py`): n_active and τ
  statistics equal, losses and params within `tests/test_torch_run_fl.py`'s
  f32 bounds (rtol 1e-4, atol 1e-6).
* Within the port, scan is bit-equal to the loop in scenario mode, and
  `TauStats.absorb_scan` gives the loop's statistics exactly; a scenario
  fleet's trials are bit-equal to sequential port runs on both engines and
  within the f32 bounds of per-trial sequential reference runs (the
  reference's own fleet is not bit-exact; ROADMAP Queue 3).

The card's device surface and scenario scan are held by `cuda` cases in
`tests/test_torch_scan_engine.py`, which imports no JAX at the top.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import run_fl as jax_run_fl
from repro.data import ClientBatcher as JClientBatcher
from repro.models import build_model as jax_build
from repro.scenarios import make_process as jmake_process
from repro.scenarios import make_scenario as jmake_scenario
from repro.scenarios import scenario_names as jscenario_names
from repro_torch.bank import BankedMIFA, DenseBank
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import (MIFA, BiasedFedAvg, FedAvgSampling,
                              RoundRunner, TauStats, run_fl)
from repro_torch.core.scan_engine import ScanDriver
from repro_torch.data import (ClientBatcher, label_skew_partition,
                              make_classification)
from repro_torch.fleet import Trial, run_fleet
from repro_torch.models import build_model
from repro_torch.scenarios import (GilbertElliott, HostSampler, Scenario,
                                   make_process, make_scenario, register,
                                   scenario_names)
from repro_torch.scenarios import _threefry
from repro_torch.tree import tree_leaves, tree_stack

torch.set_num_threads(1)

N, T, CAP = 6, 12, 8
ROUNDS = 64
SEEDS = (0, 3, 11)
# kwargs that make a scenario interesting at small N
KW = {"staged_blackout": {"stage_len": 5}, "cluster": {"n_clusters": 3}}


def _kw(name):
    return KW.get(name, {})


# --------------------------------------------------------------------------- #
# threefry and the two sampling surfaces
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 3, 7, 123456])
def test_uniform_matches_jax(seed):
    for t in (0, 1, 5, 1000):
        for n in (1, 6, 100, 1001):
            ref = jax.random.uniform(
                jax.random.fold_in(jax.random.PRNGKey(seed), t), (n,))
            got = _threefry.uniform(
                _threefry.round_key(_threefry.seed_key(seed), t), n)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_round_keys_broadcast_over_trials():
    """(K, 2) keys with a (K,) or 0-d round give each trial its own row."""
    seeds = (1, 2, 3)
    keys = torch.stack([_threefry.seed_key(s) for s in seeds])
    for t in (torch.full((3,), 4, dtype=torch.int64), torch.tensor(4)):
        got = _threefry.uniform(_threefry.round_key(keys, t), 10).numpy()
        for k, s in enumerate(seeds):
            ref = jax.random.uniform(
                jax.random.fold_in(jax.random.PRNGKey(s), 4), (10,))
            np.testing.assert_array_equal(got[k], np.asarray(ref))
    for seed in (-1, 2**32 + 5):        # jax keeps the seed's low word
        np.testing.assert_array_equal(
            _threefry.seed_key(seed).numpy(),
            np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(jscenario_names()))
def test_masks_match_reference(name, seed):
    for n in (N, 100):
        ref = jmake_process(name, n=n, seed=seed, **_kw(name)).host_sampler()
        proc = make_process(name, n=n, seed=seed, **_kw(name))
        host = proc.host_sampler()
        fn, state, key = proc.sample_fn(), proc.init_state("cpu"), proc.key
        for t in range(ROUNDS):
            want = ref.sample(t)
            np.testing.assert_array_equal(host.sample(t), want)
            mask, state = fn(key, torch.tensor(t), state)
            assert mask.dtype == torch.bool
            np.testing.assert_array_equal(mask.numpy(), want)


FLEET_KW = {
    "bernoulli": [{"probs": 0.3}, {"probs": 0.8}],
    "bernoulli_drift": [{"drift": -0.01}, {"p0": 0.3, "drift": 0.02}],
    "gilbert_elliott": [{"burst": 2.0}, {"burst": 8.0}],
    "cluster": [{"n_clusters": 3, "q_fail": 0.1},
                {"n_clusters": 3, "q_fail": 0.3}],
    "diurnal": [{"base": 0.5}, {"base": 0.3, "amplitude": 0.2}],
    "staged_blackout": [{"stage_len": 5}, {"stage_len": 7}],
    "adversarial": [{"offs": 2}, {"periods": 5, "offs": 4}]}


@pytest.mark.parametrize("name", sorted(FLEET_KW))
def test_fleet_sample_matches_host_surfaces(name):
    """Trials of one type with different parameters, stacked: one sample
    over (K, 2) keys and a (K,) round equals each trial's host surface."""
    procs = [make_process(name, n=20, seed=s, **kw)
             for s, kw in zip((1, 5), FLEET_KW[name])]
    state = tree_stack([p.init_state("cpu") for p in procs])
    keys = torch.stack([p.key for p in procs])
    hosts = [p.host_sampler() for p in procs]
    fn = procs[0].sample_fn()
    for t in range(40):
        masks, state = fn(keys, torch.full((2,), t), state)
        for k, h in enumerate(hosts):
            np.testing.assert_array_equal(masks[k].numpy(), h.sample(t))


@pytest.mark.parametrize("name", sorted(jscenario_names()))
def test_theory_matches_reference(name):
    for n in (N, 100):
        ref = jmake_process(name, n=n, seed=0, **_kw(name))
        got = make_process(name, n=n, seed=0, **_kw(name))
        np.testing.assert_array_equal(got.stationary_rate(),
                                      ref.stationary_rate())
        a, b = got.tau_bound(), ref.tau_bound()
        assert (a.deterministic, a.t0, a.note) == (b.deterministic, b.t0,
                                                   b.note)
        np.testing.assert_array_equal(a.expected_tau, b.expected_tau)
        assert a.holds(3.0) == b.holds(3.0)
        assert got.stateless == ref.stateless


def test_gilbert_elliott_closed_forms_and_raises():
    from repro.scenarios import GilbertElliott as JGE
    for rate, burst in ((0.5, 4.0), (0.2, 8.0), (0.9, 1.0)):
        a = GilbertElliott.from_rate_and_burst(rate, burst, n=5)
        b = JGE.from_rate_and_burst(rate, burst, n=5)
        assert a.expected_tau() == b.expected_tau()
        np.testing.assert_array_equal(a.p_fail, b.p_fail)
        np.testing.assert_array_equal(a.p_recover, b.p_recover)
    for rate, burst in ((0.2, 2.0), (0.5, 0.5)):
        with pytest.raises(ValueError) as want:
            JGE.from_rate_and_burst(rate, burst, n=5)
        with pytest.raises(ValueError) as got:
            GilbertElliott.from_rate_and_burst(rate, burst, n=5)
        assert str(got.value) == str(want.value)


def test_stateful_order_check_and_round_zero():
    ge = make_process("gilbert_elliott", n=N, seed=1, rate=0.2, burst=8.0)
    host = ge.host_sampler()
    assert isinstance(host, HostSampler) and host.n == N
    host.sample(0)
    with pytest.raises(ValueError, match="expected t=1, got t=2"):
        host.sample(2)
    fresh = ge.host_sampler()
    np.testing.assert_array_equal(ge.host_sampler().sample_block(0, 5),
                                  [fresh.sample(t) for t in range(5)])
    # memoryless processes take any round
    bern = make_process("bernoulli", n=N, seed=1)
    np.testing.assert_array_equal(bern.host_sampler().sample(7),
                                  bern.host_sampler().sample(7))
    # round 0 is all-active on both surfaces, even where no device could be
    dark = [make_process("bernoulli", n=N, probs=0.0),
            make_process("staged_blackout", n=N, stage_probs=np.zeros(
                (2, N)), bounds=[3]),
            make_process("cluster", n=N, q_fail=1.0, p_device=0.0)]
    for proc in dark:
        assert proc.host_sampler().sample(0).all()
        mask, _ = proc.sample_fn()(proc.key, torch.tensor(0),
                                   proc.init_state("cpu"))
        assert bool(mask.all())
        assert not proc.host_sampler().sample_block(0, 2)[1].any()


def test_registry_tags_and_errors():
    assert scenario_names() == sorted(jscenario_names())
    for name, kw in (("gilbert_elliott", {"rate": 0.5, "burst": 8.0}),
                     ("cluster", {"assignment": np.arange(N) % 2,
                                  "n_clusters": 2}),
                     ("bernoulli", {})):
        got = make_scenario(name, n=N, seed=4, **kw)
        assert isinstance(got, Scenario) and got.n == N
        assert got.name == jmake_scenario(name, n=N, seed=4, **kw).name
    with pytest.raises(KeyError, match="unknown scenario"):
        make_process("nope", n=N)
    with pytest.raises(ValueError, match="already registered"):
        register("bernoulli", lambda **kw: None)
    with pytest.raises(ValueError, match="no latency model"):
        make_scenario("bernoulli", n=N).sim_inputs()
    host, lat = make_scenario("bernoulli", n=N, latency="rtt").sim_inputs()
    assert isinstance(host, HostSampler) and lat == "rtt"
    # trace replay and elastic fleets (ROADMAP Queue 1 item 17) are ported
    import repro_torch.scenarios as S
    from repro_torch.scenarios import elastic, trace_replay
    for name in ("TraceReplay", "TraceFile", "open_trace", "cached_trace",
                 "synthesize_trace", "write_trace"):
        assert getattr(S, name) is getattr(trace_replay, name)
    for name in ("ElasticProcess", "elastic_capacity", "staged_arrivals"):
        assert getattr(S, name) is getattr(elastic, name)


# --------------------------------------------------------------------------- #
# runs under a scenario
# --------------------------------------------------------------------------- #

def _problem(n_clients=N):
    cfg = get_config("paper_mlp").replace(fl_clients=n_clients)
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    idx, _ = label_skew_partition(y, n_clients, seed=0)
    return cfg, X, y, idx


def _run(algo, scenario, engine="loop", params=None, **over):
    cfg, X, y, idx = _problem()
    kw = dict(model=build_model(cfg), algo=algo, scenario=scenario,
              batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                    seed=0),
              schedule=lambda t: 0.1 / (1 + t), n_rounds=T,
              weight_decay=1e-3, seed=0, cohort_capacity=CAP, params=params,
              engine=engine, scan_chunk=5, device="cpu")
    kw.update(over)
    return run_fl(**kw)


def _jax_run(algo, scenario, jparams, seed=0):
    cfg, X, y, idx = _problem()
    jmodel = jax_build(jax_config("paper_mlp").replace(fl_clients=N))
    return jax_run_fl(model=jmodel, algo=algo, scenario=scenario,
                      batcher=JClientBatcher(X, y, idx, batch_size=8,
                                             k_steps=2, seed=0),
                      schedule=lambda t: 0.1 / (1 + t), n_rounds=T,
                      weight_decay=1e-3, seed=seed, cohort_capacity=CAP,
                      params=jparams)


def _jparams(seed=0):
    jmodel = jax_build(jax_config("paper_mlp").replace(fl_clients=N))
    return jmodel.init(jax.random.PRNGKey(seed))


def _tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")


def assert_matches_reference(port, ref):
    """`tests/test_torch_run_fl.py`'s bounds: masks and τ equal, losses
    and params within rtol 1e-4, atol 1e-6."""
    (pt, ht), (pj, hj) = port, ref
    assert ht.n_active == hj.n_active and ht.rounds == hj.rounds
    assert (ht.tau_bar, ht.tau_max) == (hj.tau_bar, hj.tau_max)
    np.testing.assert_allclose(ht.train_loss, hj.train_loss, rtol=1e-4,
                               atol=1e-6)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def _reference_algo(name):
    from repro.bank import BankedMIFA as JBankedMIFA
    from repro.bank import DenseBank as JDenseBank
    from repro.core import MIFA as JMIFA
    from repro.core import BiasedFedAvg as JBiasedFedAvg
    return {"mifa_array": JMIFA, "banked_dense": lambda: JBankedMIFA(
        JDenseBank()), "fedavg": JBiasedFedAvg}[name]()


ALGOS = {"mifa_array": MIFA,
         "banked_dense": lambda: BankedMIFA(DenseBank(device="cpu")),
         "fedavg": BiasedFedAvg}
RUN_SCENARIOS = {"mifa_array": ("gilbert_elliott", {"burst": 8.0}),
                 "banked_dense": ("cluster", {"n_clusters": 2}),
                 "fedavg": ("diurnal", {"period": 5})}


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_run_fl_scenario_matches_reference(name):
    scen, kw = RUN_SCENARIOS[name]
    jparams = _jparams()
    ref = _jax_run(_reference_algo(name),
                   jmake_scenario(scen, n=N, seed=5, **kw), jparams)
    port = _run(ALGOS[name](), make_scenario(scen, n=N, seed=5, **kw),
                params=_tparams(jparams))
    assert_matches_reference(port, ref)
    assert 0 < np.mean(port[1].n_active) < N     # the scenario bit


def _assert_same(run_a, run_b):
    (pa, ha), (pb, hb) = run_a, run_b
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(a, b)
    assert ha.train_loss == hb.train_loss
    assert ha.n_active == hb.n_active and ha.rounds == hb.rounds
    assert ha.global_updates == hb.global_updates
    assert (ha.tau_bar, ha.tau_max) == (hb.tau_bar, hb.tau_max)


SCAN_CASES = {
    "mifa_array-gilbert_elliott": (MIFA, "gilbert_elliott", {"burst": 8.0}),
    "mifa_int8-cluster": (lambda: MIFA(memory="int8"), "cluster",
                          {"n_clusters": 2}),
    "fedavg_sampling-staged_blackout": (lambda: FedAvgSampling(s=3),
                                        "staged_blackout", {"stage_len": 3}),
    "banked_dense-gilbert_elliott": (ALGOS["banked_dense"],
                                     "gilbert_elliott", {}),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_bitexact_vs_loop_in_scenario_mode(case):
    make, scen, kw = SCAN_CASES[case]
    loop = _run(make(), make_scenario(scen, n=N, seed=2, **kw))
    for chunk in (1, 5, T):
        scan = _run(make(), make_scenario(scen, n=N, seed=2, **kw),
                    engine="scan_strict", scan_chunk=chunk)
        _assert_same(loop, scan)


def _runner(make, scen):
    cfg, X, y, idx = _problem()
    return RoundRunner(model=build_model(cfg), algo=make(),
                       batcher=ClientBatcher(X, y, idx, batch_size=8,
                                             k_steps=2, seed=0),
                       schedule=lambda t: 0.1 / (1 + t), scenario=scen,
                       device="cpu")


def _stats(s: TauStats):
    return (s.tau.tolist(), s.tau_max_per_dev.tolist(), s.sum_tau,
            s.sum_tau_sq, s.rounds, s.tau_bar, s.tau_max, s.d_bar,
            s.d_max_bar, s.tau_max_bar)


def test_scan_tau_stats_equal_the_loops():
    """The scan keeps τ on the device and merges it a chunk at a time with
    `absorb_scan`; every statistic equals the loop's, which reads each
    mask back."""
    scen = make_scenario("gilbert_elliott", n=N, seed=9, rate=0.3, burst=6)
    loop = _runner(MIFA, scen)
    for t in range(T):
        loop.step_scenario(t)
    scan = _runner(MIFA, scen)
    driver = ScanDriver(scan, scan_chunk=5)
    driver.run(T)
    assert driver.scenario_mode and driver.staged_bytes > 0
    assert loop.stats.tau_max > 3          # long bursts reached
    assert _stats(scan.stats) == _stats(loop.stats)
    assert scan.hist.n_active == loop.hist.n_active
    for a, b in zip(tree_leaves(scan.scen_state), tree_leaves(
            loop.scen_state)):
        assert torch.equal(a, b)


def test_absorb_scan_equals_update():
    masks = np.random.default_rng(0).random((30, 9)) < 0.4
    masks[0] = True
    ref = TauStats(9)
    for m in masks:
        ref.update(m)
    got, tau, tau_max = TauStats(9), np.zeros(9, np.int64), np.zeros(9)
    for lo in range(0, 30, 7):
        sums, sq = [], []
        for m in masks[lo:lo + 7]:
            tau = np.where(m, 0, tau + 1)
            tau_max = np.maximum(tau_max, tau)
            sums.append(tau.sum())
            sq.append((tau * tau).sum())
        got.absorb_scan(tau, tau_max, np.array(sums), np.array(sq))
    assert _stats(got) == _stats(ref)
    with pytest.raises(ValueError, match="round 0 must be all-active"):
        TauStats(9).absorb_scan(tau, tau_max, np.array([2]), np.array([4]))
    TauStats(9, strict=False).absorb_scan(tau, tau_max, np.array([2]),
                                          np.array([4]))


def test_run_fl_takes_exactly_one_availability_source():
    scen = make_scenario("bernoulli", n=N)
    from repro_torch.core import BernoulliParticipation
    with pytest.raises(ValueError, match="exactly one of"):
        _run(MIFA(), scen, participation=BernoulliParticipation(
            np.full(N, 0.5)))
    with pytest.raises(ValueError, match="exactly one of"):
        _run(MIFA(), None)
    with pytest.raises(ValueError, match="has 7 devices"):
        _run(MIFA(), make_scenario("bernoulli", n=N + 1))
    # a bare process works as well as a Scenario
    _assert_same(_run(MIFA(), scen), _run(MIFA(), scen.process))


# --------------------------------------------------------------------------- #
# scenario fleets
# --------------------------------------------------------------------------- #

BURSTS = (2.0, 4.0, 8.0)
FLEET_CASES = {"mifa_array": (MIFA, "gilbert_elliott"),
               "banked_dense": (ALGOS["banked_dense"], "cluster")}


def _scen_kw(scen, k):
    return ({"burst": BURSTS[k]} if scen == "gilbert_elliott"
            else {"n_clusters": 2, "q_fail": 0.1 * (k + 1)})


@pytest.mark.parametrize("name", sorted(FLEET_CASES))
def test_scenario_fleet_matches_sequential_runs(name):
    make, scen = FLEET_CASES[name]
    jparams = [_jparams(s) for s in range(3)]
    params = tree_stack([_tparams(p) for p in jparams])
    cfg, X, y, idx = _problem()

    def scenario(k, pkg=make_scenario):
        return pkg(scen, n=N, seed=20 + k, **_scen_kw(scen, k))

    trials = [Trial(seed=k, scenario=scenario(k)) for k in range(3)]
    fleets = {}
    for engine in ("loop", "scan"):
        fleets[engine] = run_fleet(
            model=build_model(cfg), algo=make(),
            batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                  seed=0),
            schedule=lambda t: 0.1 / (1 + t), n_rounds=T, trials=trials,
            weight_decay=1e-3, cohort_capacity=CAP, params=params,
            engine=engine, scan_chunk=5, device="cpu")
    (pf, hf), (ps, hs) = fleets["loop"], fleets["scan"]
    for a, b in zip(tree_leaves(pf), tree_leaves(ps)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(hf.stacked()["train_loss"],
                                  hs.stacked()["train_loss"])
    for k in range(3):
        seq = _run(make(), scenario(k), seed=k, params=_tparams(jparams[k]))
        trial = hf.trial(k)
        assert trial.train_loss == seq[1].train_loss
        assert trial.n_active == seq[1].n_active
        for a, b in zip(tree_leaves(pf), tree_leaves(seq[0])):
            assert torch.equal(a[k], b)
        ref_algo = _reference_algo(name)
        pj, hj = _jax_run(ref_algo, scenario(k, jmake_scenario), jparams[k],
                          seed=k)
        assert trial.n_active == hj.n_active
        np.testing.assert_allclose(trial.train_loss, hj.train_loss,
                                   rtol=1e-4, atol=1e-6)
        for a, b in zip(tree_leaves(pf), jax.tree.leaves(pj)):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)


def test_scenario_fleet_groups_and_errors():
    cfg, X, y, idx = _problem()
    kw = dict(model=build_model(cfg), algo=MIFA(),
              batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                    seed=0),
              schedule=lambda t: 0.1 / (1 + t), n_rounds=2, device="cpu")
    from repro_torch.core import BernoulliParticipation
    part = BernoulliParticipation(np.full(N, 0.5))
    with pytest.raises(ValueError, match="mixing scenario"):
        run_fleet(trials=[Trial(seed=0, participation=part),
                          Trial(seed=1, scenario=make_scenario(
                              "bernoulli", n=N))], **kw)
    with pytest.raises(ValueError, match="share a scenario type"):
        run_fleet(trials=[Trial(seed=0, scenario=make_scenario(
            "bernoulli", n=N)), Trial(seed=1, scenario=make_scenario(
                "adversarial", n=N))], **kw)
    with pytest.raises(ValueError, match="exactly one of"):
        Trial(seed=0, participation=part, scenario=make_scenario(
            "bernoulli", n=N))
