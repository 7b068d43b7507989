"""The port's scan engine (`core.scan_engine`, `run_fl(engine="scan")`,
`run_fleet(engine="scan")`): the counterparts of the JAX package's
`tests/test_scan_engine.py` cases for host participation, at N=6 clients,
T=9 rounds, `cohort_capacity=8`, and the port's scan held to the
reference's.

* Within the port, scan is bit-equal to the loop on the CPU (params,
  losses, n_active, τ), for every chunking: both run the same round body
  on the same inputs.
* Against the reference's `run_fl(engine="scan")` from the same params and
  masks: losses and params within the loop parity tests' tolerances
  (`tests/test_torch_run_fl.py`: rtol 1e-4, atol 1e-6), masks and τ equal.
* Fallbacks (update-clock schedules, host banks) warn and loop under
  "scan" and raise under "scan_strict".
* Scenario-mode scan runs (its parity tests are in
  `tests/test_torch_scenarios.py`); a windowed process (trace replay)
  raises for a chunk wider than its window.
* On the card (`cuda`): the compiled simulator bit-equal to the heap
  engine (`tests/test_torch_sim_compiled.py` holds it on the CPU), and
  the host bank's rows and the paged bank's spill store pinned.

The `cuda` cases replay the captured round on the card and skip here;
the module imports JAX only inside the reference test, so on the card
they run with `--noconftest -m cuda`.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.bank import (BankedMIFA, DenseBank, Int8PagedBank,
                              PagedDeviceBank)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import (MIFA, BiasedFedAvg, FedAvgIS, FedAvgSampling,
                              RoundRunner, TraceParticipation, run_fl)
from repro_torch.core import runner as runner_mod
from repro_torch.core.scan_engine import ChunkRunner, chunk_bounds
from repro_torch.data import (ClientBatcher, label_skew_partition,
                              make_classification)
from repro_torch.fleet import Trial, run_fleet
from repro_torch.kernels.ops import launch_counters
from repro_torch.models import build_model
from repro_torch.scenarios import make_process, make_scenario
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

N, T, CAP = 6, 9, 8


def _algos(device):
    return {
        "mifa_array": lambda: MIFA(memory="array"),
        "mifa_delta": lambda: MIFA(memory="delta"),
        "mifa_int8": lambda: MIFA(memory="int8"),
        "mifa_bf16": lambda: MIFA(memory_dtype="bfloat16"),
        "banked_dense": lambda: BankedMIFA(DenseBank(device=device)),
        "banked_paged": lambda: BankedMIFA(PagedDeviceBank(
            page_size=4, device=device)),
        "banked_paged_int8": lambda: BankedMIFA(PagedDeviceBank(
            page_size=4, dtype="int8", device=device)),
        "fedavg": lambda: BiasedFedAvg(),
        "fedavg_is": lambda: FedAvgIS(tuple(np.linspace(0.2, 1.0, N))),
        "fedavg_sampling": lambda: FedAvgSampling(s=3),
    }


ALGOS = _algos("cpu")


def _problem(n_clients=N, model_name="paper_logistic"):
    cfg = get_config(model_name).replace(fl_clients=n_clients)
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    idx, _ = label_skew_partition(y, n_clients, seed=0)
    return cfg, X, y, idx


def _kw(device="cpu", **over):
    cfg, X, y, idx = _problem()
    kw = dict(model=build_model(cfg),
              batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                    seed=0),
              schedule=lambda t: 0.1 / (1 + t), n_rounds=T,
              weight_decay=1e-3, seed=0, cohort_capacity=CAP, device=device)
    kw.update(over)
    return kw


def _trace(seed=3, shape=(T, N)):
    return np.random.default_rng(seed).random(shape) < 0.5


def _assert_same(run_a, run_b):
    (pa, ha), (pb, hb) = run_a, run_b
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(a, b)
    assert ha.train_loss == hb.train_loss
    assert ha.n_active == hb.n_active
    assert ha.global_updates == hb.global_updates
    assert ha.rounds == hb.rounds
    assert (ha.tau_bar, ha.tau_max) == (hb.tau_bar, hb.tau_max)


@pytest.fixture(autouse=True)
def _fresh_fallback_warnings():
    runner_mod._reset_fallback_warnings()
    yield


# --------------------------------------------------------------------------- #
# bit-equal to the port's loop
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", list(ALGOS))
def test_scan_bitexact_vs_loop_participation(name):
    kw = _kw()
    loop = run_fl(algo=ALGOS[name](), engine="loop",
                  participation=TraceParticipation(_trace()), **kw)
    scan = run_fl(algo=ALGOS[name](), engine="scan", scan_chunk=4,
                  participation=TraceParticipation(_trace()), **kw)
    _assert_same(loop, scan)


@pytest.mark.parametrize("chunk", [1, 7, T])
def test_scan_chunk_boundary_invariance(chunk):
    kw = _kw()
    ref = run_fl(algo=FedAvgSampling(s=3), engine="loop",
                 participation=TraceParticipation(_trace()), **kw)
    got = run_fl(algo=FedAvgSampling(s=3), engine="scan", scan_chunk=chunk,
                 participation=TraceParticipation(_trace()), **kw)
    _assert_same(ref, got)


def test_scan_eval_rounds_match_loop():
    kw = _kw()
    ev = lambda p: (float(p["w"].sum()), 0.25)   # noqa: E731
    loop = run_fl(algo=MIFA(), engine="loop", eval_fn=ev, eval_every=4,
                  participation=TraceParticipation(_trace()), **kw)
    scan = run_fl(algo=MIFA(), engine="scan", scan_chunk=5, eval_fn=ev,
                  eval_every=4, participation=TraceParticipation(_trace()),
                  **kw)
    assert loop[1].eval_loss == scan[1].eval_loss
    assert [t for t, _ in scan[1].eval_loss] == [0, 4, 8]


def test_scan_stages_one_buffer_a_chunk_and_never_steps(monkeypatch):
    """The scan runs the round body on staged chunks: one staging a chunk
    (chunks cut at 4 and after the eval rounds 0 and 8), never the loop's
    per-round `RoundRunner.step`."""
    staged = []
    real = ChunkRunner.stage

    def stage(self, rounds):
        staged.append(len(rounds))
        return real(self, rounds)

    def boom(self, *a, **k):
        raise AssertionError("the scan engine called RoundRunner.step")

    monkeypatch.setattr(ChunkRunner, "stage", stage)
    monkeypatch.setattr(RoundRunner, "step", boom)
    monkeypatch.setattr(RoundRunner, "step_cohort", boom)
    for algo in (MIFA(), BankedMIFA(DenseBank(device="cpu"))):
        staged.clear()
        _, hist = run_fl(algo=algo, engine="scan", scan_chunk=4,
                         eval_fn=lambda p: (0.0, 0.0), eval_every=8,
                         participation=TraceParticipation(_trace()),
                         **_kw())
        assert staged == [1, 3, 4, 1] and len(hist.train_loss) == T


# --------------------------------------------------------------------------- #
# fallbacks, strictness, capacity
# --------------------------------------------------------------------------- #

def _host_bank():
    return BankedMIFA(Int8PagedBank(page_size=2, device="cpu"))


def test_scan_host_bank_falls_back_to_loop():
    kw = _kw()
    ref = run_fl(algo=_host_bank(), engine="loop",
                 participation=TraceParticipation(_trace()), **kw)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = run_fl(algo=_host_bank(), engine="scan",
                     participation=TraceParticipation(_trace()), **kw)
    msg = next(str(x.message) for x in w if "falling back" in str(x.message))
    assert "Int8PagedBank" in msg
    assert "DenseBank" in msg and "PagedDeviceBank" in msg
    _assert_same(ref, got)
    with pytest.raises(ValueError, match="host-offloaded"):
        run_fl(algo=_host_bank(), engine="scan_strict",
               participation=TraceParticipation(_trace()), **kw)


def test_scan_update_clock_falls_back():
    kw = _kw(uses_update_clock=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = run_fl(algo=FedAvgSampling(s=3), engine="scan",
                     participation=TraceParticipation(_trace()), **kw)
        assert any("update-clock" in str(x.message) for x in w)
    ref = run_fl(algo=FedAvgSampling(s=3), engine="loop",
                 participation=TraceParticipation(_trace()), **kw)
    _assert_same(ref, got)
    with pytest.raises(ValueError, match="update-clock"):
        run_fl(algo=FedAvgSampling(s=3), engine="scan_strict",
               participation=TraceParticipation(_trace()), **kw)


def test_unknown_engine_and_scenario_scan_rejected():
    with pytest.raises(ValueError, match="unknown engine"):
        run_fl(algo=MIFA(), engine="turbo",
               participation=TraceParticipation(_trace()), **_kw())
    # scenario mode (ROADMAP Queue 1 item 13) is ported: the scan runs it,
    # bit-equal to the loop; a windowed process (item 17) raises for a
    # chunk wider than its window
    scen = make_scenario("gilbert_elliott", n=N, seed=1)
    _assert_same(run_fl(algo=MIFA(), engine="loop", scenario=scen, **_kw()),
                 run_fl(algo=MIFA(), engine="scan", scenario=scen, **_kw()))
    windowed = make_process("bernoulli", n=N)
    windowed.scan_window = 4
    with pytest.raises(ValueError, match="window"):
        run_fl(algo=MIFA(), engine="scan", scenario=windowed, **_kw())
    with pytest.raises(ValueError, match="scan_chunk"):
        run_fl(algo=MIFA(), engine="scan", scan_chunk=0,
               participation=TraceParticipation(_trace()), **_kw())


def test_scan_cohort_capacity_overflow_raises():
    kw = _kw(cohort_capacity=2)
    with pytest.raises(ValueError, match="overflows the scan capacity"):
        run_fl(algo=BankedMIFA(DenseBank(device="cpu")), engine="scan",
               participation=TraceParticipation(np.ones((T, N), bool)), **kw)


# --------------------------------------------------------------------------- #
# the paged bank under scan: eviction, chunk-union residency
# --------------------------------------------------------------------------- #

class _RawTrace:
    """Replay without TraceParticipation's all-active round 0: eviction
    needs sparse cohorts from the first round."""

    def __init__(self, trace):
        self.trace = np.asarray(trace, bool)

    def sample(self, t):
        return self.trace[t]


def _paged_trace():
    """Cohorts that, at page_size=2 / n_slots=2, fit per round but force
    evictions and re-faults across the run."""
    cohorts = [[0, 1], [4, 5], [2, 3], [0, 5], [2], [1, 3], [4], [0, 2]]
    tr = np.zeros((len(cohorts), N), bool)
    for t, ids in enumerate(cohorts):
        tr[t, ids] = True
    return tr


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_scan_paged_eviction_bitexact_vs_loop(dtype):
    tr = _paged_trace()
    kw = _kw(n_rounds=len(tr), cohort_capacity=2)

    def paged():
        return BankedMIFA(PagedDeviceBank(page_size=2, n_slots=2,
                                          dtype=dtype, device="cpu"))
    loop = run_fl(algo=paged(), engine="loop", participation=_RawTrace(tr),
                  **kw)
    algo = paged()
    scan = run_fl(algo=algo, engine="scan", scan_chunk=1,
                  participation=_RawTrace(tr), **kw)
    _assert_same(loop, scan)
    assert algo.bank.evictions > 0 and algo.bank.refaults > 0
    if dtype == "float32":
        dense = run_fl(algo=BankedMIFA(DenseBank(device="cpu")),
                       engine="loop", participation=_RawTrace(tr), **kw)
        _assert_same(dense, scan)


def test_scan_paged_chunk_union_overflow_raises():
    tr = _paged_trace()
    kw = _kw(n_rounds=len(tr), cohort_capacity=2)
    with pytest.raises(ValueError, match="slots"):
        run_fl(algo=BankedMIFA(PagedDeviceBank(page_size=2, n_slots=2,
                                               device="cpu")),
               engine="scan", scan_chunk=2, participation=_RawTrace(tr),
               **kw)


# --------------------------------------------------------------------------- #
# the fleet's scan
# --------------------------------------------------------------------------- #

FLEET_ALGOS = ("mifa_array", "mifa_int8", "banked_dense", "banked_paged",
               "banked_paged_int8", "fedavg", "fedavg_sampling")


def _fleet_kw(device="cpu"):
    kw = _kw(device=device)
    del kw["seed"]
    return kw


@pytest.mark.parametrize("name", FLEET_ALGOS)
def test_fleet_scan_bitexact_vs_fleet_loop(name):
    traces = _trace(7, (3, T, N))

    def trials():
        return [Trial(seed=k, participation=TraceParticipation(traces[k]))
                for k in range(3)]
    loop = run_fleet(algo=ALGOS[name](), trials=trials(), engine="loop",
                     **_fleet_kw())
    scan = run_fleet(algo=ALGOS[name](), trials=trials(), engine="scan",
                     scan_chunk=4, **_fleet_kw())
    for a, b in zip(tree_leaves(loop[0]), tree_leaves(scan[0])):
        assert torch.equal(a, b)
    for k in range(3):
        assert loop[1].trial(k).train_loss == scan[1].trial(k).train_loss
        assert loop[1].trial(k).n_active == scan[1].trial(k).n_active
        assert (loop[1].trial(k).global_updates
                == scan[1].trial(k).global_updates)


def test_fleet_scan_update_clock_falls_back():
    traces = np.ones((2, T, N), bool)
    trials = [Trial(seed=k, participation=TraceParticipation(traces[k]))
              for k in range(2)]
    kw = dict(_fleet_kw(), n_rounds=3, uses_update_clock=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        run_fleet(algo=FedAvgSampling(s=3), trials=trials, engine="scan",
                  **kw)
        assert any("update-clock" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="update-clock"):
        run_fleet(algo=FedAvgSampling(s=3), trials=trials,
                  engine="scan_strict", **kw)


def test_chunk_bounds_snap_to_evals():
    assert chunk_bounds(10, 4, set()) == [(0, 4), (4, 8), (8, 10)]
    assert chunk_bounds(10, 4, {0, 5}) == [(0, 1), (1, 4), (4, 6), (6, 8),
                                           (8, 10)]
    assert chunk_bounds(3, 100, set()) == [(0, 3)]
    with pytest.raises(ValueError, match="scan_chunk"):
        chunk_bounds(10, 0, set())


# --------------------------------------------------------------------------- #
# the port's scan against the reference's scan
# --------------------------------------------------------------------------- #

def _reference_algos():
    from repro.bank import BankedMIFA as JBankedMIFA
    from repro.bank import DenseBank as JDenseBank
    from repro.bank import PagedDeviceBank as JPagedDeviceBank
    from repro.core import MIFA as JMIFA
    from repro.core import BiasedFedAvg as JBiasedFedAvg
    return {"mifa_array": lambda: JMIFA(memory="array"),
            "banked_dense": lambda: JBankedMIFA(JDenseBank()),
            "banked_paged": lambda: JBankedMIFA(JPagedDeviceBank(
                page_size=4)),
            "fedavg": lambda: JBiasedFedAvg()}


@pytest.mark.parametrize("name", ["mifa_array", "banked_dense",
                                  "banked_paged", "fedavg"])
def test_scan_matches_reference_scan(name):
    import jax

    from repro.configs import get_config as jax_config
    from repro.core import TraceParticipation as JTrace
    from repro.core import run_fl as jax_run_fl
    from repro.data import ClientBatcher as JClientBatcher
    from repro.models import build_model as jax_build
    cfg, X, y, idx = _problem(model_name="paper_mlp")
    jmodel = jax_build(jax_config("paper_mlp").replace(fl_clients=N))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    common = dict(schedule=lambda t: 0.1 / (1 + t), n_rounds=T,
                  weight_decay=1e-3, cohort_capacity=CAP, scan_chunk=4,
                  engine="scan")
    pj, hj = jax_run_fl(model=jmodel, algo=_reference_algos()[name](),
                        batcher=JClientBatcher(X, y, idx, batch_size=8,
                                               k_steps=2, seed=0),
                        participation=JTrace(_trace()), params=jparams,
                        **common)
    pt, ht = run_fl(model=build_model(cfg), algo=ALGOS[name](),
                    batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                          seed=0),
                    participation=TraceParticipation(_trace()),
                    params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                           "cpu"), device="cpu", **common)
    assert ht.n_active == hj.n_active and ht.rounds == hj.rounds
    assert (ht.tau_bar, ht.tau_max) == (hj.tau_bar, hj.tau_max)
    np.testing.assert_allclose(ht.train_loss, hj.train_loss, rtol=1e-4,
                               atol=1e-6)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


# --------------------------------------------------------------------------- #
# on the card: captured rounds
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured round runs only on "
                    "the card")
    return "cuda"


def _counts():
    return {k: fn.launches for k, fn in launch_counters().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ALGOS))
def test_cuda_scan_replays_bitexact_vs_loop(cuda_device, name):
    """On the card the scan replays one captured round a round: bit-equal
    to the card's loop, and each kernel counted once a replay plus once
    for the warm-up before capture."""
    kw = _kw(device=cuda_device)
    make = _algos(cuda_device)[name]
    before = _counts()
    loop = run_fl(algo=make(), engine="loop",
                  participation=TraceParticipation(_trace()), **kw)
    loop_counts = {k: v - before[k] for k, v in _counts().items()}
    before = _counts()
    scan = run_fl(algo=make(), engine="scan", scan_chunk=4,
                  participation=TraceParticipation(_trace()), **kw)
    scan_counts = {k: v - before[k] for k, v in _counts().items()}
    _assert_same(loop, scan)
    assert scan_counts == {k: v + v // T for k, v in loop_counts.items()}


# scenario mode on the card: the device surface and the captured round

SCEN_CASES = {
    "mifa_array-gilbert_elliott": (lambda d: MIFA(), "gilbert_elliott",
                                   {"burst": 8.0}),
    "mifa_int8-cluster": (lambda d: MIFA(memory="int8"), "cluster",
                          {"n_clusters": 2}),
    "fedavg_sampling-staged_blackout": (lambda d: FedAvgSampling(s=3),
                                        "staged_blackout", {"stage_len": 3}),
    "banked_dense-gilbert_elliott": (lambda d: BankedMIFA(DenseBank(
        device=d)), "gilbert_elliott", {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adversarial", "bernoulli",
                                  "bernoulli_drift", "cluster", "diurnal",
                                  "gilbert_elliott", "staged_blackout"])
def test_cuda_device_surface_equals_cpu(cuda_device, name):
    proc = make_process(name, n=1000, seed=3)
    fn = proc.sample_fn()
    state, key = proc.init_state(cuda_device), proc.key.to(cuda_device)
    host = proc.host_sampler()
    for t in range(64):
        mask, state = fn(key, torch.tensor(t, device=cuda_device), state)
        np.testing.assert_array_equal(mask.cpu().numpy(), host.sample(t))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCEN_CASES))
def test_cuda_scenario_scan_bitexact_vs_loop(cuda_device, case):
    """On the card the scan replays the captured scenario round: bit-equal
    to the card's loop, with the CPU's masks."""
    make, scen, kw = SCEN_CASES[case]
    loop, scan = (run_fl(algo=make(cuda_device), engine=engine,
                         scenario=make_scenario(scen, n=N, seed=2, **kw),
                         **_kw(device=cuda_device))
                  for engine in ("loop", "scan_strict"))
    _assert_same(loop, scan)
    cpu = run_fl(algo=make("cpu"), scenario=make_scenario(
        scen, n=N, seed=2, **kw), **_kw())
    assert cpu[1].n_active == loop[1].n_active


# the simulator on the card: the compiled engine (two captured graphs a
# round) against the heap engine, and the host banks' pinned memory

def _sim_policy(name):
    from repro_torch import sim
    return {"wait_for_all": sim.WaitForAll(), "wait_for_s": sim.WaitForS(s=3),
            "deadline": sim.Deadline(deadline_s=2.0),
            "impatient": sim.Impatient(),
            "buffered": sim.BufferedKofN(k=3)}[name]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wait_for_all", "wait_for_s", "deadline",
                                  "impatient", "buffered"])
def test_cuda_sim_compiled_bitexact_vs_heap(cuda_device, name):
    """On the card each compiled round replays the fill graph as often as
    the clock asks and the round graph once: close times, masks and
    losses bit-equal to the card's heap engine; `mifa_aggregate` once a
    round on the heap, plus once for the warm-up on the compiled."""
    from repro_torch.core import FedBuffAvg
    from repro_torch.sim import SimConfig, SimSpec, tiered_shifted_exponential
    policy = _sim_policy(name)
    algo = FedBuffAvg if name == "buffered" else MIFA
    sim = SimSpec(policy, tiered_shifted_exponential(N, seed=3,
                                                     device=cuda_device),
                  SimConfig(epoch_s=2.0, server_overhead_s=0.05,
                            max_lookahead_epochs=16))
    runs, counts = {}, {}
    for engine in ("loop", "scan_strict"):
        before = _counts()
        runs[engine] = run_fl(algo=algo(), engine=engine, sim=sim,
                              scenario=make_scenario("gilbert_elliott", n=N,
                                                     seed=2, burst=4.0),
                              **_kw(device=cuda_device))
        counts[engine] = {k: v - before[k] for k, v in _counts().items()}
    (pl, hl), (ps, hs) = runs["loop"], runs["scan_strict"]
    assert hl.sim_seconds == hs.sim_seconds and hl.n_active == hs.n_active
    assert hl.train_loss == hs.train_loss
    for a, b in zip(tree_leaves(pl), tree_leaves(ps)):
        assert torch.equal(a, b)
    if algo is MIFA:
        assert counts["loop"]["mifa_aggregate"] == T
        assert counts["scan_strict"]["mifa_aggregate"] == T + 1


@pytest.mark.cuda
def test_cuda_host_bank_and_spill_store_pinned(cuda_device):
    from repro_torch.bank import HostBank
    bank = HostBank(device=cuda_device)
    st = bank.init({"w": torch.zeros(3, device=cuda_device)}, 8)
    assert all(t.is_pinned() for t in tree_leaves(st))
    st = bank.scatter(st, np.array([1, 5]),
                      {"w": torch.ones(2, 3, device=cuda_device)})
    got = bank.gather(st, np.array([5, 0]))["w"]
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy()[:, 0], [1, 0])
    assert bank.mean_g(st)["w"].device.type == "cuda"
    paged = PagedDeviceBank(page_size=2, n_slots=2, device=cuda_device)
    pst = paged.init({"w": torch.zeros(3, device=cuda_device)}, 12)
    for ids in ([0, 2], [4, 6], [8, 10], [0, 9]):
        pst = paged.scatter(pst, np.array(ids), {
            "w": torch.ones(len(ids), 3, device=cuda_device)})
    assert paged.evictions > 0 and paged.refaults > 0
    assert all(b.is_pinned() for blocks in paged._spill.values()
               for b in blocks)


# trace replay and checkpoints on the card: the window re-pointed in place
# between chunks, and a killed int8 run resumed bit for bit

def _card_trace(tmp_path):
    from repro_torch.scenarios import synthesize_trace
    return synthesize_trace(str(tmp_path / "trace"), n=N, horizon=40,
                            seed=5, rate=0.6, burst=3.0, churn_frac=0.25)


@pytest.mark.cuda
def test_cuda_trace_replay_scan_bitexact_vs_loop(cuda_device, tmp_path):
    """Trace replay with a window of 4 under chunks of 3: the scan replays
    re-page the carried window between chunks, bit-equal to the card's
    loop, with the CPU's masks; `mifa_aggregate` once a round on the loop,
    plus once for the warm-up on the scan."""
    from repro_torch.scenarios import TraceReplay
    path = _card_trace(tmp_path)
    runs, counts = {}, {}
    for engine in ("loop", "scan_strict"):
        before = _counts()
        runs[engine] = run_fl(algo=MIFA(), engine=engine, scan_chunk=3,
                              scenario=TraceReplay(path, window=4),
                              **_kw(device=cuda_device))
        counts[engine] = {k: v - before[k] for k, v in _counts().items()}
    _assert_same(runs["loop"], runs["scan_strict"])
    assert counts["loop"]["mifa_aggregate"] == T
    assert counts["scan_strict"]["mifa_aggregate"] == T + 1
    cpu = run_fl(algo=MIFA(), scenario=TraceReplay(path, window=4), **_kw())
    assert cpu[1].n_active == runs["loop"][1].n_active


@pytest.mark.cuda
def test_cuda_trace_window_copied_in_place(cuda_device, tmp_path):
    """Each re-page writes into the carried window's tensors: the carry's
    pointers stay those the round was captured with, and the window holds
    the file's rows for the chunk."""
    from repro_torch.core.scan_engine import ScanDriver
    from repro_torch.core.runner import RoundRunner
    from repro_torch.scenarios import TraceReplay, open_trace
    path = _card_trace(tmp_path)
    kw = _kw(device=cuda_device)
    kw.pop("n_rounds")
    runner = RoundRunner(algo=MIFA(), scenario=TraceReplay(path, window=4),
                         **kw)
    drv = ScanDriver(runner, scan_chunk=4)
    win = runner.scen_state["win"]
    ptrs = (win.data_ptr(), runner.scen_state["win_t0"].data_ptr())
    drv.run(T)
    torch.cuda.synchronize()
    assert (runner.scen_state["win"].data_ptr(),
            runner.scen_state["win_t0"].data_ptr()) == ptrs
    assert int(runner.scen_state["win_t0"]) == 8
    np.testing.assert_array_equal(runner.scen_state["win"].cpu().numpy(),
                                  open_trace(path).read_block(8, 4))
    assert drv.replays == T and len(drv.chunks.graphs) == 1


@pytest.mark.cuda
def test_cuda_int8_kill_resume_bitexact(cuda_device, tmp_path):
    """MIFA(int8) draws its rounding from the device generator, which the
    captured round advances on every replay: a run killed after round 9
    and resumed from its round-8 snapshot equals the uninterrupted run."""
    from repro_torch.checkpoint import CheckpointSpec
    from repro_torch.scenarios import TraceReplay
    path = _card_trace(tmp_path)

    def run(d, n_rounds=14, resume=False):
        return run_fl(algo=MIFA(memory="int8"), engine="scan_strict",
                      scan_chunk=5, scenario=TraceReplay(path, window=T),
                      checkpoint=CheckpointSpec(every=4, dir=str(d),
                                                resume=resume),
                      **_kw(device=cuda_device, n_rounds=n_rounds))

    full = run(tmp_path / "full")
    run(tmp_path / "killed", n_rounds=9)
    _assert_same(full, run(tmp_path / "killed", resume=True))
