"""The port's trace replay, elastic fleets and whole-run checkpoint/resume
against the JAX package's, on the CPU, sized like
`tests/test_trace_replay.py` (N = 8 clients, T = 12 rounds, one trace
shared by the module).

* The v1 trace file: the port's writers produce the reference's bytes
  (array and iterator forms), both packages read each other's files and
  the committed fixture array-equal, and malformed input or a format
  mismatch raises. `synthesize_trace` is byte-equal to the reference's for
  two recipes.
* `TraceReplay` and `ElasticProcess`: the host and the device surface
  across window re-pages, array-equal to the reference's host surface;
  the theory (`stationary_rate`, `tau_bound`) equal to the reference's.
* `run_fl(scenario=trace)` on the loop against the reference's loop, at
  `tests/test_torch_run_fl.py`'s bounds (masks and τ equal, losses and
  params within rtol 1e-4, atol 1e-6); within the port the scan is
  bit-equal to the loop for chunks of 1, 7 and T, reads of the file are
  never longer than the window, and a chunk wider than the window raises.
  Under the simulator a trace takes the heap engine (the compiled one
  refuses a window): close times and masks equal the reference's.
* Kill and resume: a run killed after round 9 and resumed from its round-8
  snapshot equals the uninterrupted 14-round run bit for bit (params,
  history, τ) for MIFA(array), MIFA(int8), BankedMIFA(DenseBank) and
  BankedMIFA(PagedDeviceBank) with pages spilled at the snapshot; and the
  resume rules (empty directory, past the horizon, `keep`, the loop
  engine, no silent fallback, a client-count mismatch, the reference's
  snapshot tag refused).
* A K = 3 windowed fleet: scan bit-equal to loop, and each lane bit-equal
  to its sequential run (`tests/test_torch_fleet.py`: within the port a
  fleet runs the sequential runner's arithmetic).

The card's cases (the trace scan, int8 resume, the window written in
place) are in `tests/test_torch_scan_engine.py`.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import MIFA as JMIFA
from repro.core import run_fl as jax_run_fl
from repro.data import ClientBatcher as JClientBatcher
from repro.models import build_model as jax_build
from repro.scenarios import ElasticProcess as JElasticProcess
from repro.scenarios import GilbertElliott as JGilbertElliott
from repro.scenarios import TraceReplay as JTraceReplay
from repro.scenarios import make_scenario as jmake_scenario
from repro.scenarios import open_trace as jopen_trace
from repro.scenarios import staged_arrivals as jstaged_arrivals
from repro.scenarios import synthesize_trace as jsynthesize_trace
from repro.scenarios import write_trace as jwrite_trace
from repro_torch.bank import (BankedMIFA, DenseBank, HostBank,
                              PagedDeviceBank)
from repro_torch.checkpoint import (CheckpointSpec, checkpoint_path,
                                    latest_checkpoint, list_checkpoints)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import MIFA, run_fl
from repro_torch.data import (ClientBatcher, label_skew_partition,
                              make_classification)
from repro_torch.fleet import Trial, run_fleet
from repro_torch.models import build_model
from repro_torch.scenarios import (ElasticProcess, GilbertElliott, Scenario,
                                   TraceReplay, elastic_capacity,
                                   make_scenario, open_trace,
                                   staged_arrivals, synthesize_trace,
                                   write_trace)
from repro_torch.scenarios.elastic import NEVER
from repro_torch.scenarios.trace_replay import TraceFile
from repro_torch.tree import tree_index, tree_leaves

torch.set_num_threads(1)

N, T = 8, 12
FIXTURE = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                       "fixtures", "device_trace_n20_t64.npy")
RECIPES = [dict(n=N, horizon=40, seed=5, rate=0.6, burst=3.0,
                churn_frac=0.25),
           dict(n=100, horizon=64, seed=7, rate=0.5, burst=6.0,
                churn_frac=0.1, block=16)]


@pytest.fixture(scope="module")
def trace_path(tmp_path_factory):
    """A small synthesized trace with churn shared by the module's tests."""
    p = str(tmp_path_factory.mktemp("traces") / "dev.npy")
    return synthesize_trace(p, **RECIPES[0])


def _problem(n_clients=N, model_name="paper_logistic"):
    cfg = get_config(model_name).replace(fl_clients=n_clients)
    X, y = make_classification(10, cfg.d_model, 40, noise=1.0, seed=0)
    idx, _ = label_skew_partition(y, n_clients, seed=0)
    return cfg, X, y, idx


def _kw(n_clients=N, **over):
    cfg, X, y, idx = _problem(n_clients)
    kw = dict(model=build_model(cfg),
              batcher=ClientBatcher(X, y, idx, batch_size=8, k_steps=2,
                                    seed=0),
              schedule=lambda t: 0.1 / (1 + t), n_rounds=T,
              weight_decay=1e-3, seed=0, cohort_capacity=N, device="cpu")
    kw.update(over)
    return kw


def _trace_scen(path, window=T):
    return Scenario(TraceReplay(path, window=window), name="trace")


def _assert_same(run_a, run_b):
    (pa, ha), (pb, hb) = run_a, run_b
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(a, b)
    assert ha.train_loss == hb.train_loss
    assert ha.n_active == hb.n_active and ha.rounds == hb.rounds
    assert ha.eval_loss == hb.eval_loss
    assert (ha.tau_bar, ha.tau_max) == (hb.tau_bar, hb.tau_max)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# --------------------------------------------------------------------------- #
# the trace file
# --------------------------------------------------------------------------- #

def test_write_read_roundtrip_array(tmp_path):
    masks = np.random.default_rng(0).random((17, 11)) < 0.5
    p = write_trace(str(tmp_path / "t"), masks)          # .npy appended
    assert p.endswith(".npy") and os.path.exists(p[:-4] + ".json")
    ref = jwrite_trace(str(tmp_path / "ref"), masks)
    assert _bytes(p) == _bytes(ref)
    assert _bytes(p[:-4] + ".json") == _bytes(ref[:-4] + ".json")
    tf = open_trace(p)
    assert (tf.n_rounds, tf.n_clients) == (17, 11)
    np.testing.assert_array_equal(tf.read_block(0, 17), masks)
    np.testing.assert_array_equal(jopen_trace(p).read_block(0, 17), masks)
    # a partial block and the clamp past the end: the last row repeats
    np.testing.assert_array_equal(tf.read_block(15, 5),
                                  masks[[15, 16, 16, 16, 16]])


def test_write_read_roundtrip_iterator(tmp_path):
    masks = np.random.default_rng(1).random((10, 9)) < 0.4

    def blocks():
        return iter([masks[:4], masks[4:7], masks[7:]])

    p = write_trace(str(tmp_path / "t.npy"), blocks(), n_clients=9,
                    n_rounds=10)
    ref = jwrite_trace(str(tmp_path / "r.npy"), blocks(), n_clients=9,
                       n_rounds=10)
    assert _bytes(p) == _bytes(ref)
    np.testing.assert_array_equal(open_trace(ref).read_block(0, 10), masks)


def test_write_trace_rejects_malformed(tmp_path):
    with pytest.raises(ValueError, match="n_clients"):
        write_trace(str(tmp_path / "a"), iter([np.ones((2, 3), bool)]))
    with pytest.raises(ValueError, match="sum to"):
        write_trace(str(tmp_path / "b"), iter([np.ones((2, 3), bool)]),
                    n_clients=3, n_rounds=5)
    with pytest.raises(ValueError, match="block must be"):
        write_trace(str(tmp_path / "c"), iter([np.ones((2, 4), bool)]),
                    n_clients=3, n_rounds=2)
    with pytest.raises(ValueError, match=r"\(T, N\)"):
        write_trace(str(tmp_path / "d"), np.ones(3, bool))
    # a failed write leaves no torn payload behind
    assert not any(f.endswith(".npy") for f in os.listdir(tmp_path))


def test_open_trace_rejects_format_mismatch(tmp_path):
    p = write_trace(str(tmp_path / "t"), np.ones((3, 4), bool))
    with open(p[:-4] + ".json", "w") as f:
        f.write('{"format": "not-a-trace", "n_clients": 4, "n_rounds": 3}')
    with pytest.raises(ValueError, match="expected format"):
        open_trace(p)
    with open(p[:-4] + ".json", "w") as f:
        f.write('{"format": "repro-trace-v1", "n_clients": 20, '
                '"n_rounds": 3}')
    with pytest.raises(ValueError, match="does not match sidecar"):
        open_trace(p)


def test_committed_fixture_read_by_both():
    tf, jf = open_trace(FIXTURE), jopen_trace(FIXTURE)
    assert (tf.n_clients, tf.n_rounds) == (jf.n_clients, jf.n_rounds) \
        == (20, 64)
    block = tf.read_block(0, 64)
    np.testing.assert_array_equal(block, jf.read_block(0, 64))
    assert (~block[-1]).any()          # churned devices dark at the end
    got, ref = TraceReplay(FIXTURE), JTraceReplay(FIXTURE)
    np.testing.assert_array_equal(got.stationary_rate(),
                                  ref.stationary_rate())
    a, b = got.tau_bound(), ref.tau_bound()
    assert (a.deterministic, a.t0, a.expected_tau, a.note) == \
        (b.deterministic, b.t0, b.expected_tau, b.note)
    assert not a.deterministic                  # the arbitrary regime


@pytest.mark.parametrize("recipe", range(len(RECIPES)))
def test_synthesize_trace_byte_equal_to_reference(tmp_path, recipe):
    kw = RECIPES[recipe]
    p = synthesize_trace(str(tmp_path / "port"), **kw)
    ref = jsynthesize_trace(str(tmp_path / "ref"), **kw)
    assert _bytes(p) == _bytes(ref)
    assert _bytes(p[:-4] + ".json") == _bytes(ref[:-4] + ".json")


# --------------------------------------------------------------------------- #
# TraceReplay and ElasticProcess: both surfaces against the reference
# --------------------------------------------------------------------------- #

def test_trace_replay_surfaces_across_repages(trace_path):
    """A window of 4 re-pages every 4 rounds; the device surface (CPU
    tensors), the host surface and the reference's host surface agree
    through the re-pages and past the end of the trace."""
    proc = TraceReplay(trace_path, window=4)
    fn, state = proc.sample_fn(), proc.init_state("cpu")
    host, ref = proc.host_sampler(), JTraceReplay(trace_path,
                                                  window=4).host_sampler()
    raw = open_trace(trace_path)
    for t in range(55):                         # horizon 40: the clamp
        if t % 4 == 0:
            assert proc.load_window(state, t) is state   # in place
        mask, state = fn(proc.key, torch.tensor(t), state)
        want = ref.sample(t)
        np.testing.assert_array_equal(mask.numpy(), want, err_msg=f"t={t}")
        np.testing.assert_array_equal(host.sample(t), want)
        if t > 0:
            np.testing.assert_array_equal(want, raw.read_block(t, 1)[0])
    assert int(state["win_t0"]) == 52


def test_trace_replay_rejects_resize(trace_path):
    with pytest.raises(ValueError, match="cannot resize"):
        TraceReplay(trace_path, n=N + 1)
    with pytest.raises(ValueError, match="window"):
        TraceReplay(trace_path, window=0)


def test_registry_synthesizes_and_caches(tmp_path):
    scen = make_scenario("trace_replay", n=6, seed=2, horizon=20,
                         cache_dir=str(tmp_path))
    again = make_scenario("trace_replay", n=6, seed=2, horizon=20,
                          cache_dir=str(tmp_path))
    assert scen.process.trace.path == again.process.trace.path
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npy")]) == 1
    ref = jmake_scenario("trace_replay", n=6, seed=2, horizon=20,
                         cache_dir=str(tmp_path))
    assert ref.process.trace.path == scen.process.trace.path
    assert ref.name == scen.name


def _elastic_pair(inner, jinner):
    join = staged_arrivals(N, n_initial=3, arrive_every=5)
    np.testing.assert_array_equal(
        join, jstaged_arrivals(N, n_initial=3, arrive_every=5))
    leave = np.full(N, NEVER, np.int64)
    leave[0] = 12
    return (ElasticProcess(inner, join=join, leave=leave),
            JElasticProcess(jinner, join=join, leave=leave))


@pytest.mark.parametrize("inner", ["gilbert_elliott", "trace"])
def test_elastic_mask_is_inner_and_presence(trace_path, inner):
    """Both surfaces against the reference's host surface, and against
    inner AND presence, over a Markov chain and over trace replay (the
    window protocol forwarded)."""
    if inner == "trace":
        proc, ref = _elastic_pair(TraceReplay(trace_path, window=5),
                                  JTraceReplay(trace_path, window=5))
    else:
        proc, ref = _elastic_pair(
            GilbertElliott.from_rate_and_burst(0.5, 3.0, n=N, seed=4),
            JGilbertElliott.from_rate_and_burst(0.5, 3.0, n=N, seed=4))
    assert not proc.round0_all_active and proc.inner.round0_all_active
    assert proc.scan_window == (5 if inner == "trace" else None)
    fn, state = proc.sample_fn(), proc.init_state("cpu")
    host, jhost = proc.host_sampler(), ref.host_sampler()
    inner_host = proc.inner.host_sampler()
    for t in range(25):
        if inner == "trace" and t % 5 == 0:
            proc.load_window(state, t)
        mask, state = fn(proc.key, torch.tensor(t), state)
        want = jhost.sample(t)
        present = (proc.join <= t) & (t < proc.leave)
        np.testing.assert_array_equal(mask.numpy(), want, err_msg=f"t={t}")
        np.testing.assert_array_equal(host.sample(t), want)
        np.testing.assert_array_equal(want, inner_host.sample(t) & present)
    np.testing.assert_array_equal(proc.stationary_rate(),
                                  ref.stationary_rate())


def test_elastic_capacity_and_arrivals():
    assert elastic_capacity(5) == 8 and elastic_capacity(8) == 8
    join = staged_arrivals(10, n_initial=4, arrive_every=6, arrive_count=2)
    np.testing.assert_array_equal(
        join, jstaged_arrivals(10, n_initial=4, arrive_every=6,
                               arrive_count=2))
    assert join.tolist()[4:] == [6, 6, 12, 12, 18, 18]
    with pytest.raises(ValueError, match="n_initial"):
        staged_arrivals(4, n_initial=0)
    with pytest.raises(ValueError, match="join/leave"):
        ElasticProcess(GilbertElliott(0.1, 0.5, n=4), join=np.zeros(3))


def test_elastic_tau_bound_classification():
    kw = dict(n=4, seed=0, periods=4, offs=1)
    det = make_scenario("adversarial", **kw).process
    jdet = jmake_scenario("adversarial", **kw).process
    for join, leave in ((np.array([0, 0, 3, 7]), None),
                        (None, np.array([NEVER, NEVER, NEVER, 9]))):
        got = ElasticProcess(det, join=join, leave=leave)
        ref = JElasticProcess(jdet, join=join, leave=leave)
        a, b = got.tau_bound(), ref.tau_bound()
        assert (a.deterministic, a.t0, a.note) == \
            (b.deterministic, b.t0, b.note)
        np.testing.assert_array_equal(got.stationary_rate(),
                                      ref.stationary_rate())
    grow = ElasticProcess(det, join=np.array([0, 0, 3, 7]))
    assert grow.tau_bound().t0 == det.tau_bound().t0 + 7
    gone = ElasticProcess(det, leave=np.array([NEVER, NEVER, NEVER, 9]))
    assert not gone.tau_bound().deterministic
    assert gone.stationary_rate()[3] == 0.0


# --------------------------------------------------------------------------- #
# runs: the loop against the reference, scan against the loop
# --------------------------------------------------------------------------- #

def test_run_fl_trace_loop_matches_reference(trace_path):
    cfg, X, y, idx = _problem(model_name="paper_mlp")
    jmodel = jax_build(jax_config("paper_mlp").replace(fl_clients=N))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    kw = dict(schedule=lambda t: 0.1 / (1 + t), n_rounds=T,
              weight_decay=1e-3, seed=0)
    pj, hj = jax_run_fl(model=jmodel, algo=JMIFA(memory="array"),
                        scenario=JTraceReplay(trace_path, window=5),
                        batcher=JClientBatcher(X, y, idx, batch_size=8,
                                               k_steps=2, seed=0),
                        params=jparams, **kw)
    pt, ht = run_fl(model=build_model(cfg), algo=MIFA(memory="array"),
                    scenario=TraceReplay(trace_path, window=5),
                    batcher=ClientBatcher(X, y, idx, batch_size=8,
                                          k_steps=2, seed=0),
                    params=params_from_jax(jax.tree.map(np.asarray,
                                                        jparams), "cpu"),
                    device="cpu", **kw)
    assert ht.n_active == hj.n_active and ht.rounds == hj.rounds
    assert (ht.tau_bar, ht.tau_max) == (hj.tau_bar, hj.tau_max)
    np.testing.assert_allclose(ht.train_loss, hj.train_loss, rtol=1e-4,
                               atol=1e-6)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("chunk", [1, 7, T])
def test_scan_chunk_bitexact_vs_loop(trace_path, chunk):
    kw = _kw()
    loop = run_fl(algo=MIFA(memory="array"), engine="loop",
                  scenario=_trace_scen(trace_path), **kw)
    scan = run_fl(algo=MIFA(memory="array"), engine="scan_strict",
                  scan_chunk=chunk, scenario=_trace_scen(trace_path), **kw)
    _assert_same(loop, scan)


def test_scan_window_too_small_and_reads_bounded(trace_path, monkeypatch):
    with pytest.raises(ValueError, match="window"):
        run_fl(algo=MIFA(memory="array"), engine="scan_strict",
               scan_chunk=8, scenario=_trace_scen(trace_path, window=4),
               **_kw())
    lengths = []
    orig = TraceFile.read_block

    def recording(self, t0, length):
        lengths.append(length)
        return orig(self, t0, length)

    monkeypatch.setattr(TraceFile, "read_block", recording)
    loop = run_fl(algo=MIFA(memory="array"), engine="loop",
                  scenario=_trace_scen(trace_path, window=4), **_kw())
    n_loop = len(lengths)
    scan = run_fl(algo=MIFA(memory="array"), engine="scan_strict",
                  scan_chunk=3, scenario=_trace_scen(trace_path, window=4),
                  **_kw())
    _assert_same(loop, scan)
    assert lengths and max(lengths) <= 4
    assert n_loop >= T // 4 and len(lengths) - n_loop >= T // 4


def test_sim_under_trace_takes_the_heap_engine(trace_path):
    """The compiled simulator refuses a windowed scenario, so
    `engine="scan"` warns and runs the heap engine on the trace's host
    surface: close times and masks equal the reference's heap run, losses
    within `tests/test_torch_run_fl.py`'s bounds."""
    import warnings

    from repro.sim import SimConfig as JSimConfig
    from repro.sim import SimSpec as JSimSpec
    from repro.sim import TraceLatency as JTraceLatency
    from repro.sim import WaitForS as JWaitForS
    from repro_torch.sim import SimConfig, SimSpec, TraceLatency, WaitForS
    rtt = np.random.default_rng(4).exponential(2.0, (16, N))
    cfg = dict(epoch_s=2.0, server_overhead_s=0.05, max_lookahead_epochs=40)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, h = run_fl(algo=MIFA(), scenario=_trace_scen(trace_path, 5),
                      sim=SimSpec(WaitForS(s=4), TraceLatency(
                          rtt, device="cpu"), SimConfig(**cfg)),
                      engine="scan", **_kw())
    assert any("windowed" in str(w.message) for w in caught)
    _, X, y, idx = _problem()
    _, jh = jax_run_fl(
        model=jax_build(jax_config("paper_logistic").replace(fl_clients=N)),
        algo=JMIFA(), scenario=JTraceReplay(trace_path, window=5),
        sim=JSimSpec(JWaitForS(s=4), JTraceLatency(rtt), JSimConfig(**cfg)),
        batcher=JClientBatcher(X, y, idx, batch_size=8, k_steps=2, seed=0),
        schedule=lambda t: 0.1 / (1 + t), n_rounds=T, weight_decay=1e-3,
        seed=0)
    assert h.sim_seconds == jh.sim_seconds and h.n_active == jh.n_active
    np.testing.assert_allclose(h.train_loss, jh.train_loss, rtol=1e-4,
                               atol=1e-6)


# --------------------------------------------------------------------------- #
# kill and resume
# --------------------------------------------------------------------------- #

def _elastic_trace(path):
    """Elastic over the trace for the paged bank: round 0 activates only
    the 3 present clients, so 6 one-row pages hold every chunk's cohorts
    while 7 clients have come by the round-8 snapshot (pages spill)."""
    leave = np.full(N, NEVER, np.int64)
    leave[0] = 5
    return Scenario(ElasticProcess(
        TraceReplay(path, window=T),
        join=staged_arrivals(N, n_initial=3, arrive_every=2), leave=leave),
        name="elastic-trace")


CKPT = {
    "mifa_array": (lambda: MIFA(memory="array"), _trace_scen),
    "mifa_int8": (lambda: MIFA(memory="int8"), _trace_scen),
    "banked_dense": (lambda: BankedMIFA(DenseBank(device="cpu")),
                     _trace_scen),
    "banked_paged": (lambda: BankedMIFA(PagedDeviceBank(
        page_size=1, n_slots=6, device="cpu")), _elastic_trace),
}


def _ckpt_run(name, path, ckdir, n_rounds=14, resume=False, **over):
    make, scen = CKPT[name]
    algo = make()
    out = run_fl(algo=algo, engine="scan_strict", scan_chunk=5,
                 scenario=scen(path),
                 checkpoint=CheckpointSpec(every=4, dir=ckdir,
                                           resume=resume),
                 **_kw(n_rounds=n_rounds, **over))
    return out, algo


@pytest.mark.parametrize("name", list(CKPT))
def test_kill_resume_bitexact(trace_path, tmp_path, name):
    """Kill after round 9, resume from the round-8 snapshot, finish at 14:
    bit-equal to the uninterrupted run (params, history, evals, τ)."""
    ev = {"eval_fn": lambda p: (float(tree_leaves(p)[0].sum()), 0.0),
          "eval_every": 3}
    full, algo = _ckpt_run(name, trace_path, str(tmp_path / "full"), **ev)
    killed = str(tmp_path / "killed")
    _ckpt_run(name, trace_path, killed, n_rounds=9, **ev)
    assert [r for r, _ in list_checkpoints(killed)] == [4, 8]
    resumed, algo2 = _ckpt_run(name, trace_path, killed, resume=True, **ev)
    _assert_same(full, resumed)
    if name == "banked_paged":
        from repro_torch.checkpoint import load_pytree
        snap = load_pytree(checkpoint_path(killed, 8), as_torch=False)
        assert len(snap["bank"]["spill_lp"]) > 0
        assert algo.bank.evictions > 0 and algo.bank.refaults > 0
        assert (algo2.bank.faults, algo2.bank.evictions) == \
            (algo.bank.faults, algo.bank.evictions)
        np.testing.assert_array_equal(algo2.bank._pt, algo.bank._pt)


def test_resume_from_empty_dir_is_fresh_run(trace_path, tmp_path):
    a = run_fl(algo=MIFA(memory="array"), engine="scan_strict", scan_chunk=5,
               scenario=_trace_scen(trace_path), **_kw())
    b = run_fl(algo=MIFA(memory="array"), engine="scan_strict", scan_chunk=5,
               scenario=_trace_scen(trace_path),
               checkpoint=CheckpointSpec(every=4, dir=str(tmp_path / "none"),
                                         resume=True), **_kw())
    _assert_same(a, b)


def test_resume_past_horizon_and_keep(trace_path, tmp_path):
    """A snapshot at or past n_rounds restores and runs nothing; `keep`
    prunes to the newest snapshots."""
    d = str(tmp_path / "ck")
    done = run_fl(algo=MIFA(memory="array"), engine="scan_strict",
                  scan_chunk=5, scenario=_trace_scen(trace_path),
                  checkpoint=CheckpointSpec(every=4, dir=d, keep=1), **_kw())
    assert [r for r, _ in list_checkpoints(d)] == [12]
    assert latest_checkpoint(d) == checkpoint_path(d, 12)
    again = run_fl(algo=MIFA(memory="array"), engine="scan_strict",
                   scan_chunk=5, scenario=_trace_scen(trace_path),
                   checkpoint=CheckpointSpec(every=4, dir=d, resume=True),
                   **_kw(n_rounds=8))
    _assert_same(done, again)


def test_checkpoint_rules(trace_path, tmp_path):
    """The loop engine and simulated runs raise; a configuration that
    cannot scan raises instead of falling back without durability; a
    client-count mismatch and the reference's snapshot tag are refused."""
    from repro_torch.checkpoint import save_pytree
    spec = CheckpointSpec(every=4, dir=str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="scan engine"):
        run_fl(algo=MIFA(memory="array"), engine="loop",
               scenario=_trace_scen(trace_path), checkpoint=spec, **_kw())
    with pytest.raises(ValueError, match="simulated"):
        run_fl(algo=MIFA(memory="array"), engine="scan",
               scenario=_trace_scen(trace_path), checkpoint=spec,
               sim=object(), **_kw())
    with pytest.raises(ValueError, match="drop durability"):
        run_fl(algo=BankedMIFA(HostBank(device="cpu")), engine="scan",
               scenario=_trace_scen(trace_path), checkpoint=spec, **_kw())
    run_fl(algo=MIFA(memory="array"), engine="scan_strict", scan_chunk=5,
           scenario=_trace_scen(trace_path), checkpoint=spec, **_kw())
    with pytest.raises(ValueError, match="refusing to resume"):
        run_fl(algo=MIFA(memory="array"), engine="scan_strict",
               scenario=GilbertElliott.from_rate_and_burst(0.5, 3.0, n=6),
               checkpoint=CheckpointSpec(every=4, dir=spec.dir, resume=True),
               **_kw(n_clients=6))
    ref_dir = str(tmp_path / "ref")
    save_pytree(checkpoint_path(ref_dir, 4),
                {"format": "repro-run-v1", "round": np.int64(4),
                 "n_clients": np.int64(N)})
    with pytest.raises(ValueError, match="repro-run-v1.*repro-torch-run-v1"):
        run_fl(algo=MIFA(memory="array"), engine="scan_strict",
               scenario=_trace_scen(trace_path),
               checkpoint=CheckpointSpec(every=4, dir=ref_dir, resume=True),
               **_kw())
    with pytest.raises(ValueError, match="every"):
        CheckpointSpec(every=0, dir="x")


def test_elastic_over_trace_scan_vs_loop(trace_path):
    kw = _kw()
    loop = run_fl(algo=MIFA(memory="array"), engine="loop",
                  scenario=_elastic_trace(trace_path), **kw)
    scan = run_fl(algo=MIFA(memory="array"), engine="scan_strict",
                  scan_chunk=4, scenario=_elastic_trace(trace_path), **kw)
    _assert_same(loop, scan)


# --------------------------------------------------------------------------- #
# a windowed fleet
# --------------------------------------------------------------------------- #

def test_windowed_fleet_scan_vs_loop_and_lanes(trace_path):
    """K = 3 lanes of elastic trace replay (different schedules, a window
    of 4): the scan equals the loop, and each lane its sequential run."""
    def scen(k):
        return ElasticProcess(TraceReplay(trace_path, window=4),
                              join=staged_arrivals(N, n_initial=3 + k,
                                                   arrive_every=2 + k))

    kw = _kw()
    kw.pop("seed")
    trials = [Trial(seed=s, scenario=scen(k)) for k, s in enumerate((0, 1,
                                                                       2))]
    fleets = [run_fleet(algo=MIFA(memory="array"), trials=trials,
                        engine=engine, scan_chunk=3, **kw)
              for engine in ("loop", "scan_strict")]
    (pl, hl), (ps, hs) = fleets
    assert np.array_equal(hl.stacked()["train_loss"],
                          hs.stacked()["train_loss"])
    for a, b in zip(tree_leaves(pl), tree_leaves(ps)):
        assert torch.equal(a, b)
    for k, tr in enumerate(trials):
        seq = run_fl(algo=MIFA(memory="array"), scenario=scen(k),
                     seed=tr.seed, **kw)
        assert hl.trial(k).n_active == seq[1].n_active
        assert hl.trial(k).train_loss == seq[1].train_loss
        for a, b in zip(tree_leaves(tree_index(pl, k)), tree_leaves(seq[0])):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="window length"):
        run_fleet(algo=MIFA(memory="array"), trials=[
            Trial(seed=0, scenario=TraceReplay(trace_path, window=4)),
            Trial(seed=1, scenario=TraceReplay(trace_path, window=5))],
            **kw)
