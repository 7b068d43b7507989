"""The port's fleet against the JAX package's, on the CPU.

  (a) the plain versions of the batched bank kernels against the reference's
      Pallas `bank_scatter_batched` / `paged_bank_scatter_batched`
      (interpret mode), and per trial against the single-trial plain
      versions;
  (b) `run_fleet` against the reference's `run_fleet` (the reference's
      stacked initial params passed in) for MIFA(array), BiasedFedAvg,
      FedAvgIS, FedAvgSampling (update clock, the reference's selections
      injected), BankedMIFA(DenseBank) and BankedMIFA(PagedDeviceBank);
  (c) within the port: each fleet trial equals `run_fl` of the same seed,
      the paged fleet equals the dense fleet, and a round's writes, in
      place or not, land in the stacked state;
  (d) a paged fleet bank through evictions against the reference's;
  (e) `expand_grid` (participation and scenario trials) and the surfaces
      that are not ported yet.

Tolerances: copied values (bank rows, pages, masks, counters, page tables)
must be equal; delta sums are summed in another order by the two
frameworks and agree within atol 1e-6; trajectories are f32 on both sides
with matmuls and reductions blocked differently and agree within atol 1e-5
after 6 rounds. Within the port the fleet runs the same arithmetic as the
sequential runner, so there results are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_baselines import inject_reference_selections
from test_torch_run_fl import _problem

from repro.bank import BankedMIFA as JBankedMIFA
from repro.bank import DenseBank as JDenseBank
from repro.bank import PagedDeviceBank as JPagedDeviceBank
from repro.configs import get_smoke_config as jax_smoke
from repro.core import MIFA as JMIFA
from repro.core import BernoulliParticipation as JBernoulli
from repro.core import BiasedFedAvg as JBiasedFedAvg
from repro.core import FedAvgIS as JFedAvgIS
from repro.core import FedAvgSampling as JFedAvgSampling
from repro.fleet import Trial as JTrial
from repro.fleet import expand_grid as jexpand_grid
from repro.fleet import run_fleet as jrun_fleet
from repro.models import build_model as jax_build
from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
from repro_torch.convert import params_from_jax
from repro_torch.core import (MIFA, BernoulliParticipation, BiasedFedAvg,
                              FedAvgIS, FedAvgSampling, RoundRunner, run_fl)
from repro_torch.fleet import (FleetRunner, SimTrial, Trial, expand_grid,
                               make_fleet_eval, run_fleet, run_sim_fleet)
from repro_torch.kernels.bank_scatter import (bank_scatter_batched,
                                              bank_scatter_batched_ref,
                                              bank_scatter_ref)
from repro_torch.kernels.paged_bank import (paged_bank_scatter_batched,
                                            paged_bank_scatter_batched_ref,
                                            paged_bank_scatter_ref)
from repro_torch.models import build_model
from repro_torch.optim import inv_t
from repro_torch.scenarios import make_process, make_scenario
from repro_torch.tree import tree_index, tree_leaves, tree_stack

torch.set_num_threads(1)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEEDS = (0, 1, 2)
ROUNDS = 6
CAP = 8          # the pinned cohort width on both sides (N = 8)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _to_torch(tree):
    return params_from_jax(tree, "cpu")


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


# --------------------------------------------------------------------------- #
# (a) the batched kernels' plain versions against the Pallas kernels
# --------------------------------------------------------------------------- #

K_TRIALS, C, M = 3, 8, 256


def _cohorts(rng, rows: int, dummy: int):
    """(K, C) ids and valid: trial k has 5 - 2k valid distinct rows, the
    last trial only pads; pads sit at `dummy`."""
    ids = np.full((K_TRIALS, C), dummy, np.int64)
    valid = np.zeros((K_TRIALS, C), bool)
    for k in range(K_TRIALS):
        n_valid = max(5 - 2 * k - (k == K_TRIALS - 1) * 5, 0)
        ids[k, :n_valid] = rng.permutation(rows)[:n_valid]
        valid[k, :n_valid] = True
    assert not valid[-1].any()
    return ids, valid


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_bank_scatter_batched_matches_pallas_and_single_trial(dt):
    from repro.kernels.bank_scatter import bank_scatter_batched as pallas
    rng = np.random.default_rng(3)
    r = 11
    banks = rng.normal(size=(K_TRIALS, r, M)).astype(np.float32)
    u = rng.normal(size=(K_TRIALS, C, M)).astype(np.float32)
    ids, valid = _cohorts(rng, r - 1, r - 1)
    b_j, d_j = pallas(jnp.asarray(banks, dt), jnp.asarray(u),
                      jnp.asarray(ids, jnp.int32), jnp.asarray(valid),
                      block_m=128, interpret=True)
    banks_t = torch.from_numpy(banks).to(TORCH_DT[dt])
    args = (torch.from_numpy(u), torch.from_numpy(ids),
            torch.from_numpy(valid))
    b_t, d_t = bank_scatter_batched(banks_t.clone(), *args)
    np.testing.assert_array_equal(_f32(b_t), _f32(b_j))
    np.testing.assert_allclose(_f32(d_t), _f32(d_j), rtol=0, atol=1e-6)
    for k in range(K_TRIALS):
        b_k, d_k = bank_scatter_ref(banks_t[k], *(a[k] for a in args))
        assert torch.equal(b_t[k], b_k) and torch.equal(d_t[k], d_k)
    assert torch.equal(b_t[-1], banks_t[-1]) and not d_t[-1].any()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_bank_scatter_batched_matches_pallas_and_single_trial(dt):
    from repro.kernels.bank_scatter import paged_bank_scatter_batched as pallas
    rng = np.random.default_rng(4)
    ps, n_slots, lp = 4, 3, 5
    pages = rng.normal(size=(K_TRIALS, (n_slots + 1) * ps, M)).astype(
        np.float32)
    pages[:, n_slots * ps:] = 0.0
    # per-trial shuffled tables: 3 of 5 logical pages resident
    pt = np.full((K_TRIALS, lp + 1), n_slots, np.int32)
    resident = []
    for k in range(K_TRIALS):
        res = rng.permutation(lp)[:n_slots]
        pt[k, res] = rng.permutation(n_slots)
        resident.append(res)
    u = rng.normal(size=(K_TRIALS, C, M)).astype(np.float32)
    lids, valid = _cohorts(rng, n_slots * ps, lp * ps)
    for k in range(K_TRIALS):       # valid rows of trial k's resident pages
        rows = lids[k, valid[k]]
        lids[k, valid[k]] = resident[k][rows // ps] * ps + rows % ps
    lids = lids.astype(np.int32)
    p_j, d_j = pallas(jnp.asarray(pages, dt), jnp.asarray(u),
                      jnp.asarray(pt), jnp.asarray(lids), jnp.asarray(valid),
                      page_size=ps, block_m=128, interpret=True)
    pages_t = torch.from_numpy(pages).to(TORCH_DT[dt])
    args = [torch.from_numpy(a) for a in (u, pt, lids, valid)]
    p_t, d_t = paged_bank_scatter_batched(pages_t.clone(), *args,
                                          page_size=ps)
    np.testing.assert_array_equal(_f32(p_t), _f32(p_j))
    np.testing.assert_allclose(_f32(d_t), _f32(d_j), rtol=0, atol=1e-6)
    for k in range(K_TRIALS):
        p_k, d_k = paged_bank_scatter_ref(pages_t[k], *(a[k] for a in args),
                                          page_size=ps)
        assert torch.equal(p_t[k], p_k) and torch.equal(d_t[k], d_k)
    assert not p_t[:, n_slots * ps:].any()


def test_batched_wrappers_check_their_inputs():
    banks = torch.zeros(2, 5, 8)
    u, ids = torch.zeros(2, 3, 8), torch.zeros(2, 3, dtype=torch.int64)
    valid = torch.zeros(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"\(K, R, M\)"):
        bank_scatter_batched(banks[0], u, ids, valid)
    with pytest.raises(ValueError, match="shape mismatch"):
        bank_scatter_batched(banks, u, ids[:1], valid)
    pt, pages = torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="power of two"):
        paged_bank_scatter_batched(pages, u, pt, ids.int(), valid,
                                   page_size=3)
    with pytest.raises(TypeError, match="lids must be int32"):
        paged_bank_scatter_batched(pages, u, pt, ids, valid, page_size=2)
    meta = [t.to("meta") for t in (banks, u, ids, valid)]
    with pytest.raises(ValueError, match="no bank_scatter_batched kernel"):
        bank_scatter_batched(*meta)
    assert torch.equal(bank_scatter_batched_ref(banks, u, ids, valid)[1],
                       torch.zeros(2, 8))
    assert paged_bank_scatter_batched_ref(
        pages, u, pt, ids.int(), valid, page_size=2)[1].shape == (2, 8)


# --------------------------------------------------------------------------- #
# (b) run_fleet against the reference's
# --------------------------------------------------------------------------- #

FLEET_ALGOS = {   # name -> (reference factory, port factory, update clock)
    "mifa_array": (lambda p: JMIFA(memory="array"),
                   lambda p: MIFA(memory="array"), False),
    "biased_fedavg": (lambda p: JBiasedFedAvg(), lambda p: BiasedFedAvg(),
                      False),
    "fedavg_is": (lambda p: JFedAvgIS(tuple(p)), lambda p: FedAvgIS(p),
                  False),
    "fedavg_sampling": (lambda p: JFedAvgSampling(s=4),
                        lambda p: FedAvgSampling(s=4), True),
    "banked_dense": (lambda p: JBankedMIFA(JDenseBank()),
                     lambda p: BankedMIFA(DenseBank(device="cpu")), False),
    "banked_paged": (lambda p: JBankedMIFA(JPagedDeviceBank(page_size=2)),
                     lambda p: BankedMIFA(PagedDeviceBank(page_size=2,
                                                          device="cpu")),
                     False),
}


def _port_trials(probs):
    return [Trial(seed=s, participation=BernoulliParticipation(
        probs, seed=100 + s), label=f"seed{s}") for s in SEEDS]


def _kw(batcher, clock):
    return dict(batcher=batcher, schedule=inv_t(1.0), n_rounds=ROUNDS,
                weight_decay=1e-3, uses_update_clock=clock,
                cohort_capacity=CAP)


@pytest.mark.parametrize("model_name,algo", [
    ("paper_logistic", a) for a in FLEET_ALGOS] + [
    ("paper_mlp", "mifa_array"), ("paper_mlp", "banked_paged")])
def test_run_fleet_matches_reference(model_name, algo, monkeypatch):
    make_j, make_t, clock = FLEET_ALGOS[algo]
    cfg, batcher, probs, test = _problem(model_name)
    if clock:
        inject_reference_selections(monkeypatch, SEEDS, ROUNDS, 4,
                                    cfg.fl_clients)
    jmodel = jax_build(jax_smoke(model_name))
    params0 = jax.vmap(jmodel.init)(
        jnp.stack([jax.random.PRNGKey(s) for s in SEEDS]))
    pj, hj = jrun_fleet(
        model=jmodel, algo=make_j(probs),
        trials=[JTrial(seed=s, participation=JBernoulli(probs, seed=100 + s))
                for s in SEEDS], **_kw(batcher, clock))
    model = build_model(cfg)
    pt, ht = run_fleet(model=model, algo=make_t(probs),
                       trials=_port_trials(probs),
                       params=_to_torch(jax.tree.map(np.asarray, params0)),
                       eval_fn=make_fleet_eval(
                           model, {"x": test[0], "y": test[1]},
                           device="cpu"),
                       eval_every=3, device="cpu", **_kw(batcher, clock))
    sj, st = hj.stacked(), ht.stacked()
    np.testing.assert_array_equal(st["n_active"], sj["n_active"])
    assert ("global_updates" in st) == clock == ("global_updates" in sj)
    if clock:
        np.testing.assert_array_equal(st["global_updates"],
                                      sj["global_updates"])
        # the clocks lag the rounds, and differ between trials
        last = st["global_updates"][:, -1]
        assert last.max() > 1 and last.max() < ROUNDS and len(set(last)) > 1
    np.testing.assert_allclose(st["train_loss"], sj["train_loss"], rtol=0,
                               atol=1e-5)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    assert st["eval_rounds"].tolist() == [0, 3, ROUNDS - 1]
    assert np.isfinite(st["eval_loss"]).all() and ht.labels == [
        f"seed{s}" for s in SEEDS]


# --------------------------------------------------------------------------- #
# (c) within the port
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("algo", ["mifa_array", "fedavg_sampling",
                                  "banked_paged"])
def test_fleet_trials_equal_sequential_runs(algo):
    _, make_t, clock = FLEET_ALGOS[algo]
    cfg, batcher, probs, _ = _problem("paper_mlp")
    model = build_model(cfg)
    pf, hf = run_fleet(model=model, algo=make_t(probs),
                       trials=_port_trials(probs), device="cpu",
                       **_kw(batcher, clock))
    for k, s in enumerate(SEEDS):
        ps, hs = run_fl(model=model, algo=make_t(probs), seed=s,
                        participation=BernoulliParticipation(
                            probs, seed=100 + s), device="cpu",
                        **_kw(batcher, clock))
        h = hf.trial(k)
        assert h.train_loss == hs.train_loss and h.n_active == hs.n_active
        assert h.global_updates == hs.global_updates
        for a, b in zip(tree_leaves(pf), tree_leaves(ps)):
            assert torch.equal(a[k], b)


def test_paged_fleet_is_bit_equal_to_dense_fleet():
    cfg, batcher, probs, _ = _problem("paper_mlp")
    model = build_model(cfg)
    out = {}
    for algo in ("banked_dense", "banked_paged"):
        out[algo] = run_fleet(model=model, algo=FLEET_ALGOS[algo][1](probs),
                              trials=_port_trials(probs), device="cpu",
                              **_kw(batcher, False))
    (pd, hd), (pp, hp) = out["banked_dense"], out["banked_paged"]
    assert hp.train_loss is not hd.train_loss
    np.testing.assert_array_equal(hp.stacked()["train_loss"],
                                  hd.stacked()["train_loss"])
    for a, b in zip(tree_leaves(pp), tree_leaves(pd)):
        assert torch.equal(a, b)


class _WritesThroughViews:
    """A stand-in algorithm: `acc` is updated in place through the view of
    the stacked state (as the CUDA kernels update G), `fresh` and `t` come
    back as new values (as the plain versions' results do)."""

    def init_state(self, params, n_clients: int) -> dict:
        return {"acc": torch.zeros(n_clients), "fresh": torch.zeros(()),
                "t": 0}

    def round_step(self, state, params, updates, losses, active, eta,
                   rng=None):
        state["acc"].add_(active.float())
        return ({"acc": state["acc"], "fresh": state["fresh"] + 2,
                 "t": state["t"] + 1}, params,
                {"loss": losses.mean(), "n_active": active.float().sum()})


def test_writes_land_in_the_stacked_state():
    cfg, batcher, probs, _ = _problem("paper_logistic")
    model, n = build_model(cfg), cfg.fl_clients
    runner = FleetRunner(model=model, algo=_WritesThroughViews(),
                         batcher=batcher, schedule=inv_t(1.0), seeds=SEEDS,
                         device="cpu")
    acc = runner.state["acc"]
    parts = [BernoulliParticipation(probs, seed=100 + s) for s in SEEDS]
    masks = [np.stack([p.sample(t) for p in parts]) for t in range(3)]
    for t, m in enumerate(masks):
        runner.step(t, m)
    assert runner.state["acc"] is acc          # the same stacked tensor
    np.testing.assert_array_equal(acc.numpy(), np.sum(masks, axis=0))
    assert runner.state["fresh"].tolist() == [6.0] * len(SEEDS)
    assert runner.state["t"].tolist() == [3] * len(SEEDS)
    # MIFA(array): the stacked G of trial k is the sequential runner's
    fleet = FleetRunner(model=model, algo=MIFA(), batcher=batcher,
                        schedule=inv_t(1.0), seeds=SEEDS, device="cpu")
    seq = [RoundRunner(model=model, algo=MIFA(), batcher=batcher,
                       schedule=inv_t(1.0), seed=s, device="cpu")
           for s in SEEDS]
    for t, m in enumerate(masks):
        fleet.step(t, m)
        for k, r in enumerate(seq):
            r.step(t, m[k])
    for k, r in enumerate(seq):
        for a, b in zip(tree_leaves(tree_index(fleet.state["G"], k)),
                        tree_leaves(r.state["G"])):
            assert torch.equal(a, b)
    assert fleet.state["G"]["w"].shape == (len(SEEDS), n) + tuple(
        model.init(0, device="cpu")["w"].shape)


# --------------------------------------------------------------------------- #
# (d) a paged fleet bank through evictions
# --------------------------------------------------------------------------- #

N = 8
# tests/test_torch_paged_bank.py's sequence for trial 0; trial 1 takes each
# id's page-mate (page_size 2), so the union of a round still spans the
# pages that trial 0's cohort spans and fits the 2 slots
EVICT_COHORTS = [[0, 1], [4, 5], [2, 3], [0, 5], [6, 7], [1, 2], [4], [0, 7]]


def _fleet_cohort(ids):
    ids = np.array([ids, [i ^ 1 for i in ids]])
    padded = np.full((2, 2), N, np.int64)
    padded[:, :ids.shape[1]] = ids
    return padded, padded < N


def _bank_params(k):
    rng = np.random.default_rng(k)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


def _fleet_updates(t):
    rng = np.random.default_rng((5, t))
    return {"w": rng.normal(size=(2, 2, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(2, 2, 3)).astype(np.float32)}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_fleet_bank_matches_reference_through_evictions(dt):
    jb = JPagedDeviceBank(page_size=2, n_slots=2, dtype=dt, use_pallas=False)
    tb = PagedDeviceBank(page_size=2, n_slots=2, dtype=dt, device="cpu")
    dense = DenseBank(dtype=dt, device="cpu")
    params = [_bank_params(k) for k in range(2)]
    js = jax.vmap(lambda p: jb.init(p, N))(
        jax.tree.map(lambda *ls: jnp.stack(ls), *map(_jt, params)))
    ts = tree_stack([tb.init(_to_torch(p), N) for p in params])
    ds = tree_stack([dense.init(_to_torch(p), N) for p in params])
    for t, cohort in enumerate(EVICT_COHORTS):
        ids, valid = _fleet_cohort(cohort)
        upd = _fleet_updates(t)
        js = jb.scatter_fleet(js, ids, _jt(upd), valid=valid)
        ts = tb.scatter_fleet(ts, ids, _to_torch(upd), valid=valid)
        ds = dense.scatter_fleet(ds, ids, _to_torch(upd), valid=valid)
        assert (tb.faults, tb.evictions) == (jb.faults, jb.evictions), t
        np.testing.assert_array_equal(tb._pt, jb._pt)
        assert tb._free == jb._free and sorted(tb._spill) == sorted(jb._spill)
        np.testing.assert_array_equal(ts["page_table"].numpy(),
                                      np.asarray(js["page_table"]))
        for a, b in zip(tree_leaves(ts["pages"]),
                        jax.tree.leaves(js["pages"])):
            np.testing.assert_array_equal(_f32(a), _f32(b))
        for a, b in zip(tree_leaves(ts["g_sum"]),
                        jax.tree.leaves(js["g_sum"])):
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5,
                                       atol=1e-6)
        for a, b in zip(tree_leaves(ts["g_sum"]), tree_leaves(ds["g_sum"])):
            assert torch.equal(a, b), t
    for lp, blocks in tb._spill.items():
        for a, b in zip(blocks, jb._spill[lp]["pages"]):
            np.testing.assert_array_equal(_f32(a), np.asarray(b, np.float32))
    assert tb.faults > 0 and tb.evictions > 0 and tb.refaults > 0
    tb.check_invariants(ts)
    everyone = np.tile(np.arange(N + 1), (2, 1))   # and a pad id
    for a, b in zip(tree_leaves(tb.gather_fleet(ts, everyone)),
                    tree_leaves(dense.gather_fleet(ds, everyone))):
        assert torch.equal(a, b)


def test_dense_gather_fleet_is_per_trial_gather():
    bank = DenseBank(device="cpu")
    params = [_to_torch(_bank_params(k)) for k in range(2)]
    state = tree_stack([bank.init(p, 5) for p in params])
    ids = np.array([[0, 2], [1, 4]])
    state = bank.scatter_fleet(state, ids, _to_torch(_fleet_updates(0)))
    got = bank.gather_fleet(state, ids)
    for k in range(2):
        want = bank.gather(tree_index(state, k), ids[k])
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a[k], b)
    with pytest.raises(ValueError, match="duplicate"):
        bank.scatter_fleet(state, np.array([[1, 1], [0, 2]]),
                           _to_torch(_fleet_updates(1)))


# --------------------------------------------------------------------------- #
# (e) expand_grid and what is not ported yet
# --------------------------------------------------------------------------- #

def test_expand_grid_matches_reference():
    probs = np.linspace(0.1, 1.0, 8)
    kw = dict(seeds=(0, 1), avail_grid=({"p_min": 0.1}, {"p_min": 0.2}),
              clock=("fedavg_s4",), cohort_capacity=8)
    js = jexpand_grid(
        algos={"mifa": JMIFA(), "fedavg_s4": JFedAvgSampling(s=4),
               "is": lambda p_min: JFedAvgIS(tuple(probs * p_min))},
        make_participation=lambda seed, p_min: JBernoulli(probs, seed=seed),
        **kw)
    ts = expand_grid(
        algos={"mifa": MIFA(), "fedavg_s4": FedAvgSampling(s=4),
               "is": lambda p_min: FedAvgIS(probs * p_min)},
        make_participation=lambda seed, p_min: BernoulliParticipation(
            probs, seed=seed), **kw)
    assert [s.name for s in ts] == [s.name for s in js]
    for a, b in zip(ts, js):
        assert a.labels == b.labels and a.seeds == b.seeds
        assert a.n_trials == b.n_trials
        assert a.uses_update_clock == b.uses_update_clock
        assert a.cohort_capacity == b.cohort_capacity
        assert type(a.algo).__name__ == type(b.algo).__name__
        for p, q in zip(a.participations, b.participations):
            np.testing.assert_array_equal(p.sample(1), q.sample(1))


def test_fleet_surfaces_not_ported_raise():
    cfg, batcher, probs, _ = _problem("paper_logistic")
    model = build_model(cfg)
    part = BernoulliParticipation(probs)
    # scenario trials (ROADMAP Queue 1 item 13) are ported
    n = batcher.n_clients
    scen = make_scenario("gilbert_elliott", n=n, seed=2)
    assert Trial(seed=0, scenario=scen).participation is None
    with pytest.raises(ValueError, match="exactly one of"):
        Trial(seed=0)
    (spec,) = expand_grid(algos={"mifa": MIFA()}, seeds=(0, 1),
                          make_scenario=lambda seed, burst: make_scenario(
                              "gilbert_elliott", n=n, seed=seed,
                              burst=burst),
                          avail_grid=({"burst": 2.0},))
    assert spec.labels == ["mifa/burst2.0/seed0", "mifa/burst2.0/seed1"]
    assert spec.participations == (None, None)
    with pytest.raises(ValueError, match="exactly one of"):
        expand_grid(algos={"mifa": MIFA()}, seeds=(0,),
                    make_scenario=lambda seed: scen,
                    make_participation=lambda seed: part)
    kw = dict(model=model, algo=MIFA(), batcher=batcher, n_rounds=1,
              schedule=inv_t(1.0), trials=[Trial(seed=0, participation=part)],
              device="cpu")
    # the scan engine (ROADMAP Queue 1 item 12) is ported
    for engine in ("scan", "scan_strict"):
        assert len(run_fleet(engine=engine, **kw)[1].train_loss) == 1
    with pytest.raises(ValueError, match="unknown engine"):
        run_fleet(engine="nope", **kw)
    # meshes (ROADMAP Queue 1 item 19b) are ported: a 1x1 mesh splits
    # nothing; what is not a mesh raises
    from repro_torch.launch.mesh import make_abstract_mesh
    assert len(run_fleet(mesh=make_abstract_mesh((1, 1), ("data", "model")),
                         **kw)[1].train_loss) == 1
    with pytest.raises(TypeError, match="not a mesh"):
        run_fleet(mesh=object(), **kw)
    runner = FleetRunner(model=model, algo=MIFA(), batcher=batcher,
                         schedule=inv_t(1.0), seeds=(0,), device="cpu")
    with pytest.raises(ValueError, match="scenarios="):
        runner.step_scenario(0)
    runner = FleetRunner(model=model, algo=MIFA(), batcher=batcher,
                         schedule=inv_t(1.0), seeds=(0,), device="cpu",
                         scenarios=[scen])
    assert runner.step_scenario(0)["loss"].shape == (1,)
    # windowed scenarios (item 17) are ported; the trials of one group
    # share the window length
    windowed = make_process("bernoulli", n=n)
    windowed.scan_window = 4
    with pytest.raises(ValueError, match="window length"):
        FleetRunner(model=model, algo=MIFA(), batcher=batcher,
                    schedule=inv_t(1.0), seeds=(0, 1), device="cpu",
                    scenarios=[windowed, make_process("bernoulli", n=n)])
    # simulated fleets (ROADMAP Queue 1 item 16) are ported; a cohort
    # algorithm cannot ride one
    from repro_torch.sim import WaitForAll, tiered_shifted_exponential
    lane = SimTrial(seed=0, policy=WaitForAll(), scenario=scen,
                    latency=tiered_shifted_exponential(n, device="cpu"))
    with pytest.raises(NotImplementedError, match="dense algorithm"):
        run_sim_fleet(model=model, algo=BankedMIFA(DenseBank(device="cpu")),
                      batcher=batcher, schedule=inv_t(1.0), n_rounds=1,
                      trials=[lane], device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        FleetRunner(model=model, algo=MIFA(), batcher=batcher,
                    schedule=inv_t(1.0), seeds=(0, 1), device="cpu",
                    params=model.init(0, device="cpu"))
