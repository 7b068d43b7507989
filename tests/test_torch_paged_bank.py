"""The port's paged bank path against the JAX package's, on the CPU.

  (a) the plain versions of the paged kernels against the reference's
      Pallas `paged_bank_scatter` / `paged_bank_gather` (interpret mode);
  (b) the tree wrappers against the reference's;
  (c) `PagedDeviceBank(device="cpu")` against the reference's
      `PagedDeviceBank(use_pallas=False)` through an eviction-heavy cohort
      sequence: the same faults, evictions, page table, free list and spill;
  (d) within the port, the paged bank against `DenseBank`;
  (e) `run_fl` with `BankedMIFA(PagedDeviceBank)` against the reference's;
  (f) `ProceduralBatcher` against the reference's.

The same numpy inputs go to both packages. Selected and copied values
(pages, gathered rows) must be bit-equal; delta sums and G_sum are summed in
another order by the two frameworks and agree within rtol 1e-5, atol 1e-6.
Within the port the paged and dense banks sum the same cohort rows in the
same order, so there G_sum is bit-equal too. Trajectories: as
`tests/test_torch_run_fl.py` (rtol 1e-4, atol 1e-6 after 20 rounds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_run_fl import _close, _problem, _run_jax, _run_torch

from repro.bank import BankedMIFA as JBankedMIFA
from repro.bank import PagedDeviceBank as JPagedDeviceBank
from repro.configs import get_smoke_config as jax_smoke
from repro.data import pipeline as jpipeline
from repro.models import build_model as jax_build
from repro_torch.bank import (BankedMIFA, DenseBank, Int8PagedBank,
                              PagedDeviceBank, make_bank)
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as tpipeline
from repro_torch.kernels.ops import (paged_bank_gather_tree,
                                     paged_bank_update_tree)
from repro_torch.kernels.paged_bank import (paged_bank_gather,
                                            paged_bank_scatter,
                                            paged_bank_scatter_ordered_ref,
                                            paged_bank_scatter_ref)
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PS = 4          # rows per page for the kernel cases
N_SLOTS = 3     # resident slots; slot 3 is the dummy slot
# 5 logical pages + the dummy logical page 5: pages 0, 2, 3 resident in
# shuffled slots, pages 1 and 4 not resident (sentinel 3 = dummy slot)
PAGE_TABLE = np.array([2, 3, 0, 1, 3, 3], np.int32)
DUMMY_LROW = 5 * PS


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _paged_inputs(m, n_valid, seed):
    """Pages with a zero dummy page, a cohort of 8 slots: n_valid distinct
    rows of resident pages, then pads at the dummy logical row."""
    rng = np.random.default_rng(seed)
    pages = rng.normal(size=((N_SLOTS + 1) * PS, m)).astype(np.float32)
    pages[N_SLOTS * PS:] = 0.0
    u = rng.normal(size=(8, m)).astype(np.float32)
    resident = [lp * PS + r for lp in (0, 2, 3) for r in range(PS)]
    lids = np.full(8, DUMMY_LROW, np.int32)
    lids[:n_valid] = rng.permutation(resident)[:n_valid]
    return pages, u, lids, np.arange(8) < n_valid


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------- #
# (a) plain versions against the Pallas kernels; (b) the tree wrappers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dt,n_valid", [("float32", 5), ("bfloat16", 5),
                                        ("float32", 0)])
def test_paged_bank_scatter_matches_pallas(dt, n_valid):
    from repro.kernels.bank_scatter import paged_bank_scatter as pallas
    pages, u, lids, valid = _paged_inputs(256, n_valid, seed=n_valid)
    p_j, d_j = pallas(jnp.asarray(pages, dt), jnp.asarray(u),
                      jnp.asarray(PAGE_TABLE), jnp.asarray(lids),
                      jnp.asarray(valid), page_size=PS, block_m=128,
                      interpret=True)
    p_t, d_t = paged_bank_scatter(_t(pages).to(TORCH_DT[dt]), _t(u),
                                  _t(PAGE_TABLE), _t(lids), _t(valid),
                                  page_size=PS)
    assert p_t.dtype == TORCH_DT[dt] and d_t.dtype == torch.float32
    np.testing.assert_array_equal(_f32(p_t), _f32(p_j))
    np.testing.assert_allclose(_f32(d_t), _f32(d_j), rtol=1e-5, atol=1e-6)
    assert not p_t[N_SLOTS * PS:].any(), "a write reached the dummy page"
    if n_valid == 0:
        assert not d_t.any()


@pytest.mark.parametrize("dt,n_valid", [("float32", 8), ("bfloat16", 8),
                                        ("float32", 3)])
def test_paged_bank_scatter_ordered_ref_matches_plain_and_pallas(dt,
                                                                 n_valid):
    """The CUDA kernels' fixed-order oracle through the page table: pages
    equal to the plain version's and the Pallas kernel's, dsum within rtol
    1e-5, atol 1e-6 of both, and bit-equal to the dense oracle on the same
    physical rows."""
    from repro.kernels.bank_scatter import paged_bank_scatter as pallas
    from repro_torch.kernels.bank_scatter import bank_scatter_ordered_ref
    from repro_torch.kernels.paged_bank import phys_rows
    pages, u, lids, valid = _paged_inputs(384, n_valid, seed=10 + n_valid)
    args = (_t(u), _t(PAGE_TABLE), _t(lids), _t(valid))
    pages_t = _t(pages).to(TORCH_DT[dt])
    p_o, d_o = paged_bank_scatter_ordered_ref(pages_t, *args, page_size=PS)
    p_p, d_p = paged_bank_scatter_ref(pages_t, *args, page_size=PS)
    p_j, d_j = pallas(jnp.asarray(pages, dt), jnp.asarray(u),
                      jnp.asarray(PAGE_TABLE), jnp.asarray(lids),
                      jnp.asarray(valid), page_size=PS, block_m=128,
                      interpret=True)
    assert torch.equal(p_o, p_p)
    np.testing.assert_array_equal(_f32(p_o), _f32(p_j))
    for ref in (d_p, d_j):
        np.testing.assert_allclose(_f32(d_o), _f32(ref), rtol=1e-5,
                                   atol=1e-6)
    _, d_dense = bank_scatter_ordered_ref(
        pages_t, _t(u), phys_rows(_t(PAGE_TABLE), _t(lids), PS), _t(valid))
    assert torch.equal(d_o, d_dense)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_bank_gather_matches_pallas(dt):
    from repro.kernels.bank_scatter import paged_bank_gather as pallas
    pages, _, lids, _ = _paged_inputs(384, 5, seed=7)
    lids[5] = 1 * PS + 2            # a row of non-resident page 1: zeros
    r_j = pallas(jnp.asarray(pages, dt), jnp.asarray(PAGE_TABLE),
                 jnp.asarray(lids), page_size=PS, block_m=128,
                 interpret=True)
    r_t = paged_bank_gather(_t(pages).to(TORCH_DT[dt]), _t(PAGE_TABLE),
                            _t(lids), page_size=PS)
    assert r_t.dtype == torch.float32 and r_t.shape == (8, 384)
    np.testing.assert_array_equal(_f32(r_t), _f32(r_j))
    assert not r_t[5:].any()


def _tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=lead + (17, 9)).astype(np.float32),
            "b": {"c": rng.normal(size=lead + (33,)).astype(np.float32)},
            "layers": [{"w": rng.normal(size=lead + (5, 3)).astype(
                np.float32)}]}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree)


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_paged_bank_update_tree_matches_reference_tree():
    from repro.kernels.ops import paged_bank_update_tree as jax_tree
    pages, upd = _tree(3, ((N_SLOTS + 1) * PS,)), _tree(4, (4,))
    for leaf in jax.tree.leaves(pages):
        leaf[N_SLOTS * PS:] = 0.0
    lids = np.array([9, 0, DUMMY_LROW, DUMMY_LROW], np.int32)
    valid = np.array([True, True, False, False])
    p_j, d_j = jax_tree(_jt(pages), _jt(upd), jnp.asarray(PAGE_TABLE),
                        jnp.asarray(lids), jnp.asarray(valid), page_size=PS,
                        interpret=True)
    p_t, d_t = paged_bank_update_tree(_to_torch(pages), _to_torch(upd),
                                      _t(PAGE_TABLE), _t(lids), _t(valid),
                                      page_size=PS)
    for a, b in zip(tree_leaves(p_t), jax.tree.leaves(p_j)):
        np.testing.assert_array_equal(_f32(a), _f32(b))
    for a, b in zip(tree_leaves(d_t), jax.tree.leaves(d_j)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5, atol=1e-6)


def test_paged_bank_gather_tree_matches_reference_tree():
    from repro.kernels.ops import paged_bank_gather_tree_pure as jax_tree
    pages = _tree(5, ((N_SLOTS + 1) * PS,))
    lids = np.array([13, 2, 5, DUMMY_LROW, 8], np.int32)
    r_j = jax_tree(_jt(pages), jnp.asarray(PAGE_TABLE), jnp.asarray(lids),
                   page_size=PS, interpret=True)
    r_t = paged_bank_gather_tree(_to_torch(pages), _t(PAGE_TABLE), _t(lids),
                                 page_size=PS)
    for a, b in zip(tree_leaves(r_t), jax.tree.leaves(r_j)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_f32(a), _f32(b))


# --------------------------------------------------------------------------- #
# (c) the bank against the reference's; (d) against the port's DenseBank
# --------------------------------------------------------------------------- #

N = 8
# tests/test_bank.py's sequence: at page_size=2 / n_slots=2 every round fits
# the slot budget, but the sequence forces evictions and re-faults
EVICT_COHORTS = [[0, 1], [4, 5], [2, 3], [0, 5], [6, 7], [1, 2], [4], [0, 7]]


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


def _cohort_updates(t, ids):
    rng = np.random.default_rng((3, t))
    return {"w": rng.normal(size=(len(ids), 4, 3)).astype(np.float32),
            "b": rng.normal(size=(len(ids), 3)).astype(np.float32)}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_bank_matches_reference_through_evictions(dt):
    jb = JPagedDeviceBank(page_size=2, n_slots=2, dtype=dt, use_pallas=False)
    tb = PagedDeviceBank(page_size=2, n_slots=2, dtype=dt, device="cpu")
    js, ts = jb.init(_jt(_params()), N), tb.init(_to_torch(_params()), N)
    for t, ids in enumerate(EVICT_COHORTS):
        ids = np.array(ids)
        upd = _cohort_updates(t, ids)
        js = jb.scatter(js, ids, _jt(upd))
        ts = tb.scatter(ts, ids, _to_torch(upd))
        assert (tb.faults, tb.evictions) == (jb.faults, jb.evictions), t
        np.testing.assert_array_equal(tb._pt, jb._pt)
        assert tb._free == jb._free and sorted(tb._spill) == sorted(jb._spill)
        np.testing.assert_array_equal(ts["page_table"].numpy(),
                                      np.asarray(js["page_table"]))
        for a, b in zip(tree_leaves(ts["pages"]), jax.tree.leaves(js["pages"])):
            np.testing.assert_array_equal(_f32(a), _f32(b))
        for a, b in zip(tree_leaves(tb.mean_g(ts)),
                        jax.tree.leaves(jb.mean_g(js))):
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5, atol=1e-6)
    assert tb.faults > 0 and tb.evictions > 0 and tb.refaults > 0
    for a, b in zip(tree_leaves(tb.gather(ts, np.arange(N))),
                    jax.tree.leaves(jb.gather(js, np.arange(N)))):
        np.testing.assert_array_equal(_f32(a), _f32(b))
    tb.check_invariants(ts)
    assert tb.n_resident() == jb.n_resident() <= 2
    assert tb.memory_bytes(ts)["host"] > 0


def test_paged_bank_matches_dense_bank_bit_for_bit():
    paged = PagedDeviceBank(page_size=2, n_slots=2, device="cpu")
    dense = DenseBank(device="cpu")
    ps = paged.init(_to_torch(_params()), N)
    ds = dense.init(_to_torch(_params()), N)
    for t, ids in enumerate(EVICT_COHORTS):
        ids = np.array(ids)
        upd = _to_torch(_cohort_updates(t, ids))
        ps, ds = paged.scatter(ps, ids, upd), dense.scatter(ds, ids, upd)
        for a, b in zip(tree_leaves(paged.mean_g(ps)),
                        tree_leaves(dense.mean_g(ds))):
            assert torch.equal(a, b), t
    ids = np.array([7, 3, 0, N, 5])         # a pad id reads zeros
    for a, b in zip(tree_leaves(paged.gather(ps, ids)),
                    tree_leaves(dense.gather(ds, ids))):
        assert torch.equal(a, b)
    assert paged.memory_bytes(ps)["device_pages"] < dense.memory_bytes(
        ds)["device"]


def test_paged_working_set_overflow_raises():
    bank = PagedDeviceBank(page_size=2, n_slots=2, device="cpu")
    state = bank.init(_to_torch(_params()), N)
    ids = np.array([0, 2, 4])        # spans 3 pages, only 2 slots
    with pytest.raises(ValueError, match="slots"):
        bank.scatter(state, ids, _to_torch(_cohort_updates(0, ids)))


def test_paged_device_pages_do_not_depend_on_n():
    small = PagedDeviceBank(page_size=2, n_slots=2, device="cpu")
    big = PagedDeviceBank(page_size=2, n_slots=2, device="cpu")
    ss = small.init(_to_torch(_params()), N)
    sb = big.init(_to_torch(_params()), 64 * N)
    assert (small.memory_bytes(ss)["device_pages"]
            == big.memory_bytes(sb)["device_pages"] == 3 * 2 * 15 * 4)
    big.check_invariants(sb)


def test_make_bank_and_what_is_not_ported():
    assert isinstance(make_bank("paged_device", page_size=2, device="cpu"),
                      PagedDeviceBank)
    assert isinstance(make_bank(device="cpu"), DenseBank)
    # the host bank (ROADMAP Queue 1 item 9) is ported
    from repro_torch.bank import HostBank
    assert isinstance(make_bank("host", device="cpu"), HostBank)
    with pytest.raises(ValueError, match="unknown bank backend"):
        make_bank("nope")
    # int8 memory (ROADMAP Queue 1 item 10) is ported
    assert isinstance(make_bank("int8_paged", device="cpu"), Int8PagedBank)
    assert PagedDeviceBank(dtype="int8", device="cpu").quantized
    # its host state for snapshots (ROADMAP Queue 1 item 17) is ported
    bank = PagedDeviceBank(page_size=2, device="cpu")
    bank.init({"w": torch.zeros(3)}, 5)
    host = bank.host_state()
    assert list(host) == ["pt", "slot_lp", "free", "lru_keys", "lru_vals",
                          "clock", "faults", "evictions", "spill_lp"]
    bank.load_host_state({})
    np.testing.assert_array_equal(bank.host_state()["pt"], host["pt"])


# --------------------------------------------------------------------------- #
# (e) run_fl end to end; (f) ProceduralBatcher
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["paper_logistic", "paper_mlp"])
def test_run_fl_paged_matches_reference(name):
    cfg, batcher, probs, test = _problem(name)
    jparams = jax_build(jax_smoke(name)).init(jax.random.PRNGKey(0))
    p_np = jax.tree.map(np.asarray, jparams)
    pj, hj = _run_jax(name, JBankedMIFA(JPagedDeviceBank(page_size=2)),
                      batcher, probs, test, jparams)
    algo = BankedMIFA(PagedDeviceBank(page_size=2, device="cpu"))
    pt, ht = _run_torch(cfg, algo, batcher, probs, test,
                        params_from_jax(p_np, "cpu"))
    assert ht.n_active == hj.n_active
    assert ht.tau_bar == hj.tau_bar and ht.tau_max == hj.tau_max
    _close(ht.train_loss, hj.train_loss, 1e-4, 1e-6)
    _close([v for _, v in ht.eval_loss], [v for _, v in hj.eval_loss],
           1e-4, 1e-6)
    for a, b in zip(tree_leaves(pt), jax.tree.leaves(pj)):
        assert tuple(a.shape) == b.shape
        _close(a.numpy(), np.asarray(b), 1e-4, 1e-6)
    assert algo.bank.faults == algo.bank.lp and algo.bank.evictions == 0


@pytest.mark.parametrize("client_ids", [None, [19, 3, 3, 11]])
def test_procedural_batcher_equal(client_ids):
    kw = dict(n_clients=20, dim=6, n_classes=3, batch_size=4, k_steps=2,
              seed=5)
    jb, tb = jpipeline.ProceduralBatcher(**kw), tpipeline.ProceduralBatcher(
        **kw)
    for t in (0, 2):
        jr = jb.sample_round(t, client_ids=client_ids)
        tr = tb.sample_round(t, client_ids=client_ids)
        assert jr.keys() == tr.keys()
        for k in jr:
            assert jr[k].dtype == tr[k].dtype
            np.testing.assert_array_equal(jr[k], tr[k])
