"""The leaf table and the kernels that launch once per tree on it:
`mifa_aggregate_leaves` (through `ops.mifa_aggregate_tree`),
`paged_bank_gather_leaves` (through `ops.paged_bank_gather_tree`), the
single-trial scatters `bank_scatter_leaves` and `paged_bank_scatter_leaves`
(through `ops.bank_update_tree` and `ops.paged_bank_update_tree`) and the
fleet scatters `bank_scatter_batched_leaves` and
`paged_bank_scatter_batched_leaves` (through `ops.fleet_bank_update_tree`
and `ops.fleet_paged_bank_update_tree`).

On the CPU: the table's packing covers every column of every leaf exactly
once, through the kernel's own leaf search; the tree wrappers (plain
versions, leaf by leaf) against the JAX package's Pallas kernels in
interpret mode, with mixed f32/bf16 leaves, ragged widths and shuffled
page tables. Copied values (G, gathered rows, bank rows, pages) must match
exactly; w within rtol 1e-5, atol 1e-6 where it is f32 (the two packages
sum in another order) and within 1e-2 where it is bf16 (one bf16 rounding
apart), as `tests/test_torch_kernels.py` holds them; the fleet scatters'
delta sums within atol 1e-6, as `tests/test_torch_fleet.py` holds them, and
the single-trial scatters' within rtol 1e-5, atol 1e-6, as
`tests/test_torch_kernels.py` and `tests/test_torch_paged_bank.py` hold
them.

The `cuda` tests hold the one-launch-per-tree kernels against the per-leaf
plain versions on the card, at the edges of the table: paper_mlp's six
widths, mixed dtypes, ragged widths, one leaf, nothing active, more leaves
than one table holds, non-resident pages, and a repeated call; the four
scatters' delta sums bit-equal to the fixed-order oracle
(`bank_scatter_ordered_ref`), and the fleet scatters per trial and leaf
bit-equal to the single-trial kernels. They skip without a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_leaf_table.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import leaf_table
from repro_torch.kernels.bank_scatter import (bank_scatter,
                                              bank_scatter_batched,
                                              bank_scatter_batched_leaves,
                                              bank_scatter_batched_ref,
                                              bank_scatter_leaves,
                                              bank_scatter_ordered_ref,
                                              bank_scatter_ref)
from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                mifa_aggregate_leaves,
                                                mifa_aggregate_ref)
from repro_torch.kernels.ops import (bank_update_tree,
                                     fleet_bank_update_tree,
                                     fleet_paged_bank_update_tree,
                                     mifa_aggregate_tree,
                                     paged_bank_gather_tree,
                                     paged_bank_update_tree)
from repro_torch.kernels.paged_bank import (
    paged_bank_gather, paged_bank_gather_leaves, paged_bank_gather_ref,
    paged_bank_scatter, paged_bank_scatter_batched,
    paged_bank_scatter_batched_leaves, paged_bank_scatter_batched_ref,
    paged_bank_scatter_leaves, paged_bank_scatter_ordered_ref,
    paged_bank_scatter_ref)

torch.set_num_threads(1)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (1e-2, 1e-2)}
# paper_mlp's flattened leaf widths, in leaf order
PAPER_MLP_WIDTHS = [128, 32768, 128, 16384, 10, 1280]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------- #
# the packing
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("widths,flags", [
    (PAPER_MLP_WIDTHS, [leaf_table.VECTOR] * 4 + [0, leaf_table.VECTOR]),
    ([1, 127, 128, 129, 1000, 10, 255, 3],
     [leaf_table.A_BF16, 0, leaf_table.W_BF16 | leaf_table.A_BF16,
      leaf_table.VECTOR, 0, leaf_table.A_BF16, 0, leaf_table.W_BF16]),
    ([7], [0]),
    ([(37 * j) % 301 + 1 for j in range(150)],
     [j % 8 for j in range(150)]),          # three tables: 64 + 64 + 22
])
def test_leaf_table_covers_every_column_once(widths, flags):
    leaves = [((1000 + j, 2000 + j), m, f)
              for j, (m, f) in enumerate(zip(widths, flags))]
    tables = leaf_table.pack(leaves)
    assert len(tables) == -(-len(widths) // leaf_table.MAX_LEAVES)
    seen = [np.zeros(m, np.int64) for m in widths]
    start = 0
    for table in tables:
        assert 0 < table.n_leaves <= leaf_table.MAX_LEAVES
        assert table.n_tiles == sum(leaf_table.n_tiles(m) for m in
                                    widths[start:start + table.n_leaves])
        for tile in range(table.n_tiles):
            j = leaf_table.find_leaf(table, tile)
            leaf = table.leaf[j]
            assert (leaf.ptr[0], leaf.ptr[1], leaf.ptr[2]) == (
                1000 + start + j, 2000 + start + j, None)
            assert leaf.flags == flags[start + j]
            c0 = (tile - leaf.first_tile) * leaf_table.COLS_PER_TILE
            assert 0 <= c0 < leaf.m == widths[start + j]
            seen[start + j][c0:c0 + leaf_table.COLS_PER_TILE] += 1
        start += table.n_leaves
    assert start == len(widths)
    assert all((s == 1).all() for s in seen)


def test_leaf_table_rejects_an_empty_leaf():
    with pytest.raises(ValueError, match="width 0"):
        leaf_table.pack([((1, 2), 4, 0), ((3, 4), 0, 0)])


# --------------------------------------------------------------------------- #
# the tree wrappers against the JAX package (CPU, interpret mode)
# --------------------------------------------------------------------------- #

def _mixed_mifa_tree(n, seed):
    """G, U and params trees of five leaves of mixed widths and dtypes:
    (leaf shape, G dtype, w dtype)."""
    spec = {"a": ((17, 9), "bfloat16", "float32"),
            "b": ((33,), "float32", "float32"),
            "c": ((10,), "bfloat16", "float32"),
            "d": ((8, 16), "float32", "float32"),
            "e": ((5, 3), "float32", "bfloat16")}
    rng = np.random.default_rng(seed)
    g = {k: rng.normal(size=(n,) + s).astype(np.float32)
         for k, (s, _, _) in spec.items()}
    u = {k: rng.normal(size=(n,) + s).astype(np.float32)
         for k, (s, _, _) in spec.items()}
    w = {k: rng.normal(size=s).astype(np.float32)
         for k, (s, _, _) in spec.items()}
    return spec, g, u, w


def test_mifa_aggregate_tree_mixed_dtypes_matches_reference_tree():
    import jax.numpy as jnp
    from repro.kernels.ops import mifa_aggregate_tree as jax_tree
    n, eta = 6, 0.1
    spec, g, u, w = _mixed_mifa_tree(n, 0)
    active = np.array([1, 0, 1, 1, 0, 1], bool)
    g_j, p_j = jax_tree({k: jnp.asarray(g[k], spec[k][1]) for k in spec},
                        {k: jnp.asarray(u[k]) for k in spec},
                        jnp.asarray(active),
                        {k: jnp.asarray(w[k], spec[k][2]) for k in spec},
                        eta, block_m=64, interpret=True)
    g_t, p_t = mifa_aggregate_tree(
        {k: torch.from_numpy(g[k]).to(TORCH_DT[spec[k][1]]) for k in spec},
        {k: torch.from_numpy(u[k]) for k in spec}, torch.from_numpy(active),
        {k: torch.from_numpy(w[k]).to(TORCH_DT[spec[k][2]]) for k in spec},
        eta)
    for k, (shape, gdt, wdt) in spec.items():
        assert g_t[k].dtype == TORCH_DT[gdt] and g_t[k].shape == (n,) + shape
        assert p_t[k].dtype == TORCH_DT[wdt] and p_t[k].shape == shape
        np.testing.assert_array_equal(_f32(g_t[k]), _f32(g_j[k]))
        rtol, atol = TOL[TORCH_DT[wdt]]
        np.testing.assert_allclose(_f32(p_t[k]), _f32(p_j[k]), rtol=rtol,
                                   atol=atol)


PS = 4
# 6 logical pages + the dummy logical page 6 over 3 slots (slot 3 is the
# dummy slot): pages 4, 0, 3 resident in shuffled slots 0, 1, 2; pages 1,
# 2 and 5 not resident
PAGE_TABLE = np.array([1, 3, 3, 2, 0, 3, 3], np.int32)
DUMMY_LROW = 6 * PS


def test_paged_bank_gather_tree_matches_pallas_leaf_by_leaf():
    """Mixed f32/bf16 leaves of ragged widths through a shuffled page
    table, rows of non-resident pages (zeros) and pad slots among them."""
    import jax.numpy as jnp
    from repro.kernels.bank_scatter import paged_bank_gather as pallas
    rng = np.random.default_rng(3)
    r = 4 * PS
    spec = {"a": ((10,), "float32"), "b": ((4, 25), "bfloat16"),
            "c": ((128,), "float32"), "d": ((3, 3), "bfloat16")}
    pages = {}
    for k, (shape, _) in spec.items():
        p = rng.normal(size=(r,) + shape).astype(np.float32)
        p[3 * PS:] = 0.0                      # the dummy page
        pages[k] = p
    lids = np.array([17, 2, 0, 13, 5, DUMMY_LROW, 22, 19, 3, 12, 9,
                     DUMMY_LROW], np.int32)
    rows = paged_bank_gather_tree(
        {k: torch.from_numpy(p).to(TORCH_DT[spec[k][1]])
         for k, p in pages.items()},
        torch.from_numpy(PAGE_TABLE), torch.from_numpy(lids), page_size=PS)
    for k, (shape, dt) in spec.items():
        m = int(np.prod(shape))
        r_j = pallas(jnp.asarray(pages[k].reshape(r, m), dt),
                     jnp.asarray(PAGE_TABLE), jnp.asarray(lids),
                     page_size=PS, block_m=m, interpret=True)
        assert rows[k].dtype == torch.float32
        assert rows[k].shape == (len(lids),) + shape
        np.testing.assert_array_equal(_f32(rows[k]).reshape(len(lids), m),
                                      _f32(r_j))
        # slots 4, 5, 6, 10 and 11 read non-resident pages or the dummy
        assert not rows[k][[4, 5, 6, 10, 11]].any()


def test_leaf_wrappers_check_every_leaf():
    g = torch.zeros(4, 8)
    u, act, w = torch.zeros(4, 8), torch.ones(4, dtype=torch.bool), \
        torch.zeros(8)
    with pytest.raises(ValueError, match="same number"):
        mifa_aggregate_leaves([g, g], [u], act, [w, w], 0.1)
    with pytest.raises(TypeError, match="updates must be float32"):
        mifa_aggregate_leaves([g, g], [u, u.double()], act, [w, w], 0.1)
    pt, lids = torch.zeros(3, dtype=torch.int32), torch.zeros(
        2, dtype=torch.int32)
    with pytest.raises(ValueError, match="no leaves"):
        paged_bank_gather_leaves([], pt, lids, page_size=2)
    with pytest.raises(ValueError, match="multiple of page_size"):
        paged_bank_gather_leaves([torch.zeros(4, 8), torch.zeros(5, 8)],
                                 pt, lids, page_size=2)


# five leaves of a fleet bank: (leaf shape, stored dtype); widths 153, 33,
# 10, 128 and 15, so three take the scalar walk and two the 4-wide one
FLEET_SPEC = {"a": ((17, 9), "bfloat16"), "b": ((33,), "float32"),
              "c": ((10,), "bfloat16"), "d": ((8, 16), "float32"),
              "e": ((5, 3), "float32")}
K_TRIALS, COHORT = 3, 8


def _fleet_cohorts(rng, rows: int, dummy: int):
    """(K, C) slots and valid flags: trial k has 5 - 2k distinct valid
    rows below `rows` in shuffled slots, the last trial only pads; pads sit
    at `dummy`."""
    ids = np.full((K_TRIALS, COHORT), dummy, np.int64)
    valid = np.zeros((K_TRIALS, COHORT), bool)
    for k, n_valid in enumerate((5, 3, 0)):
        at = rng.permutation(COHORT)[:n_valid]
        ids[k, at] = rng.permutation(rows)[:n_valid]
        valid[k, at] = True
    return ids, valid


def _fleet_tree(rng, r):
    """Stored rows (K, r, *shape) and updates (K, C, *shape) per leaf."""
    rows = {k: rng.normal(size=(K_TRIALS, r) + s).astype(np.float32)
            for k, (s, _) in FLEET_SPEC.items()}
    upd = {k: rng.normal(size=(K_TRIALS, COHORT) + s).astype(np.float32)
           for k, (s, _) in FLEET_SPEC.items()}
    return rows, upd


def _check_fleet_tree(rows_t, ds_t, rows_j, ds_j, before, valid):
    """Port against reference leaf by leaf: rows bit-equal, dsum within atol
    1e-6; a trial of pads only keeps its rows and a zero dsum."""
    for k, (shape, dt) in FLEET_SPEC.items():
        assert rows_t[k].dtype == TORCH_DT[dt]
        assert rows_t[k].shape == before[k].shape
        assert ds_t[k].dtype == torch.float32
        assert ds_t[k].shape == (K_TRIALS,) + shape
        np.testing.assert_array_equal(_f32(rows_t[k]), _f32(rows_j[k]))
        np.testing.assert_allclose(_f32(ds_t[k]), _f32(ds_j[k]), rtol=0,
                                   atol=1e-6)
        assert not valid[-1].any()
        assert torch.equal(rows_t[k][-1], before[k][-1])
        assert not ds_t[k][-1].any()


def test_fleet_bank_update_tree_mixed_matches_reference_tree():
    import jax.numpy as jnp
    from repro.kernels.ops import fleet_bank_update_tree as jax_tree
    rng = np.random.default_rng(20)
    r = 12                                   # N = 11 clients + the dummy
    rows, upd = _fleet_tree(rng, r)
    ids, valid = _fleet_cohorts(rng, r - 1, r - 1)
    rows_j, ds_j = jax_tree(
        {k: jnp.asarray(v, FLEET_SPEC[k][1]) for k, v in rows.items()},
        {k: jnp.asarray(v) for k, v in upd.items()},
        jnp.asarray(ids, jnp.int32), jnp.asarray(valid), interpret=True)
    before = {k: torch.from_numpy(v).to(TORCH_DT[FLEET_SPEC[k][1]])
              for k, v in rows.items()}
    rows_t, ds_t = fleet_bank_update_tree(
        {k: v.clone() for k, v in before.items()},
        {k: torch.from_numpy(v) for k, v in upd.items()},
        torch.from_numpy(ids), torch.from_numpy(valid))
    _check_fleet_tree(rows_t, ds_t, rows_j, ds_j, before, valid)


def test_fleet_paged_bank_update_tree_mixed_matches_reference_tree():
    """Per-trial shuffled page tables: 3 of 6 logical pages resident in
    each trial, in shuffled slots, the others at the dummy slot."""
    import jax.numpy as jnp
    from repro.kernels.ops import fleet_paged_bank_update_tree_pure as jax_tree
    rng = np.random.default_rng(21)
    n_slots, lp = 3, 6
    rows, upd = _fleet_tree(rng, (n_slots + 1) * PS)
    for v in rows.values():
        v[:, n_slots * PS:] = 0.0                     # the dummy page
    pt = np.full((K_TRIALS, lp + 1), n_slots, np.int32)
    resident = []
    for k in range(K_TRIALS):
        res = rng.permutation(lp)[:n_slots]
        pt[k, res] = rng.permutation(n_slots)
        resident.append(res)
    lids, valid = _fleet_cohorts(rng, n_slots * PS, lp * PS)
    for k in range(K_TRIALS):        # valid rows of trial k's resident pages
        at = lids[k, valid[k]]
        lids[k, valid[k]] = resident[k][at // PS] * PS + at % PS
    lids = lids.astype(np.int32)
    rows_j, ds_j = jax_tree(
        {k: jnp.asarray(v, FLEET_SPEC[k][1]) for k, v in rows.items()},
        {k: jnp.asarray(v) for k, v in upd.items()}, jnp.asarray(pt),
        jnp.asarray(lids), jnp.asarray(valid), page_size=PS, interpret=True)
    before = {k: torch.from_numpy(v).to(TORCH_DT[FLEET_SPEC[k][1]])
              for k, v in rows.items()}
    rows_t, ds_t = fleet_paged_bank_update_tree(
        {k: v.clone() for k, v in before.items()},
        {k: torch.from_numpy(v) for k, v in upd.items()},
        torch.from_numpy(pt), torch.from_numpy(lids),
        torch.from_numpy(valid), page_size=PS)
    _check_fleet_tree(rows_t, ds_t, rows_j, ds_j, before, valid)
    for k in FLEET_SPEC:
        assert not rows_t[k][:, n_slots * PS:].any()


def test_fleet_scatter_leaf_wrappers_check_every_leaf():
    k, r, c = 3, 8, 4
    banks = [torch.zeros(k, r, 8), torch.zeros(k, r, 5)]
    upds = [torch.zeros(k, c, 8), torch.zeros(k, c, 5)]
    ids = torch.zeros(k, c, dtype=torch.int64)
    valid = torch.zeros(k, c, dtype=torch.bool)
    bad = {
        "same number": (banks, upds[:1], ids, valid),
        "at least one": ([], [], ids, valid),
        "updates must be float32": (banks, [upds[0], upds[1].double()],
                                    ids, valid),
        "banks must be float32 or bfloat16": (
            [banks[0], banks[1].half()], upds, ids, valid),
        r"\(K, R, M\)": ([banks[0], banks[1][0]], upds, ids, valid),
        "shape mismatch: banks": (                         # K of one leaf
            [banks[0], torch.zeros(k - 1, r, 5)], upds, ids, valid),
        "shape mismatch: updates": (                       # C of one leaf
            banks, [upds[0], torch.zeros(k, c + 1, 5)], ids, valid),
        "shape mismatch: ids": (banks, upds, ids[:, 1:], valid),   # C
        "shape mismatch: valid": (banks, upds, ids, valid[1:]),    # K
        "ids must be int64": (banks, upds, ids.int(), valid)}
    for match, args in bad.items():
        with pytest.raises((TypeError, ValueError), match=match):
            bank_scatter_batched_leaves(*args)
    pt, lids = torch.zeros(k, 5, dtype=torch.int32), ids.int()
    for match, (pages, upd, table, lid, ps) in {
            "power of two": (banks, upds, pt, lids, 3),
            "multiple of page_size": (
                [torch.zeros(k, 6, 8), torch.zeros(k, 6, 5)], upds, pt,
                lids, 4),
            "shape mismatch: pages": (                     # R of one leaf
                [banks[0], torch.zeros(k, r + 2, 5)], upds, pt, lids, 2),
            "shape mismatch: page_table": (banks, upds, pt[1:], lids, 2),
            r"page_table \(K, P\)": (banks, upds, pt[0], lids, 2),
            "lids must be int32": (banks, upds, pt, ids, 2),
            "shape mismatch: lids": (banks, upds, pt, lids[:, 1:], 2)}.items():
        with pytest.raises((TypeError, ValueError), match=match):
            paged_bank_scatter_batched_leaves(pages, upd, table, lid, valid,
                                              page_size=ps)


# trees of one bank for the single-trial scatters: (leaf shape, stored
# dtype); "mixed" has three leaves on the scalar walk and two on the 4-wide
# one. A cohort of 20 slots spans more than the kernels' 8 row groups.
SCATTER_SPECS = {"mixed": FLEET_SPEC, "one leaf": {"w": ((16, 9), "bfloat16")}}
SCATTER_COHORT = 20


def _scatter_cohort(rng, rows, n_valid: int, dummy: int):
    """(C,) slots: n_valid distinct valid rows of `rows` in shuffled slots,
    pads at `dummy`."""
    ids = np.full(SCATTER_COHORT, dummy, np.int64)
    at = rng.permutation(SCATTER_COHORT)[:n_valid]
    ids[at] = rng.permutation(rows)[:n_valid]
    return ids, np.isin(np.arange(SCATTER_COHORT), at)


def _scatter_tree(rng, spec, r):
    """Stored rows (r, *shape) and updates (C, *shape) per leaf."""
    return ({k: rng.normal(size=(r,) + s).astype(np.float32)
             for k, (s, _) in spec.items()},
            {k: rng.normal(size=(SCATTER_COHORT,) + s).astype(np.float32)
             for k, (s, _) in spec.items()})


def _check_scatter_tree(spec, rows_t, ds_t, rows_j, ds_j, before):
    """Port against reference leaf by leaf: rows bit-equal, dsum within
    rtol 1e-5, atol 1e-6."""
    for k, (shape, dt) in spec.items():
        assert rows_t[k].dtype == TORCH_DT[dt]
        assert rows_t[k].shape == before[k].shape
        assert ds_t[k].dtype == torch.float32 and ds_t[k].shape == shape
        np.testing.assert_array_equal(_f32(rows_t[k]), _f32(rows_j[k]))
        np.testing.assert_allclose(_f32(ds_t[k]), _f32(ds_j[k]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("tree", sorted(SCATTER_SPECS))
def test_bank_update_tree_mixed_matches_reference_tree(tree):
    import jax.numpy as jnp
    from repro.kernels.ops import bank_update_tree as jax_tree
    spec = SCATTER_SPECS[tree]
    rng = np.random.default_rng(22)
    r = 16                                   # N = 15 clients + the dummy
    rows, upd = _scatter_tree(rng, spec, r)
    ids, valid = _scatter_cohort(rng, r - 1, 13, r - 1)
    rows_j, ds_j = jax_tree(
        {k: jnp.asarray(v, spec[k][1]) for k, v in rows.items()},
        {k: jnp.asarray(v) for k, v in upd.items()},
        jnp.asarray(ids, jnp.int32), jnp.asarray(valid), interpret=True)
    before = {k: torch.from_numpy(v).to(TORCH_DT[spec[k][1]])
              for k, v in rows.items()}
    rows_t, ds_t = bank_update_tree(
        {k: v.clone() for k, v in before.items()},
        {k: torch.from_numpy(v) for k, v in upd.items()},
        torch.from_numpy(ids), torch.from_numpy(valid))
    _check_scatter_tree(spec, rows_t, ds_t, rows_j, ds_j, before)


@pytest.mark.parametrize("tree", sorted(SCATTER_SPECS))
def test_paged_bank_update_tree_mixed_matches_reference_tree(tree):
    """PAGE_TABLE's shuffled slots: 9 valid rows of the resident pages 4,
    0 and 3; pads at the dummy logical row and, for five slots, at rows of
    pages that are not resident."""
    import jax.numpy as jnp
    from repro.kernels.ops import paged_bank_update_tree as jax_tree
    spec = SCATTER_SPECS[tree]
    rng = np.random.default_rng(23)
    rows, upd = _scatter_tree(rng, spec, 4 * PS)
    for v in rows.values():
        v[3 * PS:] = 0.0                              # the dummy page
    resident = np.array([p * PS + i for p in (0, 3, 4) for i in range(PS)])
    lids, valid = _scatter_cohort(rng, resident, 9, DUMMY_LROW)
    lids[np.flatnonzero(~valid)[:5]] = [1 * PS, 2 * PS + 1, 5 * PS + 3,
                                        1 * PS + 2, 5 * PS]
    lids = lids.astype(np.int32)
    rows_j, ds_j = jax_tree(
        {k: jnp.asarray(v, spec[k][1]) for k, v in rows.items()},
        {k: jnp.asarray(v) for k, v in upd.items()},
        jnp.asarray(PAGE_TABLE), jnp.asarray(lids), jnp.asarray(valid),
        page_size=PS, interpret=True)
    before = {k: torch.from_numpy(v).to(TORCH_DT[spec[k][1]])
              for k, v in rows.items()}
    rows_t, ds_t = paged_bank_update_tree(
        {k: v.clone() for k, v in before.items()},
        {k: torch.from_numpy(v) for k, v in upd.items()},
        torch.from_numpy(PAGE_TABLE), torch.from_numpy(lids),
        torch.from_numpy(valid), page_size=PS)
    _check_scatter_tree(spec, rows_t, ds_t, rows_j, ds_j, before)
    for k in spec:
        assert not rows_t[k][3 * PS:].any()


def test_scatter_leaf_wrappers_check_every_leaf():
    r, c = 8, 4
    banks = [torch.zeros(r, 8), torch.zeros(r, 5)]
    upds = [torch.zeros(c, 8), torch.zeros(c, 5)]
    ids = torch.zeros(c, dtype=torch.int64)
    valid = torch.zeros(c, dtype=torch.bool)
    bad = {
        "same number": (banks, upds[:1], ids, valid),
        "at least one": ([], [], ids, valid),
        "updates must be float32": (banks, [upds[0], upds[1].double()],
                                    ids, valid),
        "bank must be float32 or bfloat16": (
            [banks[0], banks[1].half()], upds, ids, valid),
        r"bank \(R, M\)": ([banks[0], banks[1][None]], upds, ids, valid),
        "empty scatter": ([banks[0], torch.zeros(r, 0)],
                          [upds[0], torch.zeros(c, 0)], ids, valid),
        "shape mismatch: bank": (                          # R of one leaf
            [banks[0], torch.zeros(r + 1, 5)], upds, ids, valid),
        "shape mismatch: updates": (                       # C of one leaf
            banks, [upds[0], torch.zeros(c + 1, 5)], ids, valid),
        "shape mismatch: ids": (banks, upds, ids[1:], valid),
        "shape mismatch: valid": (banks, upds, ids, valid[None]),
        "ids must be int64": (banks, upds, ids.int(), valid)}
    for match, args in bad.items():
        with pytest.raises((TypeError, ValueError), match=match):
            bank_scatter_leaves(*args)
    pt, lids = torch.zeros(5, dtype=torch.int32), ids.int()
    for match, (pages, upd, table, lid, ps) in {
            "power of two": (banks, upds, pt, lids, 3),
            "multiple of page_size": (
                [torch.zeros(6, 8), torch.zeros(6, 5)], upds, pt, lids, 4),
            "shape mismatch: pages": (                     # R of one leaf
                [banks[0], torch.zeros(r + 2, 5)], upds, pt, lids, 2),
            r"page_table \(P,\)": (banks, upds, pt[None], lids, 2),
            "page_table must be int32": (banks, upds, pt.long(), lids, 2),
            "lids must be int32": (banks, upds, pt, ids, 2),
            "shape mismatch: lids": (banks, upds, pt, lids[1:], 2)}.items():
        with pytest.raises((TypeError, ValueError), match=match):
            paged_bank_scatter_leaves(pages, upd, table, lid, valid,
                                      page_size=ps)


# --------------------------------------------------------------------------- #
# the one-launch kernels against the per-leaf plain versions (needs a card)
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


MIFA_TREES = {
    "paper_mlp": [(m, "float32", "float32") for m in PAPER_MLP_WIDTHS],
    "mixed": [(128, "bfloat16", "float32"), (1000, "float32", "bfloat16"),
              (4096, "bfloat16", "bfloat16"), (10, "float32", "float32")],
    "ragged": [(10, "float32", "float32"), (1000, "bfloat16", "float32"),
               (7, "bfloat16", "bfloat16")],
    "one leaf": [(32768, "float32", "float32")],
    "split": [((j * 37) % 300 + 1, ("float32", "bfloat16")[j % 2],
               "float32") for j in range(70)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(MIFA_TREES))
@pytest.mark.parametrize("active", ["random", "none"])
def test_mifa_aggregate_leaves_cuda_matches_plain(cuda_device, tree, active):
    n, eta = 100, 0.07
    gen = torch.Generator(device="cuda").manual_seed(len(tree))
    act = (torch.rand(n, generator=gen, device="cuda") < 0.4
           if active == "random"
           else torch.zeros(n, dtype=torch.bool, device="cuda"))
    gs, us, ws = [], [], []
    for m, gdt, wdt in MIFA_TREES[tree]:
        gs.append(torch.randn((n, m), generator=gen, device="cuda").to(
            TORCH_DT[gdt]))
        us.append(torch.randn((n, m), generator=gen, device="cuda"))
        ws.append(torch.randn((m,), generator=gen, device="cuda").to(
            TORCH_DT[wdt]))
    before = mifa_aggregate.launches
    g_k, w_k = mifa_aggregate_leaves([g.clone() for g in gs], us, act, ws,
                                     eta)
    again = mifa_aggregate_leaves([g.clone() for g in gs], us, act, ws, eta)
    torch.cuda.synchronize()
    n_tables = -(-len(gs) // leaf_table.MAX_LEAVES)
    assert mifa_aggregate.launches == before + 2 * n_tables
    for g, u, w, gk, wk, g2, w2 in zip(gs, us, ws, g_k, w_k, *again):
        g_ref, w_ref = mifa_aggregate_ref(g, u, act, w, eta)
        assert torch.equal(gk, g_ref)
        rtol, atol = TOL[w.dtype]
        scale = w.float().abs() + eta * g_ref.float().abs().mean(0)
        assert bool(((wk.float() - w_ref.float()).abs()
                     <= atol + rtol * scale).all())
        # a repeated call is bit-identical: the sums run in a fixed order
        assert torch.equal(g2, gk) and torch.equal(w2, wk)


GATHER_TREES = {
    "paper_mlp": [(m, "float32") for m in PAPER_MLP_WIDTHS],
    "mixed": [(128, "bfloat16"), (1000, "float32"), (4096, "bfloat16"),
              (10, "float32")],
    "one leaf": [(1000, "bfloat16")],
    "split": [((j * 37) % 300 + 1, ("float32", "bfloat16")[j % 2])
              for j in range(70)],
}


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(GATHER_TREES))
@pytest.mark.parametrize("c", [64, 200])
def test_paged_bank_gather_leaves_cuda_matches_plain(cuda_device, tree, c):
    """16 of 32 logical pages of 8 rows resident in shuffled slots, the
    rest at the dummy slot; c slots: rows of resident pages, five rows of
    non-resident pages and pads at the dummy logical row. c=200 takes four
    chunks of the block's 64 rows."""
    rng = np.random.default_rng(c)
    ps, n_slots, lp = 8, 16, 32
    pt = np.full(lp + 1, n_slots, np.int32)
    res = rng.choice(lp, n_slots, replace=False)
    pt[res] = rng.permutation(n_slots)
    away = np.setdiff1d(np.arange(lp), res)
    lids = np.full(c, lp * ps, np.int32)
    res_rows = (res[:, None] * ps + np.arange(ps)).ravel()
    lids[:37] = rng.choice(res_rows, 37, replace=False)
    lids[37:42] = away[:5] * ps + 3
    lids[50:c:3] = rng.choice(res_rows, len(range(50, c, 3)))
    pt_t = torch.from_numpy(pt).to(cuda_device)
    lids_t = torch.from_numpy(lids).to(cuda_device)
    gen = torch.Generator(device="cuda").manual_seed(c)
    pages = []
    for m, dt in GATHER_TREES[tree]:
        p = torch.randn(((n_slots + 1) * ps, m), generator=gen,
                        device="cuda").to(TORCH_DT[dt])
        p[n_slots * ps:] = 0
        pages.append(p)
    before = paged_bank_gather.launches
    rows = paged_bank_gather_leaves(pages, pt_t, lids_t, page_size=ps)
    again = paged_bank_gather_leaves(pages, pt_t, lids_t, page_size=ps)
    torch.cuda.synchronize()
    n_tables = -(-len(pages) // leaf_table.MAX_LEAVES)
    assert paged_bank_gather.launches == before + 2 * n_tables
    for p, r, r2 in zip(pages, rows, again):
        assert r.is_contiguous() and r.data_ptr() % 16 == 0
        assert torch.equal(r, paged_bank_gather_ref(p, pt_t, lids_t,
                                                    page_size=ps))
        assert not r[37:42].any()
        assert torch.equal(r2, r)


FLEET_TREES = {
    "paper_mlp": [(m, "float32") for m in PAPER_MLP_WIDTHS],
    "mixed": [(128, "bfloat16"), (1000, "float32"), (4096, "bfloat16"),
              (10, "float32"), (153, "bfloat16")],
    "one leaf": [(32768, "float32")],
    "split": [((j * 37) % 300 + 1, ("float32", "bfloat16")[j % 2])
              for j in range(70)],
}


def _fleet_cuda_cohorts(rng, rows, dummy, c):
    """(K=3, c) slots on the card: 37, 20 and 0 distinct valid rows below
    `rows` in shuffled slots, pads at `dummy`."""
    ids = np.full((3, c), dummy, np.int64)
    valid = np.zeros((3, c), bool)
    for k, n_valid in enumerate((37, 20, 0)):
        at = rng.permutation(c)[:n_valid]
        ids[k, at] = rng.permutation(rows)[:n_valid]
        valid[k, at] = True
    return ids, valid


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(FLEET_TREES))
@pytest.mark.parametrize("c", [64, 600])
def test_bank_scatter_batched_leaves_cuda_matches_plain(cuda_device, tree,
                                                        c):
    """K=3 trials (the last only pads); c=600 takes two passes of the
    block's 512 staged slots. Per leaf equal to the plain version, per
    trial and leaf bit-equal to `bank_scatter`, a repeat bit-identical."""
    rng = np.random.default_rng(c)
    r = 101
    ids, valid = (torch.from_numpy(x).to(cuda_device)
                  for x in _fleet_cuda_cohorts(rng, r - 1, r - 1, c))
    gen = torch.Generator(device="cuda").manual_seed(c)
    banks = [torch.randn((3, r, m), generator=gen, device="cuda").to(
        TORCH_DT[dt]) for m, dt in FLEET_TREES[tree]]
    us = [torch.randn((3, c, m), generator=gen, device="cuda")
          for m, _ in FLEET_TREES[tree]]
    before = bank_scatter_batched.launches
    b_k, d_k = bank_scatter_batched_leaves([b.clone() for b in banks], us,
                                           ids, valid)
    b_2, d_2 = bank_scatter_batched_leaves([b.clone() for b in banks], us,
                                           ids, valid)
    torch.cuda.synchronize()
    n_tables = -(-len(banks) // leaf_table.MAX_LEAVES)
    assert bank_scatter_batched.launches == before + 2 * n_tables
    for b, u, bk, dk, b2, d2 in zip(banks, us, b_k, d_k, b_2, d_2):
        b_ref, d_ref = bank_scatter_batched_ref(b, u, ids, valid)
        assert torch.equal(bk, b_ref)
        for k in range(3):
            b1, d1 = bank_scatter(b[k].clone(), u[k], ids[k], valid[k])
            assert torch.equal(bk[k], b1) and torch.equal(dk[k], d1)
            assert torch.equal(dk[k], bank_scatter_ordered_ref(
                b[k], u[k], ids[k], valid[k])[1])
            terms = u[k].to(b.dtype).float() - b[k][ids[k]].float()
            scale = (terms.abs() * valid[k].reshape(-1, 1)).sum(0)
            assert bool(((dk[k] - d_ref[k]).abs()
                         <= 1e-6 + 1e-5 * scale).all())
        assert torch.equal(b2, bk) and torch.equal(d2, dk)
        assert not dk[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(FLEET_TREES))
def test_paged_bank_scatter_batched_leaves_cuda_matches_plain(cuda_device,
                                                              tree):
    """Per-trial shuffled tables, 16 of 32 logical pages of 8 rows resident
    in each; trials of 37, 20 and 0 valid rows. Per leaf equal to the plain
    version, per trial and leaf bit-equal to `paged_bank_scatter`, the
    dummy page untouched, a repeat bit-identical."""
    rng = np.random.default_rng(len(FLEET_TREES[tree]))
    ps, n_slots, lp, c = 8, 16, 32, 64
    pt = np.full((3, lp + 1), n_slots, np.int32)
    lids = np.full((3, c), lp * ps, np.int32)
    valid = np.zeros((3, c), bool)
    for k, n_valid in enumerate((37, 20, 0)):
        res = rng.choice(lp, n_slots, replace=False)
        pt[k, res] = rng.permutation(n_slots)
        res_rows = (res[:, None] * ps + np.arange(ps)).ravel()
        at = rng.permutation(c)[:n_valid]
        lids[k, at] = rng.choice(res_rows, n_valid, replace=False)
        valid[k, at] = True
    pt, lids, valid = (torch.from_numpy(x).to(cuda_device)
                       for x in (pt, lids, valid))
    gen = torch.Generator(device="cuda").manual_seed(c)
    pages, us = [], []
    for m, dt in FLEET_TREES[tree]:
        p = torch.randn((3, (n_slots + 1) * ps, m), generator=gen,
                        device="cuda").to(TORCH_DT[dt])
        p[:, n_slots * ps:] = 0
        pages.append(p)
        us.append(torch.randn((3, c, m), generator=gen, device="cuda"))
    before = paged_bank_scatter_batched.launches
    p_k, d_k = paged_bank_scatter_batched_leaves(
        [p.clone() for p in pages], us, pt, lids, valid, page_size=ps)
    p_2, d_2 = paged_bank_scatter_batched_leaves(
        [p.clone() for p in pages], us, pt, lids, valid, page_size=ps)
    torch.cuda.synchronize()
    n_tables = -(-len(pages) // leaf_table.MAX_LEAVES)
    assert paged_bank_scatter_batched.launches == before + 2 * n_tables
    for p, u, pk, dk, p2, d2 in zip(pages, us, p_k, d_k, p_2, d_2):
        p_ref, d_ref = paged_bank_scatter_batched_ref(p, u, pt, lids, valid,
                                                      page_size=ps)
        assert torch.equal(pk, p_ref)
        assert not pk[:, n_slots * ps:].any()
        for k in range(3):
            p1, d1 = paged_bank_scatter(p[k].clone(), u[k], pt[k], lids[k],
                                        valid[k], page_size=ps)
            assert torch.equal(pk[k], p1) and torch.equal(dk[k], d1)
            assert torch.equal(dk[k], paged_bank_scatter_ordered_ref(
                p[k], u[k], pt[k], lids[k], valid[k], page_size=ps)[1])
            old = paged_bank_gather_ref(p[k], pt[k], lids[k], page_size=ps)
            terms = (u[k].to(p.dtype).float() - old).abs()
            scale = (terms * valid[k].reshape(-1, 1)).sum(0)
            assert bool(((dk[k] - d_ref[k]).abs()
                         <= 1e-6 + 1e-5 * scale).all())
        assert torch.equal(p2, pk) and torch.equal(d2, dk)


# the single-trial scatters' trees: the fleet's and a ragged one
SCATTER_TREES = {**FLEET_TREES, "ragged": [(10, "float32"),
                                           (1000, "bfloat16"),
                                           (7, "bfloat16")]}


def _check_scatter_leaves(counted, stored, us, call, plain, ordered,
                          old_rows, valid):
    """`call` on clones of the stored leaves, twice: one launch per table
    of leaves; per leaf the rows bit-equal to the plain version's, dsum
    bit-equal to the fixed-order oracle and within rtol 1e-5 of the summed
    magnitudes of the plain version's, a repeat bit-identical. Returns the
    stored leaves after the first call."""
    before = counted.launches
    s_k, d_k = call([x.clone() for x in stored], us)
    s_2, d_2 = call([x.clone() for x in stored], us)
    torch.cuda.synchronize()
    n_tables = -(-len(stored) // leaf_table.MAX_LEAVES)
    assert counted.launches == before + 2 * n_tables
    for x, u, sk, dk, s2, d2 in zip(stored, us, s_k, d_k, s_2, d_2):
        x_ref, d_ref = plain(x, u)
        assert torch.equal(sk, x_ref)
        assert torch.equal(dk, ordered(x, u)[1])
        terms = (u.to(x.dtype).float() - old_rows(x)).abs()
        scale = (terms * valid.reshape(-1, 1)).sum(0)
        assert bool(((dk - d_ref).abs() <= 1e-6 + 1e-5 * scale).all())
        assert torch.equal(s2, sk) and torch.equal(d2, dk)
        if not valid.any():
            assert not dk.any() and torch.equal(sk, x)
    return s_k


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(SCATTER_TREES))
@pytest.mark.parametrize("n_valid,c", [(37, 64), (0, 64), (450, 600)])
def test_bank_scatter_leaves_cuda_matches_plain(cuda_device, tree, n_valid,
                                                c):
    """One bank of 501 rows (the last the dummy); n_valid distinct rows in
    shuffled slots of c, the rest pads; c=600 takes two passes of the
    block's 512 staged slots."""
    rng = np.random.default_rng(n_valid + c)
    r = 501
    ids = np.full(c, r - 1, np.int64)
    at = rng.permutation(c)[:n_valid]
    ids[at] = rng.permutation(r - 1)[:n_valid]
    ids = torch.from_numpy(ids).to(cuda_device)
    valid = torch.from_numpy(np.isin(np.arange(c), at)).to(cuda_device)
    gen = torch.Generator(device="cuda").manual_seed(c)
    banks = [torch.randn((r, m), generator=gen, device="cuda").to(
        TORCH_DT[dt]) for m, dt in SCATTER_TREES[tree]]
    us = [torch.randn((c, m), generator=gen, device="cuda")
          for m, _ in SCATTER_TREES[tree]]
    _check_scatter_leaves(
        bank_scatter, banks, us,
        lambda xs, ys: bank_scatter_leaves(xs, ys, ids, valid),
        lambda x, u: bank_scatter_ref(x, u, ids, valid),
        lambda x, u: bank_scatter_ordered_ref(x, u, ids, valid),
        lambda x: x[ids].float(), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("tree", sorted(SCATTER_TREES))
@pytest.mark.parametrize("n_valid", [37, 0])
def test_paged_bank_scatter_leaves_cuda_matches_plain(cuda_device, tree,
                                                      n_valid):
    """16 of 32 logical pages of 8 rows resident in shuffled slots, the
    rest at the dummy slot; n_valid rows of resident pages in shuffled
    slots of 64, five pads at rows of non-resident pages, the rest at the
    dummy logical row. The dummy page stays zero."""
    rng = np.random.default_rng(n_valid)
    ps, n_slots, lp, c = 8, 16, 32, 64
    pt = np.full(lp + 1, n_slots, np.int32)
    res = rng.choice(lp, n_slots, replace=False)
    pt[res] = rng.permutation(n_slots)
    away = np.setdiff1d(np.arange(lp), res)
    lids = np.full(c, lp * ps, np.int32)
    at = rng.permutation(c)
    lids[at[:n_valid]] = rng.choice(
        (res[:, None] * ps + np.arange(ps)).ravel(), n_valid, replace=False)
    lids[at[n_valid:n_valid + 5]] = away[:5] * ps + 3
    pt, lids = (torch.from_numpy(x).to(cuda_device) for x in (pt, lids))
    valid = torch.from_numpy(np.isin(np.arange(c), at[:n_valid])).to(
        cuda_device)
    gen = torch.Generator(device="cuda").manual_seed(n_valid)
    pages, us = [], []
    for m, dt in SCATTER_TREES[tree]:
        p = torch.randn(((n_slots + 1) * ps, m), generator=gen,
                        device="cuda").to(TORCH_DT[dt])
        p[n_slots * ps:] = 0
        pages.append(p)
        us.append(torch.randn((c, m), generator=gen, device="cuda"))
    out = _check_scatter_leaves(
        paged_bank_scatter, pages, us,
        lambda xs, ys: paged_bank_scatter_leaves(xs, ys, pt, lids, valid,
                                                 page_size=ps),
        lambda x, u: paged_bank_scatter_ref(x, u, pt, lids, valid,
                                            page_size=ps),
        lambda x, u: paged_bank_scatter_ordered_ref(x, u, pt, lids, valid,
                                                    page_size=ps),
        lambda x: paged_bank_gather_ref(x, pt, lids, page_size=ps), valid)
    for p in out:
        assert not p[n_slots * ps:].any()
