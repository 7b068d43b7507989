"""The leaf table and the two kernels that launch once per tree on it:
`mifa_aggregate_leaves` (through `ops.mifa_aggregate_tree`) and
`paged_bank_gather_leaves` (through `ops.paged_bank_gather_tree`).

On the CPU: the table's packing covers every column of every leaf exactly
once, through the kernel's own leaf search; the tree wrappers (plain
versions, leaf by leaf) against the JAX package's Pallas kernels in
interpret mode, with mixed f32/bf16 leaves and a shuffled page table.
Copied values (G, gathered rows) must match exactly; w within rtol 1e-5,
atol 1e-6 where it is f32 (the two packages sum in another order) and
within 1e-2 where it is bf16 (one bf16 rounding apart), as
`tests/test_torch_kernels.py` holds them.

The `cuda` tests hold the one-launch-per-tree kernels against the per-leaf
plain versions on the card, at the edges of the table: paper_mlp's six
widths, mixed dtypes, ragged widths, one leaf, nothing active, more leaves
than one table holds, non-resident pages, and a repeated call. They skip
without a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_leaf_table.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import leaf_table
from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                mifa_aggregate_leaves,
                                                mifa_aggregate_ref)
from repro_torch.kernels.ops import (mifa_aggregate_tree,
                                     paged_bank_gather_tree)
from repro_torch.kernels.paged_bank import (paged_bank_gather,
                                            paged_bank_gather_leaves,
                                            paged_bank_gather_ref)

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
