"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as `tests/test_kernels.py`
does. The same numpy inputs go to both. Selected and copied values (G, bank
rows) must match exactly; sums (w, delta sums) within rtol 1e-5, atol 1e-6
in fp32 (the two sum in another order) and 1e-2 for bf16 results.

The `cuda` tests hold the hand-written CUDA kernels against the plain
versions on the card. They skip without one. JAX is imported inside the
parity tests only, so the `cuda` tests also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bank_scatter import (bank_scatter,
                                              bank_scatter_batched,
                                              bank_scatter_batched_ref,
                                              bank_scatter_ref)
from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                mifa_aggregate_ref)
from repro_torch.kernels.ops import bank_update_tree, mifa_aggregate_tree
from repro_torch.kernels.paged_bank import (paged_bank_gather,
                                            paged_bank_gather_ref,
                                            paged_bank_scatter,
                                            paged_bank_scatter_batched,
                                            paged_bank_scatter_batched_ref,
                                            paged_bank_scatter_ref)
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

TOL = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 1e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(x):
    """Any tensor or array -> float32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _mifa_inputs(n, m, active, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, m)).astype(np.float32)
    u = rng.normal(size=(n, m)).astype(np.float32)
    w = rng.normal(size=(m,)).astype(np.float32)
    act = rng.random(n) < 0.5 if active == "random" else np.full(n, active)
    return g, u, act, w


def _bank_inputs(r, m, c, n_valid, seed):
    """Bank of r rows (the last is the dummy row); a cohort of c slots, the
    first n_valid distinct real rows, the rest pads at the dummy row."""
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(r, m)).astype(np.float32)
    u = rng.normal(size=(c, m)).astype(np.float32)
    ids = np.full(c, r - 1, np.int64)
    ids[:n_valid] = rng.permutation(r - 1)[:n_valid]
    valid = np.arange(c) < n_valid
    return bank, u, ids, valid


# --------------------------------------------------------------------------- #
# plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,m,gdt,wdt,active", [
    (8, 256, "float32", "float32", "random"),
    (16, 384, "bfloat16", "float32", "random"),
    (7, 128, "bfloat16", "bfloat16", "random"),
    (4, 128, "float32", "float32", False),
])
def test_mifa_aggregate_matches_pallas(n, m, gdt, wdt, active):
    import jax.numpy as jnp
    from repro.kernels.mifa_aggregate import mifa_aggregate as pallas
    g, u, act, w = _mifa_inputs(n, m, active, seed=n * m)
    eta = 0.07
    g_j, w_j = pallas(jnp.asarray(g, gdt), jnp.asarray(u), jnp.asarray(act),
                      jnp.asarray(w, wdt), eta, block_m=128, interpret=True)
    g_t, w_t = mifa_aggregate(torch.from_numpy(g).to(TORCH_DT[gdt]),
                              torch.from_numpy(u), torch.from_numpy(act),
                              torch.from_numpy(w).to(TORCH_DT[wdt]), eta)
    assert g_t.dtype == TORCH_DT[gdt] and w_t.dtype == TORCH_DT[wdt]
    np.testing.assert_array_equal(_f32(g_t), _f32(g_j))
    rtol, atol = TOL[wdt]
    np.testing.assert_allclose(_f32(w_t), _f32(w_j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("m,bdt,n_valid", [
    (256, "float32", 5),
    (384, "bfloat16", 6),
    (128, "float32", 0),         # only pad slots
])
def test_bank_scatter_matches_pallas(m, bdt, n_valid):
    import jax.numpy as jnp
    from repro.kernels.bank_scatter import bank_scatter as pallas
    bank, u, ids, valid = _bank_inputs(r=11, m=m, c=8, n_valid=n_valid,
                                       seed=m)
    b_j, d_j = pallas(jnp.asarray(bank, bdt), jnp.asarray(u),
                      jnp.asarray(ids, jnp.int32), jnp.asarray(valid),
                      block_m=128, interpret=True)
    b_t, d_t = bank_scatter(torch.from_numpy(bank).to(TORCH_DT[bdt]),
                            torch.from_numpy(u), torch.from_numpy(ids),
                            torch.from_numpy(valid))
    assert b_t.dtype == TORCH_DT[bdt] and d_t.dtype == torch.float32
    np.testing.assert_array_equal(_f32(b_t), _f32(b_j))
    np.testing.assert_allclose(_f32(d_t), _f32(d_j), rtol=1e-5, atol=1e-6)
    if n_valid == 0:
        np.testing.assert_array_equal(_f32(b_t), _f32(
            torch.from_numpy(bank).to(TORCH_DT[bdt])))
        assert not d_t.any()


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


def test_mifa_aggregate_tree_matches_reference_tree():
    """Ragged leaves: the reference pads them to the block, the port's
    kernel masks the edge itself."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ops import mifa_aggregate_tree as jax_tree
    n = 6
    params, g, u = _tree(0), _tree(1, (n,)), _tree(2, (n,))
    active = np.array([1, 0, 1, 1, 0, 1], bool)
    jt = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    g_j, p_j = jax_tree(jt(g), jt(u), jnp.asarray(active), jt(params), 0.1,
                        block_m=64, interpret=True)
    g_t, p_t = mifa_aggregate_tree(_to_torch(g), _to_torch(u),
                                   torch.from_numpy(active),
                                   _to_torch(params), 0.1)
    for a, b in zip(tree_leaves(g_t), jax.tree.leaves(g_j)):
        np.testing.assert_array_equal(_f32(a), _f32(b))
    for a, b in zip(tree_leaves(p_t), jax.tree.leaves(p_j)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5, atol=1e-6)


def test_bank_update_tree_matches_reference_tree():
    import jax
    import jax.numpy as jnp
    from repro.kernels.ops import bank_update_tree as jax_tree
    r, c = 9, 4
    rows, upd = _tree(3, (r,)), _tree(4, (c,))
    ids = np.array([2, 6, r - 1, r - 1], np.int64)
    valid = np.array([True, True, False, False])
    jt = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    rows_j, ds_j = jax_tree(jt(rows), jt(upd), jnp.asarray(ids, jnp.int32),
                            jnp.asarray(valid), interpret=True)
    rows_t, ds_t = bank_update_tree(_to_torch(rows), _to_torch(upd),
                                    torch.from_numpy(ids),
                                    torch.from_numpy(valid))
    for a, b in zip(tree_leaves(rows_t), jax.tree.leaves(rows_j)):
        np.testing.assert_array_equal(_f32(a), _f32(b))
    for a, b in zip(tree_leaves(ds_t), jax.tree.leaves(ds_j)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-5, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take():
    g, u, act, w = (torch.from_numpy(x) for x in _mifa_inputs(4, 8, True, 0))
    with pytest.raises(TypeError, match="updates must be float32"):
        mifa_aggregate(g, u.double(), act, w, 0.1)
    with pytest.raises(ValueError, match="shape mismatch"):
        mifa_aggregate(g, u, act[:3], w, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        mifa_aggregate(g.t().contiguous().t(), u, act, w, 0.1)
    bank, upd, ids, valid = (torch.from_numpy(x)
                             for x in _bank_inputs(5, 8, 3, 2, 0))
    with pytest.raises(TypeError, match="ids must be int64"):
        bank_scatter(bank, upd, ids.int(), valid)
    pt = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError, match="lids must be int32"):
        paged_bank_gather(bank[:4], pt, ids, page_size=2)
    with pytest.raises(ValueError, match="multiple of page_size"):
        paged_bank_gather(bank, pt, ids.int(), page_size=2)
    with pytest.raises(ValueError, match="power of two"):
        paged_bank_scatter(bank[:4], upd, pt, ids.int(), valid, page_size=3)


@pytest.mark.parametrize("kernel", ["mifa_aggregate", "bank_scatter",
                                    "paged_bank_scatter",
                                    "paged_bank_gather",
                                    "bank_scatter_batched",
                                    "paged_bank_scatter_batched"])
def test_wrappers_take_no_device_but_cpu_and_cuda(kernel):
    """A tensor on another device neither takes the plain version nor
    reaches the kernel library: the wrapper raises before any build."""
    meta = lambda x: torch.from_numpy(x).to("meta")  # noqa: E731
    g, u, act, w = map(meta, _mifa_inputs(4, 8, True, 0))
    bank, upd, ids, valid = map(meta, _bank_inputs(4, 8, 3, 2, 0))
    pt, lids = torch.zeros(2, dtype=torch.int32), ids.int()
    call = {"mifa_aggregate": lambda: mifa_aggregate(g, u, act, w, 0.1),
            "bank_scatter": lambda: bank_scatter(bank, upd, ids, valid),
            "paged_bank_scatter": lambda: paged_bank_scatter(
                bank, upd, pt.to("meta"), lids, valid, page_size=2),
            "paged_bank_gather": lambda: paged_bank_gather(
                bank, pt.to("meta"), lids, page_size=2),
            "bank_scatter_batched": lambda: bank_scatter_batched(
                bank[None], upd[None], ids[None], valid[None]),
            "paged_bank_scatter_batched": lambda: paged_bank_scatter_batched(
                bank[None], upd[None], pt.to("meta")[None], lids[None],
                valid[None], page_size=2)}[kernel]
    with pytest.raises(ValueError, match=f"no {kernel} kernel for device"):
        call()


# --------------------------------------------------------------------------- #
# the CUDA kernels against their plain versions (needs a card)
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,gdt,wdt", [(1000, "float32", "float32"),
                                       (4096, "bfloat16", "float32"),
                                       (10, "bfloat16", "bfloat16")])
def test_mifa_aggregate_cuda_matches_plain(cuda_device, m, gdt, wdt):
    g, u, act, w = (torch.from_numpy(x).to(cuda_device)
                    for x in _mifa_inputs(100, m, "random", m))
    g, w = g.to(TORCH_DT[gdt]), w.to(TORCH_DT[wdt])
    g_ref, w_ref = mifa_aggregate_ref(g, u, act, w, 0.07)
    before = mifa_aggregate.launches
    g_k, w_k = mifa_aggregate(g.clone(), u, act, w, 0.07)
    torch.cuda.synchronize()
    assert mifa_aggregate.launches == before + 1
    assert torch.equal(g_k, g_ref)
    rtol, atol = TOL[wdt]
    # the reordered f32 sum: tolerance relative to the summed magnitudes
    scale = w.float().abs() + 0.07 * g_ref.float().abs().mean(0)
    assert bool(((w_k.float() - w_ref.float()).abs()
                 <= atol + rtol * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,bdt,n_valid", [(1000, "float32", 37),
                                           (4096, "bfloat16", 37),
                                           (128, "float32", 0)])
def test_bank_scatter_cuda_matches_plain(cuda_device, m, bdt, n_valid):
    bank, u, ids, valid = (torch.from_numpy(x).to(cuda_device)
                           for x in _bank_inputs(101, m, 64, n_valid, m))
    bank = bank.to(TORCH_DT[bdt])
    b_ref, d_ref = bank_scatter_ref(bank, u, ids, valid)
    before = bank_scatter.launches
    b_k, d_k = bank_scatter(bank.clone(), u, ids, valid)
    torch.cuda.synchronize()
    assert bank_scatter.launches == before + 1
    assert torch.equal(b_k, b_ref)
    terms = (u.to(bank.dtype).float() - bank[ids].float()).abs()
    scale = (terms * valid.reshape(-1, 1)).sum(0)
    assert bool(((d_k - d_ref).abs() <= 1e-6 + 1e-5 * scale).all())


def _paged_inputs(m, n_valid, seed, ps=8, n_slots=16):
    """A pool of n_slots pages (+ the zero dummy page) holding 2·n_slots
    logical pages, the first n_slots of them resident in shuffled slots and
    the rest mapped to the dummy slot; a cohort of 64 slots, n_valid
    distinct rows of resident pages, then pads at the dummy logical row."""
    rng = np.random.default_rng(seed)
    pages = rng.normal(size=((n_slots + 1) * ps, m)).astype(np.float32)
    pages[n_slots * ps:] = 0.0
    lp = 2 * n_slots
    pt = np.full(lp + 1, n_slots, np.int32)
    pt[:n_slots] = rng.permutation(n_slots)
    u = rng.normal(size=(64, m)).astype(np.float32)
    lids = np.full(64, lp * ps, np.int32)
    lids[:n_valid] = rng.permutation(n_slots * ps)[:n_valid]
    return pages, u, pt, lids, np.arange(64) < n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("m,bdt,n_valid", [(1000, "float32", 37),
                                           (4096, "bfloat16", 37),
                                           (128, "float32", 0)])
def test_paged_bank_scatter_cuda_matches_plain(cuda_device, m, bdt, n_valid):
    pages, u, pt, lids, valid = (torch.from_numpy(x).to(cuda_device) for x in
                                 _paged_inputs(m, n_valid, m))
    pages = pages.to(TORCH_DT[bdt])
    p_ref, d_ref = paged_bank_scatter_ref(pages, u, pt, lids, valid,
                                          page_size=8)
    before = paged_bank_scatter.launches
    p_k, d_k = paged_bank_scatter(pages.clone(), u, pt, lids, valid,
                                  page_size=8)
    torch.cuda.synchronize()
    assert paged_bank_scatter.launches == before + 1
    assert torch.equal(p_k, p_ref)
    old = paged_bank_gather_ref(pages, pt, lids, page_size=8)
    terms = (u.to(pages.dtype).float() - old).abs()
    scale = (terms * valid.reshape(-1, 1)).sum(0)
    assert bool(((d_k - d_ref).abs() <= 1e-6 + 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,bdt", [(1000, "float32"), (4096, "bfloat16"),
                                   (10, "float32")])
def test_paged_bank_gather_cuda_matches_plain(cuda_device, m, bdt):
    pages, _, pt, lids, _ = (torch.from_numpy(x).to(cuda_device) for x in
                             _paged_inputs(m, 37, m))
    lids[40] = 20 * 8 + 3               # a row of a non-resident page
    pages = pages.to(TORCH_DT[bdt])
    before = paged_bank_gather.launches
    rows = paged_bank_gather(pages, pt, lids, page_size=8)
    torch.cuda.synchronize()
    assert paged_bank_gather.launches == before + 1
    assert torch.equal(rows, paged_bank_gather_ref(pages, pt, lids,
                                                   page_size=8))
    assert not rows[37:].any()


def _batched_bank_inputs(m, seed, k=3, r=101, c=64):
    """K stacked banks of r rows (the last is the dummy row) and a cohort
    of c slots per trial: 37, 20, ... distinct rows, the last trial only
    pads."""
    rng = np.random.default_rng(seed)
    banks = rng.normal(size=(k, r, m)).astype(np.float32)
    u = rng.normal(size=(k, c, m)).astype(np.float32)
    ids = np.full((k, c), r - 1, np.int64)
    valid = np.zeros((k, c), bool)
    for j, n_valid in enumerate([37, 20, 0][:k]):
        ids[j, :n_valid] = rng.permutation(r - 1)[:n_valid]
        valid[j, :n_valid] = True
    return banks, u, ids, valid


@pytest.mark.cuda
@pytest.mark.parametrize("m,bdt", [(1000, "float32"), (4096, "bfloat16"),
                                   (10, "float32")])
def test_bank_scatter_batched_cuda_matches_plain_and_single(cuda_device, m,
                                                            bdt):
    banks, u, ids, valid = (torch.from_numpy(x).to(cuda_device)
                            for x in _batched_bank_inputs(m, m))
    banks = banks.to(TORCH_DT[bdt])
    b_ref, d_ref = bank_scatter_batched_ref(banks, u, ids, valid)
    before = bank_scatter_batched.launches
    b_k, d_k = bank_scatter_batched(banks.clone(), u, ids, valid)
    torch.cuda.synchronize()
    assert bank_scatter_batched.launches == before + 1
    assert torch.equal(b_k, b_ref)
    for k in range(banks.shape[0]):
        # trial k through the single-trial kernel: bit-equal
        b1, d1 = bank_scatter(banks[k].clone(), u[k], ids[k], valid[k])
        assert torch.equal(b_k[k], b1) and torch.equal(d_k[k], d1)
        terms = (u[k].to(banks.dtype).float() - banks[k][ids[k]].float())
        scale = (terms.abs() * valid[k].reshape(-1, 1)).sum(0)
        assert bool(((d_k[k] - d_ref[k]).abs() <= 1e-6 + 1e-5 * scale).all())
    assert not d_k[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("m,bdt", [(1000, "float32"), (4096, "bfloat16")])
def test_paged_bank_scatter_batched_cuda_matches_plain_and_single(
        cuda_device, m, bdt):
    per_trial = [_paged_inputs(m, n_valid, m + j)
                 for j, n_valid in enumerate([37, 20, 0])]
    pages, u, pt, lids, valid = (
        torch.from_numpy(np.stack(x)).to(cuda_device)
        for x in zip(*per_trial))
    pages = pages.to(TORCH_DT[bdt])
    p_ref, d_ref = paged_bank_scatter_batched_ref(pages, u, pt, lids, valid,
                                                  page_size=8)
    before = paged_bank_scatter_batched.launches
    p_k, d_k = paged_bank_scatter_batched(pages.clone(), u, pt, lids, valid,
                                          page_size=8)
    torch.cuda.synchronize()
    assert paged_bank_scatter_batched.launches == before + 1
    assert torch.equal(p_k, p_ref)
    for k in range(pages.shape[0]):
        p1, d1 = paged_bank_scatter(pages[k].clone(), u[k], pt[k], lids[k],
                                    valid[k], page_size=8)
        assert torch.equal(p_k[k], p1) and torch.equal(d_k[k], d1)
        old = paged_bank_gather_ref(pages[k], pt[k], lids[k], page_size=8)
        terms = (u[k].to(pages.dtype).float() - old).abs()
        scale = (terms * valid[k].reshape(-1, 1)).sum(0)
        assert bool(((d_k[k] - d_ref[k]).abs() <= 1e-6 + 1e-5 * scale).all())
