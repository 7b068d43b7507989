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

from repro_torch.kernels.bank_scatter import (ROW_GROUPS, bank_scatter,
                                              bank_scatter_batched,
                                              bank_scatter_batched_leaves,
                                              bank_scatter_batched_ref,
                                              bank_scatter_leaves,
                                              bank_scatter_ordered_ref,
                                              bank_scatter_ref)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                mifa_aggregate_ref)
from repro_torch.kernels.ops import bank_update_tree, mifa_aggregate_tree
from repro_torch.kernels.paged_bank import (paged_bank_gather,
                                            paged_bank_gather_ref,
                                            paged_bank_scatter,
                                            paged_bank_scatter_batched,
                                            paged_bank_scatter_batched_leaves,
                                            paged_bank_scatter_batched_ref,
                                            paged_bank_scatter_leaves,
                                            paged_bank_scatter_ordered_ref,
                                            paged_bank_scatter_ref)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
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


def _attention_inputs(b, s, h, kv, hd, dtype, seed, dv=None):
    """q (b,s,h,hd), k (b,s,kv,hd), v (b,s,kv,dv) (dv defaults to hd) as
    f32 numpy, already rounded to `dtype` (so both packages start from the
    same values)."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(b, s, n, w)).astype(np.float32)
           for n, w in ((h, hd), (kv, hd), (kv, dv or hd))]
    return [torch.from_numpy(x).to(TORCH_DT[dtype]).float().numpy()
            for x in out]


def _ssd_inputs(b, s, h, p, n, dtype, seed):
    """x (b,s,h,p), dA (b,s,h) = -softplus(normal), B, C (b,s,n) scaled by
    0.5, as `tests/test_kernels.py` draws them; x, B, C rounded to
    `dtype`, dA f32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dA = -np.logaddexp(0.0, rng.normal(size=(b, s, h))).astype(np.float32)
    B, C = ((0.5 * rng.normal(size=(b, s, n))).astype(np.float32)
            for _ in range(2))
    rnd = lambda a: torch.from_numpy(a).to(TORCH_DT[dtype]).float().numpy()  # noqa: E731
    return rnd(x), dA, rnd(B), rnd(C)


def _torch(arrays, dtype, device="cpu", keep_f32=()):
    """numpy f32 -> tensors in `dtype`, except the indices in keep_f32."""
    return [torch.from_numpy(a).to(device=device, dtype=torch.float32
                                   if i in keep_f32 else TORCH_DT[dtype])
            for i, a in enumerate(arrays)]


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


@pytest.mark.parametrize("m,bdt,c,n_valid", [
    (256, "float32", 24, 19),    # slots 0-18 valid, all eight row groups
    (384, "bfloat16", 24, 19),
    (10, "float32", 8, 5),       # fewer valid slots than row groups
    (128, "float32", 8, 0),      # only pad slots
])
def test_bank_scatter_ordered_ref_matches_plain_and_pallas(m, bdt, c,
                                                           n_valid):
    """The fixed-order oracle of the CUDA kernels' delta sum: rows equal to
    the plain version's and the Pallas kernel's, dsum within rtol 1e-5,
    atol 1e-6 of both (they sum in another order), and bit-equal to the
    order summed one f32 scalar at a time: row group a % 8 in increasing
    a from 0, then 0 + group 0 + ... + group 7."""
    import jax.numpy as jnp
    from repro.kernels.bank_scatter import bank_scatter as pallas
    bank, u, ids, valid = _bank_inputs(r=c + 1, m=m, c=c, n_valid=n_valid,
                                       seed=m + c)
    bank_t = torch.from_numpy(bank).to(TORCH_DT[bdt])
    args = (torch.from_numpy(u), torch.from_numpy(ids),
            torch.from_numpy(valid))
    b_o, d_o = bank_scatter_ordered_ref(bank_t, *args)
    b_p, d_p = bank_scatter_ref(bank_t, *args)
    b_j, d_j = pallas(jnp.asarray(bank, bdt), jnp.asarray(u),
                      jnp.asarray(ids, jnp.int32), jnp.asarray(valid),
                      block_m=128, interpret=True)
    assert b_o.dtype == TORCH_DT[bdt] and d_o.dtype == torch.float32
    assert torch.equal(b_o, b_p)
    np.testing.assert_array_equal(_f32(b_o), _f32(b_j))
    for ref in (d_p, d_j):
        np.testing.assert_allclose(_f32(d_o), _f32(ref), rtol=1e-5,
                                   atol=1e-6)
    terms = _f32(args[0].to(TORCH_DT[bdt]).float() - bank_t[args[1]].float())
    for col in (0, m - 1):
        acc = [np.float32(0)] * ROW_GROUPS
        for a in np.flatnonzero(valid):
            acc[a % ROW_GROUPS] = np.float32(acc[a % ROW_GROUPS]
                                              + terms[a, col])
        total = np.float32(0)
        for g in range(ROW_GROUPS):
            total = np.float32(total + acc[g])
        assert _f32(d_o)[col].tobytes() == total.tobytes()


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
                                    "paged_bank_scatter_batched",
                                    "bank_scatter_leaves",
                                    "paged_bank_scatter_leaves",
                                    "bank_scatter_batched_leaves",
                                    "paged_bank_scatter_batched_leaves",
                                    "flash_attention", "ssd_scan"])
def test_wrappers_take_no_device_but_cpu_and_cuda(kernel):
    """A tensor on another device neither takes the plain version nor
    reaches the kernel library: the wrapper raises before any build. A
    `_leaves` entry names the kernel it launches."""
    meta = lambda x: torch.from_numpy(x).to("meta")  # noqa: E731
    g, u, act, w = map(meta, _mifa_inputs(4, 8, True, 0))
    bank, upd, ids, valid = map(meta, _bank_inputs(4, 8, 3, 2, 0))
    pt, lids = torch.zeros(2, dtype=torch.int32), ids.int()
    # a second leaf of width 5 for the tree entries
    bank5, upd5 = (torch.empty((1, n, 5), device="meta") for n in (4, 3))
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
                valid[None], page_size=2),
            "bank_scatter_leaves": lambda: bank_scatter_leaves(
                [bank, bank5[0]], [upd, upd5[0]], ids, valid),
            "paged_bank_scatter_leaves": lambda: paged_bank_scatter_leaves(
                [bank, bank5[0]], [upd, upd5[0]], pt.to("meta"), lids, valid,
                page_size=2),
            "bank_scatter_batched_leaves": lambda: bank_scatter_batched_leaves(
                [bank[None], bank5], [upd[None], upd5], ids[None],
                valid[None]),
            "paged_bank_scatter_batched_leaves":
                lambda: paged_bank_scatter_batched_leaves(
                    [bank[None], bank5], [upd[None], upd5],
                    pt.to("meta")[None], lids[None], valid[None],
                    page_size=2),
            "flash_attention": lambda: flash_attention(
                *map(meta, _attention_inputs(1, 8, 4, 2, 16, "float32", 0))),
            "ssd_scan": lambda: ssd_scan(
                *map(meta, _ssd_inputs(1, 16, 2, 8, 8, "float32", 0)),
                chunk=8)}[kernel]
    with pytest.raises(ValueError, match=f"no {kernel.removesuffix('_leaves')}"
                                         " kernel for device"):
        call()


# flash attention and the SSD scan: plain versions against the Pallas kernels
# and the reference's oracles. Tolerances as `tests/test_kernels.py` holds
# the Pallas kernels to the oracles: 2e-5 (f32) and 2e-2 (bf16) for
# attention, 5e-5 and 5e-2 for the scan (its bf16 y is rounded once; its
# f32 state sums Q terms in another order).
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 5e-5, "bfloat16": 5e-2}


@pytest.mark.parametrize("s,h,kv,hd,block", [
    (128, 4, 4, 32, 64), (256, 4, 2, 64, 64), (128, 8, 1, 16, 64),
    (96, 4, 2, 112, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(s, h, kv, hd, block, causal,
                                              dtype):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as pallas
    from repro.kernels.ref import flash_attention_ref as oracle
    arrays = _attention_inputs(2, s, h, kv, hd, dtype, s + hd)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    out = flash_attention(*_torch(arrays, dtype), causal=causal)
    assert out.dtype == TORCH_DT[dtype] and out.shape == (2, s, h, hd)
    for ref in (pallas(jq, jk, jv, causal=causal, block_q=block,
                       block_k=block),
                oracle(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(_f32(out), _f32(np.asarray(ref,
                                                              np.float32)),
                                   atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("window", [1, 5, 16, 48, 100])
@pytest.mark.parametrize("hd", [32, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_window_matches_reference(window, hd, dtype):
    """The plain version's sliding window (gemma3's local layers) against
    the reference's windowed `blockwise_attention`, the function its
    prefill calls: GQA g=2, S=48, windows of one key, inside a block, of
    the whole sequence and past it; hd 32 (the smoke config) and 256
    (gemma3's). Both sides keep f32 scores; the reference rounds q·scale
    and the probabilities to bf16 in bf16, hence the bf16 bound."""
    import jax.numpy as jnp
    from repro.models.attention import blockwise_attention
    arrays = _attention_inputs(2, 48, 4, 2, hd, dtype, window + hd)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    out = flash_attention(*_torch(arrays, dtype), causal=True,
                          window=window)
    ref = blockwise_attention(jq, jk, jv, causal=True, window=window,
                              q_block=16)
    assert out.dtype == TORCH_DT[dtype] and out.shape == (2, 48, 4, hd)
    np.testing.assert_allclose(_f32(out), _f32(np.asarray(ref, np.float32)),
                               atol=ATTN_TOL[dtype])


# the reference's test shapes in both dtypes, and mamba2-1.3b's head dim
# and state (p=64, n=128) in f32: there |y| reaches 15, where one bf16
# step (2^-4) is above the 5e-2 bf16 tolerance against the f32 oracle
SSD_CASES = [(*shape, dt) for shape in [(64, 2, 8, 16, 16),
                                        (128, 3, 16, 32, 32),
                                        (96, 1, 32, 8, 32)]
             for dt in ("float32", "bfloat16")]
SSD_CASES.append((128, 2, 64, 128, 64, "float32"))


@pytest.mark.parametrize("s,h,p,n,chunk,dtype", SSD_CASES)
def test_ssd_plain_matches_pallas_and_oracles(s, h, p, n, chunk, dtype):
    import jax.numpy as jnp
    from repro.kernels.ref import ssd_scan_ref as oracle
    from repro.kernels.ssd_scan import ssd_scan as pallas
    from repro.models.ssm import ssd_chunked
    arrays = _ssd_inputs(2, s, h, p, n, dtype, s * h)
    jx, jdA, jB, jC = (jnp.asarray(a) for a in arrays)
    jx = jx.astype(dtype)
    y, hf = ssd_scan(*_torch(arrays, dtype, keep_f32=(1,)), chunk=chunk)
    assert y.dtype == TORCH_DT[dtype] and hf.dtype == torch.float32
    refs = [pallas(jx, jdA, jB, jC, chunk=chunk),
            ssd_chunked(jx, jdA, jB, jC, chunk),
            oracle(jx.astype(jnp.float32), jdA, jB, jC)]
    for yr, hr in refs:
        np.testing.assert_allclose(_f32(y), _f32(np.asarray(yr, np.float32)),
                                   atol=SSD_TOL[dtype])
        np.testing.assert_allclose(_f32(hf), _f32(np.asarray(hr)),
                                   atol=SSD_TOL[dtype])


def test_attention_and_ssd_reject_what_the_kernels_do_not_take():
    q, k, v = _torch(_attention_inputs(1, 8, 4, 2, 16, "float32", 0),
                     "float32")
    with pytest.raises(ValueError, match="causal attention needs S == T"):
        flash_attention(q, k[:, :4].contiguous(), v[:, :4].contiguous())
    flash_attention(q, k[:, :4].contiguous(), v[:, :4].contiguous(),
                    causal=False)
    with pytest.raises(ValueError, match="do not split"):
        flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                        v[..., :12].contiguous())
    wide = [x.repeat(1, 1, 1, 17) for x in (q, k, v)]  # hd 272 > 256
    with pytest.raises(ValueError, match="at most 256"):
        flash_attention(*wide)
    flash_attention(*[x[..., :256].contiguous() for x in wide])
    with pytest.raises(ValueError, match="only with causal=True"):
        flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="must be >= 0"):
        flash_attention(q, k, v, window=-1)
    with pytest.raises(TypeError, match="k must be float32"):
        flash_attention(q, k.bfloat16(), v)
    x, dA, B, C = _torch(_ssd_inputs(1, 16, 2, 8, 8, "float32", 0),
                         "float32")
    with pytest.raises(ValueError, match="chunk 6 must divide"):
        ssd_scan(x, dA, B, C, chunk=6)
    with pytest.raises(TypeError, match="dA must be float32"):
        ssd_scan(x, dA.double(), B, C, chunk=8)
    with pytest.raises(TypeError, match="B must be float32"):
        ssd_scan(x, dA, B.bfloat16(), C, chunk=8)


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
    assert torch.equal(d_k, bank_scatter_ordered_ref(bank, u, ids, valid)[1])
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
    assert torch.equal(d_k, paged_bank_scatter_ordered_ref(
        pages, u, pt, lids, valid, page_size=8)[1])
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


# flash attention and the SSD scan on the card, |err| <= atol + rtol·|ref|.
# Attention: f32 (2e-5, 0), the kernel's f32 FMAs and the plain einsum sum
# in other orders; bf16 (2e-2, 1e-2), the kernel rounds the probabilities
# to bf16 before P·V, as the TPU kernel does, where the plain version keeps
# f32, and that can move the bf16 output by one step, up to 2^-7 of |out|.
# The scan: |err| <= rtol · scale + 1e-6, scale being the plain version run
# on |x|, |B|, |C| (the summed magnitudes of the terms). The within-chunk
# cumsum of dA runs in another order on each side; at |cum| ~ 200 one f32
# step is 1.5e-5 and the two sums drift apart by up to about 1e-4, which
# exp(cum_i - cum_j) turns into a relative error of every term: f32 rtol
# 5e-4. bf16 y can land one bf16 step (up to 2^-7 of |y| <= scale) from
# the plain version's: rtol 1e-2.
CUDA_ATTN_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 1e-2)}
CUDA_SSD_RTOL = {"float32": 5e-4, "bfloat16": 1e-2}


def _ssd_scale(x, dA, B, C, chunk):
    """The plain scan over the magnitudes: bounds each output's summed
    |terms|."""
    return ssd_scan_ref(x.float().abs(), dA, B.float().abs(),
                        C.float().abs(), chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,hd,dv", [
    (2, 256, 4, 4, 32, 32), (2, 200, 8, 2, 112, 112), (1, 333, 4, 1, 128, 128),
    (4, 2048, 32, 32, 112, 112), (1, 512, 32, 8, 128, 128),
    (2, 64, 4, 4, 16, 16),
    # v narrower than q and k: MLA's prefill (hd 192 = 128 + 64, dv 128)
    (4, 2048, 16, 16, 192, 128), (2, 200, 8, 2, 176, 120)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_matches_plain(cuda_device, b, s, h, kv, hd,
                                            dv, causal, dtype):
    q, k, v = _torch(_attention_inputs(b, s, h, kv, hd, dtype, s + hd, dv),
                     dtype, cuda_device)
    ref = flash_attention_ref(q, k, v, causal=causal)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == (b, s, h, dv)
    atol, rtol = CUDA_ATTN_TOL[dtype]
    err = (out.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), \
        err.max().item()


# the edges of the bf16 kernel's tiling: blocks of 128 queries (two
# warpgroups of 64), 64-key tiles through a ring of 2 stages, the head dim
# in 64-column atoms and 16-wide slices; v's head dim dv (None: hd)
FLASH_EDGES = [  # b, s, t, h, kv, hd, causal[, dv]
    (2, 130, 130, 4, 4, 64, True),    # S not a multiple of the query tile
    (1, 127, 127, 4, 2, 112, True),   # one row short of it
    (2, 320, 320, 4, 4, 112, True),   # 5 key tiles, an odd count
    (1, 256, 256, 4, 4, 128, True),   # 4 key tiles, an even count
    (2, 40, 40, 4, 4, 128, True),     # S below one key tile
    (3, 1, 1, 2, 2, 16, True),        # one query, one key
    (2, 200, 200, 4, 4, 16, True),    # hd 16
    (2, 257, 257, 4, 4, 64, True),    # hd 64
    (2, 333, 333, 16, 4, 112, True),  # GQA g=4, hd 112
    (2, 300, 300, 8, 2, 128, True),   # GQA g=4, hd 128
    (2, 150, 389, 16, 4, 112, False),  # non-causal, T > S, ragged T
    (1, 260, 77, 4, 1, 128, False),   # non-causal, T < S
    (2, 40, 192, 8, 2, 64, False),    # non-causal, S below a key tile
    (2, 100, 100, 4, 4, 8, True),     # hd 8: one 16-wide slice, half zero
    (2, 100, 100, 4, 2, 24, True),    # hd 24, not a multiple of 16
    (1, 200, 200, 4, 4, 72, True),    # hd 72: a second 64-column atom
    (1, 150, 260, 4, 4, 120, False),  # hd 120, non-causal
    (2, 300, 300, 8, 4, 256, True),   # hd 256 (gemma3): four atoms
    (1, 150, 260, 4, 2, 256, False),  # hd 256, non-causal, ragged T
    (1, 200, 200, 4, 4, 192, True),   # hd 192: three atoms
    (2, 130, 130, 4, 4, 136, True),   # hd 136: a third atom, 8 columns
    (2, 1000, 1000, 4, 4, 192, True, 128),  # MLA's heads, ragged S
    (2, 300, 200, 4, 4, 192, False, 128),   # MLA's, non-causal, T < S
    (1, 40, 40, 4, 4, 192, True, 128),      # MLA's, S below a key tile
    (2, 130, 130, 4, 2, 136, True, 120)]    # dv 120: V's second atom part


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,kv,hd,causal,dv",
                         [e + (None,) * (8 - len(e)) for e in FLASH_EDGES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_tiling_edges(cuda_device, b, s, t, h, kv, hd,
                                           causal, dv, dtype):
    rng = np.random.default_rng(s * t + hd)
    dv = dv or hd
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(device=cuda_device, dtype=TORCH_DT[dtype])
               for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, dv)))
    ref = flash_attention_ref(q, k, v, causal=causal)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == (b, s, h, dv)
    atol, rtol = CUDA_ATTN_TOL[dtype]
    err = (out.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), \
        err.max().item()


@pytest.mark.cuda
def test_flash_attention_cuda_value_head_dims_without_an_instance(
        cuda_device):
    """In bf16 a (hd, dv) pair that no instance serves raises before any
    launch, naming what it serves; the f32 kernel takes any pair."""
    for hd, dv, window in ((128, 64, 0), (192, 128, 64), (256, 128, 0)):
        arrays = _attention_inputs(1, 128, 4, 4, hd, "float32", hd, dv)
        q, k, v = _torch(arrays, "bfloat16", cuda_device)
        before = flash_attention.launches
        with pytest.raises(ValueError, match="no bf16 flash_attention "
                                             "instance .* serves dv == hd"):
            flash_attention(q, k, v, window=window)
        assert flash_attention.launches == before
        q, k, v = _torch(arrays, "float32", cuda_device)
        ref = flash_attention_ref(q, k, v, window=window)
        out = flash_attention(q, k, v, window=window)
        assert out.shape == (1, 128, 4, dv)
        assert bool(((out - ref).abs() <= 2e-5).all())


# the sliding window on the card: gemma3's local layers (window 1024 at hd
# 256), windows that are not a multiple of the 64-key tile (100) and
# smaller than one (17, 1), where a row of a warpgroup can see whole tiles
# masked before its first valid key, and a window past S
FLASH_WINDOWS = [  # b, s, h, kv, hd, window
    (1, 2048, 8, 4, 256, 1024),
    (2, 700, 8, 4, 256, 100),
    (2, 333, 4, 2, 256, 17),
    (2, 300, 4, 4, 112, 1),
    (1, 500, 8, 2, 128, 64),
    (2, 257, 4, 4, 64, 130),
    (1, 100, 4, 2, 32, 400)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,hd,window", FLASH_WINDOWS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_cuda_window(cuda_device, b, s, h, kv, hd, window,
                                     dtype):
    rng = np.random.default_rng(s * window + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(device=cuda_device, dtype=TORCH_DT[dtype])
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    atol, rtol = CUDA_ATTN_TOL[dtype]
    err = (out.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), \
        err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 128, 3, 16, 32, 32), (2, 96, 1, 32, 8, 32), (1, 512, 4, 64, 64, 256),
    (1, 512, 4, 64, 128, 256), (2, 64, 2, 8, 16, 16), (1, 96, 2, 64, 64, 96),
    (4, 2048, 8, 64, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_cuda_matches_plain(cuda_device, b, s, h, p, n, chunk,
                                     dtype):
    x, dA, B, C = _torch(_ssd_inputs(b, s, h, p, n, dtype, s * h), dtype,
                         cuda_device, keep_f32=(1,))
    y_ref, h_ref = ssd_scan_ref(x, dA, B, C, chunk=chunk)
    before = ssd_scan.launches
    y, hf = ssd_scan(x, dA, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == x.dtype and hf.dtype == torch.float32
    y_scale, h_scale = _ssd_scale(x, dA, B, C, chunk)
    for got, ref, scale, rtol in ((y, y_ref, y_scale, CUDA_SSD_RTOL[dtype]),
                                  (hf, h_ref, h_scale, 5e-4)):
        err = (got.float() - ref.float()).abs()
        assert bool((err <= 1e-6 + rtol * scale).all()), \
            (err / scale).max().item()


# the edges of the bf16 kernel's tiling: chunks walked as 128-row query
# tiles (16 rows a warp) against 64-row key tiles, p and n padded to 32,
# 64 or 128, 16-byte copies only for p and n multiples of 8, one head a
# block. large_da draws dA = A·dt with zamba2's A = -112 and dt in [0.001,
# 0.1], so |cum| reaches the hundreds within a 64-row chunk.
SSD_EDGES = [  # b, s, h, p, n, chunk, large_da
    (2, 129, 3, 64, 64, 1, False),     # odd S: chunks of one row
    (2, 64, 4, 32, 16, 16, False),     # Q = 16, the smoke heads
    (2, 192, 4, 64, 64, 96, False),    # Q = 96: a partial key tile
    (1, 2048, 2, 64, 64, 1024, False),  # Q = 1024: 8 query tiles
    (2, 256, 3, 64, 128, 256, False),  # one chunk, S = Q
    (1, 130, 5, 8, 16, 65, False),     # p = 8, Q not a multiple of 16
    (2, 128, 3, 32, 128, 64, False),   # p = 32, n = 128
    (1, 256, 2, 112, 64, 128, False),  # p = 112: padded to 128
    (1, 256, 2, 128, 128, 128, False),  # p = n = 128, the largest
    (2, 96, 3, 24, 8, 48, False),      # p, n multiples of 8 but not 16
    (1, 64, 2, 5, 3, 16, False),       # p, n not multiples of 8
    (2, 256, 5, 64, 64, 64, True),     # zamba2's largest |dA|
    (1, 512, 3, 64, 128, 256, True)]   # |dA| large over a 256-row chunk


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk,large_da", SSD_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_cuda_tiling_edges(cuda_device, b, s, h, p, n, chunk,
                                    large_da, dtype):
    x, dA, B, C = _ssd_inputs(b, s, h, p, n, dtype, s * p + n)
    if large_da:
        rng = np.random.default_rng(s * h)
        dA = (-112.0 * rng.uniform(0.001, 0.1, size=(b, s, h))
              ).astype(np.float32)
    x, dA, B, C = _torch((x, dA, B, C), dtype, cuda_device, keep_f32=(1,))
    y_ref, h_ref = ssd_scan_ref(x, dA, B, C, chunk=chunk)
    before = ssd_scan.launches
    y, hf = ssd_scan(x, dA, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == x.dtype and hf.dtype == torch.float32
    assert y.shape == x.shape and hf.shape == (b, h, p, n)
    y_scale, h_scale = _ssd_scale(x, dA, B, C, chunk)
    for got, ref, scale, rtol in ((y, y_ref, y_scale, CUDA_SSD_RTOL[dtype]),
                                  (hf, h_ref, h_scale, 5e-4)):
        err = (got.float() - ref.float()).abs()
        assert bool((err <= 1e-6 + rtol * scale).all()), \
            (err / scale).max().item()
