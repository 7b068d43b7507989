"""Tree wrappers binding the kernels into the framework (counterpart of
`repro/kernels/ops.py`).

* `mifa_aggregate_tree` — the fused MIFA server step across a whole
  parameter tree: each leaf is flattened to (N, M), and the leaves go
  through `kernels.mifa_aggregate_leaves` together (one launch a tree).
* `bank_update_tree` — the fused cohort gather/delta/scatter over a
  memory-bank tree, each leaf flattened to (R, M) and (C, M), all leaves
  in one launch.
* `paged_bank_update_tree` / `paged_bank_gather_tree` — the same scatter,
  and the row gather, through a paged bank's page table
  (`kernels.paged_bank`), each taking all leaves in one launch.
* `fleet_bank_update_tree` / `fleet_paged_bank_update_tree` — the scatters
  for K stacked trials, each leaf flattened to (K, R, M) and (K, C, M),
  all leaves and trials in one launch.

Unlike the reference wrappers these pad nothing: the CUDA kernels mask the
ragged column edge themselves, so no leaf (and no bank) is copied. Flattening
a contiguous leaf is a view, so in-place kernel writes land in the leaf.

* `attention` / `ssd` — the model zoo's prefill attention and SSD scan
  (`kernels.flash_attention`, `kernels.ssd_scan`), the counterparts of the
  reference's `ops.attention` and `ops.ssd`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bank_scatter import (bank_scatter,
                                              bank_scatter_batched,
                                              bank_scatter_batched_leaves,
                                              bank_scatter_leaves)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mifa_aggregate import (mifa_aggregate,
                                                mifa_aggregate_leaves)
from repro_torch.kernels.paged_bank import (
    paged_bank_gather, paged_bank_gather_leaves, paged_bank_scatter,
    paged_bank_scatter_batched, paged_bank_scatter_batched_leaves,
    paged_bank_scatter_leaves)
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.tree import tree_map


def _leaves_in_map_order(tree, *rest) -> list:
    """The leaves of `tree` (zipped with those of `rest`) in the order
    `tree_map` visits them, so `_rebuild` can put results back."""
    out = []
    tree_map(lambda *xs: out.append(xs), tree, *rest)
    return out


def _rebuild(tree, values):
    """`tree`'s structure with its leaves replaced by `values`, given in
    `tree_map` order (a tree_map over `tree` and trees of its structure
    builds its output in `tree`'s key order)."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def mifa_aggregate_tree(g_tree, u_tree, active: torch.Tensor, params, eta):
    """Fused MIFA aggregation over a tree.

    g_tree / u_tree: leaves (N, *shape); params: leaves (*shape); eta a
    Python float or a 0-d f32 tensor on the params' device.
    Returns (new_g_tree, new_params); on the card the G leaves are updated
    in place.
    """
    leaves = _leaves_in_map_order(g_tree, u_tree, params)
    n = active.shape[0]
    gs, ws = mifa_aggregate_leaves(
        [g.reshape(n, -1) for g, _, _ in leaves],
        [u.reshape(n, -1) for _, u, _ in leaves], active,
        [w.reshape(-1) for _, _, w in leaves], eta)
    return (_rebuild(g_tree, [gn.reshape(g.shape)
                              for gn, (g, _, _) in zip(gs, leaves)]),
            _rebuild(g_tree, [wn.reshape(w.shape)
                              for wn, (_, _, w) in zip(ws, leaves)]))


def bank_update_tree(rows_tree, upd_tree, ids: torch.Tensor,
                     valid: torch.Tensor):
    """Fused cohort bank update over a tree.

    rows_tree: leaves (R, *shape); upd_tree: leaves (C, *shape) f32;
    ids (C,) int64 rows to update (pad slots -> dummy row); valid (C,) bool.
    Returns (new_rows_tree, delta_sum_tree with leaves (*shape,) f32); on
    the card one launch covers every leaf (up to 64), the rows are updated
    in place and the delta sums are views of one buffer.
    """
    leaves = _leaves_in_map_order(rows_tree, upd_tree)
    rows, dsums = bank_scatter_leaves(
        [b.reshape(b.shape[0], -1) for b, _ in leaves],
        [u.reshape(u.shape[0], -1) for _, u in leaves], ids, valid)
    return _scatter_rebuild(rows_tree, leaves, rows, dsums, 1)


def paged_bank_update_tree(pages_tree, upd_tree, page_table: torch.Tensor,
                           lids: torch.Tensor, valid: torch.Tensor, *,
                           page_size: int):
    """Fused cohort bank update through a page table.

    pages_tree: leaves (R, *shape), R = (slots+1)·page_size; upd_tree:
    leaves (C, *shape) f32; page_table (P,) int32; lids (C,) int32
    sanitized logical rows (pad slots -> dummy logical page); valid (C,)
    bool. Returns (new_pages_tree, delta_sum_tree with leaves (*shape,)
    f32); on the card one launch covers every leaf (up to 64), the pages
    are updated in place and the delta sums are views of one buffer.
    """
    leaves = _leaves_in_map_order(pages_tree, upd_tree)
    pages, dsums = paged_bank_scatter_leaves(
        [p.reshape(p.shape[0], -1) for p, _ in leaves],
        [u.reshape(u.shape[0], -1) for _, u in leaves], page_table, lids,
        valid, page_size=page_size)
    return _scatter_rebuild(pages_tree, leaves, pages, dsums, 1)


def paged_bank_gather_tree(pages_tree, page_table: torch.Tensor,
                           lids: torch.Tensor, *, page_size: int):
    """Row gather through the page table over a tree: leaves (C, *shape)
    f32 for the logical rows `lids` (int32, sanitized); rows of pages that
    are not resident read the dummy page's zeros. On the card one launch
    covers every leaf (up to 64), and the leaves are views of one buffer."""
    leaves = [p for (p,) in _leaves_in_map_order(pages_tree)]
    rows = paged_bank_gather_leaves(
        [p.reshape(p.shape[0], -1) for p in leaves], page_table, lids,
        page_size=page_size)
    return _rebuild(pages_tree, [r.view((lids.shape[0],) + p.shape[1:])
                                 for r, p in zip(rows, leaves)])


def fleet_bank_update_tree(rows_tree, upd_tree, ids: torch.Tensor,
                           valid: torch.Tensor):
    """Fused cohort bank update for K stacked trials over a tree.

    rows_tree: leaves (K, R, *shape); upd_tree: leaves (K, C, *shape) f32;
    ids (K, C) int64; valid (K, C) bool. Returns (new_rows_tree,
    delta_sum_tree with leaves (K, *shape) f32), per trial what
    `bank_update_tree` returns; on the card one launch covers every leaf
    (up to 64) and all K trials, and the rows are updated in place.
    """
    leaves = _leaves_in_map_order(rows_tree, upd_tree)
    rows, dsums = bank_scatter_batched_leaves(
        [b.reshape(b.shape[0], b.shape[1], -1) for b, _ in leaves],
        [u.reshape(u.shape[0], u.shape[1], -1) for _, u in leaves], ids,
        valid)
    return _scatter_rebuild(rows_tree, leaves, rows, dsums, 2)


def fleet_paged_bank_update_tree(pages_tree, upd_tree,
                                 page_table: torch.Tensor, lids: torch.Tensor,
                                 valid: torch.Tensor, *, page_size: int):
    """Fused cohort bank update through the page tables of K stacked
    trials: pages leaves (K, R, *shape); upd leaves (K, C, *shape) f32;
    page_table (K, P) int32; lids (K, C) int32 sanitized logical rows;
    valid (K, C) bool. Returns (new_pages_tree, delta_sum_tree with leaves
    (K, *shape) f32); on the card one launch covers every leaf (up to 64)
    and all K trials, and the pages are updated in place."""
    leaves = _leaves_in_map_order(pages_tree, upd_tree)
    pages, dsums = paged_bank_scatter_batched_leaves(
        [p.reshape(p.shape[0], p.shape[1], -1) for p, _ in leaves],
        [u.reshape(u.shape[0], u.shape[1], -1) for _, u in leaves],
        page_table, lids, valid, page_size=page_size)
    return _scatter_rebuild(pages_tree, leaves, pages, dsums, 2)


def _scatter_rebuild(tree, leaves, stored, dsums, row_axis: int):
    """The scatters' outputs as trees of `tree`'s structure: each leaf's
    stored rows in its own shape, its delta sum without the row axis: leaf
    shape (R, *shape) -> (*shape,) with row_axis 1, (K, R, *shape) ->
    (K, *shape) with row_axis 2."""
    return (_rebuild(tree, [s.reshape(b.shape)
                            for s, (b, _) in zip(stored, leaves)]),
            _rebuild(tree, [d.reshape(b.shape[:row_axis - 1]
                                      + b.shape[row_axis:])
                            for d, (b, _) in zip(dsums, leaves)]))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention: q (B,S,H,hd), k (B,T,KV,hd), v (B,T,KV,dv) ->
    (B,S,H,dv); `window` > 0 (causal only) keeps each query's last
    `window` keys."""
    return flash_attention(q, k, v, causal=causal, window=window)


def ssd(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        *, chunk: int = 256):
    """Chunked SSD scan: x (b,S,h,p), dA (b,S,h), B, C (b,S,n), S % chunk
    == 0 -> (y (b,S,h,p), h_final (b,h,p,n) f32)."""
    return ssd_scan(x, dA, B, C, chunk=chunk)


def launch_counters() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches
    in its `launches` attribute."""
    return {"mifa_aggregate": mifa_aggregate, "bank_scatter": bank_scatter,
            "paged_bank_scatter": paged_bank_scatter,
            "paged_bank_gather": paged_bank_gather,
            "bank_scatter_batched": bank_scatter_batched,
            "paged_bank_scatter_batched": paged_bank_scatter_batched,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan}


def model_kernel_launches() -> dict:
    """Launch counts of the model zoo's kernels, by name."""
    return {"flash_attention": flash_attention.launches,
            "ssd_scan": ssd_scan.launches}
