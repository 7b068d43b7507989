"""Tree wrappers binding the kernels into the framework (counterpart of
`repro/kernels/ops.py`).

* `mifa_aggregate_tree` — the fused MIFA server step across a whole
  parameter tree: each leaf is flattened to (N, M) and goes through
  `kernels.mifa_aggregate`.
* `bank_update_tree` — the fused cohort gather/delta/scatter over a
  memory-bank tree, each leaf flattened to (R, M) and (C, M).

Unlike the reference wrappers these pad nothing: the CUDA kernels mask the
ragged column edge themselves, so no leaf (and no bank) is copied. Flattening
a contiguous leaf is a view, so in-place kernel writes land in the leaf. The
attention, SSD, paged and fleet wrappers wait for their kernels (ROADMAP
Queue 2 items 3-8).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bank_scatter import bank_scatter
from repro_torch.kernels.mifa_aggregate import mifa_aggregate
from repro_torch.tree import tree_map, tree_unzip2


def mifa_aggregate_tree(g_tree, u_tree, active: torch.Tensor, params,
                        eta: float):
    """Fused MIFA aggregation over a tree.

    g_tree / u_tree: leaves (N, *shape); params: leaves (*shape).
    Returns (new_g_tree, new_params); on the card the G leaves are updated
    in place.
    """
    def one(g, u, w):
        n = g.shape[0]
        gn, wn = mifa_aggregate(g.reshape(n, -1), u.reshape(n, -1), active,
                                w.reshape(-1), eta)
        return gn.reshape(g.shape), wn.reshape(w.shape)

    return tree_unzip2(tree_map(one, g_tree, u_tree, params))


def bank_update_tree(rows_tree, upd_tree, ids: torch.Tensor,
                     valid: torch.Tensor):
    """Fused cohort bank update over a tree.

    rows_tree: leaves (R, *shape); upd_tree: leaves (C, *shape) f32;
    ids (C,) int64 rows to update (pad slots -> dummy row); valid (C,) bool.
    Returns (new_rows_tree, delta_sum_tree with leaves (*shape,) f32); on
    the card the rows are updated in place.
    """
    def one(rows, u):
        rn, ds = bank_scatter(rows.reshape(rows.shape[0], -1),
                              u.reshape(u.shape[0], -1), ids, valid)
        return rn.reshape(rows.shape), ds.reshape(rows.shape[1:])

    return tree_unzip2(tree_map(one, rows_tree, upd_tree))
