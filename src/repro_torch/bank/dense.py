"""DenseBank — on-device rows; the exact-equivalence reference backend.

State layout (counterpart of `repro/bank/dense.py`):
    rows  : tree, leaves (N+1, *param_shape) `dtype` — row N is the dummy
            row that padded cohort slots point at.
    g_sum : tree, leaves (*param_shape,) f32 — running Σ_{i<N} rows[i].

`scatter_staged` (and `scatter`, which stages the host ids and calls it)
goes through `kernels.ops.bank_update_tree`: on the card the hand-written
`bank_scatter` kernel updates the cohort's rows of every leaf in place, in
one launch, and returns the delta sums; on the CPU its plain version does
the same work. The staged rows are the padded ids themselves (int64).
`gather` is plain tensor indexing, as in the reference (no kernel).
`scatter_fleet` (`scatter_fleet_staged`) takes stacked states (leaves
(K, N+1, ...) and (K, ...)) through `kernels.ops.fleet_bank_update_tree`: the batched kernel, one
launch for every leaf and all K trials, per trial bit-equal to
`bank_scatter`.
Mesh-sharded rows are not ported yet (ROADMAP Queue 1 item 19).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bank.base import MemoryBank, check_row_range, tree_nbytes
from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.ops import bank_update_tree, fleet_bank_update_tree
from repro_torch.tree import tree_leaves, tree_map


class DenseBank(MemoryBank):
    def __init__(self, *, dtype: str = "float32",
                 device: str | torch.device = DEFAULT_DEVICE):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported bank dtype {dtype!r}")
        self.dtype = getattr(torch, dtype)
        self.device = resolve_device(device)
        self.n = 0
        self.n_rows = 0

    def init(self, params, n_clients: int) -> dict:
        for p in tree_leaves(params):
            if p.device.type != self.device.type:
                raise ValueError(f"params on {p.device}, bank on "
                                 f"{self.device}: pass the run's device to "
                                 "DenseBank(device=...)")
        self.n = n_clients
        self.n_rows = n_clients + 1
        rows = tree_map(lambda p: torch.zeros(
            (self.n_rows,) + tuple(p.shape), dtype=self.dtype,
            device=p.device), params)
        g_sum = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        return {"rows": rows, "g_sum": g_sum}

    def gather(self, state: dict, ids):
        ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        return tree_map(lambda r: r[ids_t].float(), state["rows"])

    def stage_rows(self, ids: np.ndarray, valid: np.ndarray) -> np.ndarray:
        check_row_range(ids, valid, self.n, self.n_rows)
        return ids

    def scatter_staged(self, state: dict, rows: torch.Tensor,
                       valid: torch.Tensor, updates, *, rng=None) -> dict:
        new_rows, dsum = bank_update_tree(state["rows"], updates, rows,
                                          valid)
        g_sum = tree_map(torch.add, state["g_sum"], dsum)
        return {"rows": new_rows, "g_sum": g_sum}

    def scatter_fleet_staged(self, state: dict, rows: torch.Tensor,
                             valid: torch.Tensor, updates, *,
                             rng=None) -> dict:
        new_rows, dsum = fleet_bank_update_tree(state["rows"], updates, rows,
                                                valid)
        g_sum = tree_map(torch.add, state["g_sum"], dsum)
        return {"rows": new_rows, "g_sum": g_sum}

    def mean_g(self, state: dict):
        return tree_map(lambda g: g / self.n, state["g_sum"])

    def memory_bytes(self, state: dict) -> dict:
        return {"device": tree_nbytes(state["rows"])
                + tree_nbytes(state["g_sum"]), "host": 0}
