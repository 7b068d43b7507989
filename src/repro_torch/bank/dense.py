"""DenseBank — on-device rows; the exact-equivalence reference backend.

State layout (counterpart of `repro/bank/dense.py`):
    rows  : tree, leaves (N+1, *param_shape) `dtype` — row N is the dummy
            row that padded cohort slots point at.
    g_sum : tree, leaves (*param_shape,) f32 — running Σ_{i<N} rows[i].

`scatter` goes through `kernels.ops.bank_update_tree`: on the card the
hand-written `bank_scatter` kernel updates the cohort's rows of every leaf
in place, in one launch, and returns the delta sums; on the CPU its plain
version does the same work.
`gather` is plain tensor indexing, as in the reference (no kernel).
`scatter_fleet` takes stacked states (leaves (K, N+1, ...) and (K, ...))
through `kernels.ops.fleet_bank_update_tree`: the batched kernel, one
launch for every leaf and all K trials, per trial bit-equal to
`bank_scatter`.
Mesh-sharded rows are not ported yet (ROADMAP Queue 1 item 19).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bank.base import MemoryBank, tree_nbytes
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

    def _ids_on_device(self, ids, valid) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_rows):
            raise IndexError(f"bank row ids must lie in [0, {self.n_rows}), "
                             f"got [{ids.min()}, {ids.max()}]")
        valid = (np.ones(ids.shape, bool) if valid is None
                 else np.asarray(valid, bool))
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def _scatter_rows(self, state: dict, ids, updates, *, valid) -> dict:
        rows, dsum = bank_update_tree(state["rows"], updates,
                                      *self._ids_on_device(ids, valid))
        g_sum = tree_map(torch.add, state["g_sum"], dsum)
        return {"rows": rows, "g_sum": g_sum}

    def _scatter_fleet_rows(self, state: dict, ids, updates, *,
                            valid) -> dict:
        rows, dsum = fleet_bank_update_tree(state["rows"], updates,
                                            *self._ids_on_device(ids, valid))
        g_sum = tree_map(torch.add, state["g_sum"], dsum)
        return {"rows": rows, "g_sum": g_sum}

    def mean_g(self, state: dict):
        return tree_map(lambda g: g / self.n, state["g_sum"])

    def memory_bytes(self, state: dict) -> dict:
        return {"device": tree_nbytes(state["rows"])
                + tree_nbytes(state["g_sum"]), "host": 0}
