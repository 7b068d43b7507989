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

With `mesh` (and `cfg`) the rows are laid out by `sharding.rules.
bank_row_specs`: the client axis over the mesh's data (and pod) axes, as
the dense MIFA update array. The row count pads to
`sharding.rules.padded_bank_rows(N, mesh)` so the client axis divides the
data extent, and at data extent D > 1 each rank holds its block of R / D
rows of every leaf (`shard`, a `sharding.clients.ClientShard`). A scatter
then takes the cohort's slots whose rows this rank owns (the others' are
left out of its call), and the delta sums are all-reduced over the data
group, so G_sum is whole on every rank; `gather` all-reduces the rows it
reads. At data extent 1 the bank is the mesh-less one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bank.base import MemoryBank, check_row_range, tree_nbytes
from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.ops import bank_update_tree, fleet_bank_update_tree
from repro_torch.sharding.clients import check_params_whole, client_shard
from repro_torch.sharding.rules import P, bank_row_specs, padded_bank_rows
from repro_torch.tree import tree_leaves, tree_map


class DenseBank(MemoryBank):
    def __init__(self, *, dtype: str = "float32", mesh=None, cfg=None,
                 device: str | torch.device = DEFAULT_DEVICE):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported bank dtype {dtype!r}")
        self.dtype = getattr(torch, dtype)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.shard = None
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
        self.shard = None
        local = self.n_rows
        if self.mesh is not None:
            self.n_rows = padded_bank_rows(n_clients, self.mesh)
            specs = bank_row_specs(params, self.cfg, self.mesh, self.n_rows)
            check_params_whole(tree_map(lambda s: P(*s[1:]), specs),
                               self.mesh, "DenseBank rows")
            self.shard = client_shard(self.mesh, self.n_rows, self.device,
                                      what="DenseBank rows")
            local = (self.n_rows if self.shard is None
                     else self.shard.hi - self.shard.lo)
        rows = tree_map(lambda p: torch.zeros(
            (local,) + tuple(p.shape), dtype=self.dtype,
            device=p.device), params)
        g_sum = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        return {"rows": rows, "g_sum": g_sum}

    def gather(self, state: dict, ids):
        ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        if self.shard is None:
            return tree_map(lambda r: r[ids_t].float(), state["rows"])
        lo, hi = self.shard.lo, self.shard.hi
        own = (ids_t >= lo) & (ids_t < hi)

        def read(r):
            out = torch.zeros((len(ids_t),) + tuple(r.shape[1:]),
                              dtype=torch.float32, device=r.device)
            out[own] = r[ids_t[own] - lo].float()
            return self.shard.reduce_(out)
        return tree_map(read, state["rows"])

    def stage_rows(self, ids: np.ndarray, valid: np.ndarray) -> np.ndarray:
        check_row_range(ids, valid, self.n, self.n_rows)
        return ids

    def scatter_staged(self, state: dict, rows: torch.Tensor,
                       valid: torch.Tensor, updates, *, rng=None) -> dict:
        if self.shard is None:
            new_rows, dsum = bank_update_tree(state["rows"], updates, rows,
                                              valid)
        else:
            new_rows, dsum = self._scatter_block(state["rows"], rows, valid,
                                                 updates)
        g_sum = tree_map(torch.add, state["g_sum"], dsum)
        return {"rows": new_rows, "g_sum": g_sum}

    def _scatter_block(self, bank_rows, rows, valid, updates):
        """The scatter on this rank's block: the valid slots whose rows
        it owns, their delta sums all-reduced over the data group."""
        lo, hi = self.shard.lo, self.shard.hi
        mine = torch.nonzero(valid & (rows >= lo) & (rows < hi)).flatten()
        if len(mine):
            bank_rows, dsum = bank_update_tree(
                bank_rows, tree_map(lambda u: u[mine], updates),
                rows[mine] - lo, valid[mine])
        else:
            dsum = tree_map(lambda r: torch.zeros(
                r.shape[1:], dtype=torch.float32, device=r.device),
                bank_rows)
        return bank_rows, tree_map(self.shard.reduce_, dsum)

    def scatter_fleet_staged(self, state: dict, rows: torch.Tensor,
                             valid: torch.Tensor, updates, *,
                             rng=None) -> dict:
        if self.shard is not None:
            raise ValueError("a fleet splits its trial axis over a mesh, "
                             "not its banks' rows: build the fleet's "
                             "DenseBank without mesh=")
        new_rows, dsum = fleet_bank_update_tree(state["rows"], updates, rows,
                                                valid)
        g_sum = tree_map(torch.add, state["g_sum"], dsum)
        return {"rows": new_rows, "g_sum": g_sum}

    def mean_g(self, state: dict):
        return tree_map(lambda g: g / self.n, state["g_sum"])

    def memory_bytes(self, state: dict) -> dict:
        return {"device": tree_nbytes(state["rows"])
                + tree_nbytes(state["g_sum"]), "host": 0}
