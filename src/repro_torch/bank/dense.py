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

With `mesh` (and `cfg`) the bank is placed over the mesh's axes
(`sharding.params`): the rows by `sharding.rules.bank_row_specs` (the
client axis over the data (and pod) axes, as the dense MIFA update array,
and the param dims by the model rules), G_sum by the rows' param dims
(`cfg`, `sum_specs`: the layout the scatter's delta sums come out in, so a
round adds them where they are and the round body moves the mean to the
params' placement; a bank without `cfg` keeps G_sum whole, as the
reference's is unplaced). The row count pads to
`sharding.rules.padded_bank_rows(N, mesh)` so the client axis divides the
data extent, and at data extent D > 1 each rank holds its block of R / D
rows (`shard`, a `sharding.clients.ClientShard`). `scatter_staged` takes
the cohort's updates already in the rows' column blocks (`update_specs`:
the round moves them there from the params' blocks under split products,
`sharding.params.StepPlacement`, or cuts whole columns with `cols`;
`scatter` takes whole columns and cuts them) and the slots whose rows
this rank owns (the others' are left out of its call); the delta sums are
all-reduced over the data group and taken to G_sum's placement. On a
DeviceMesh of CUDA ranks (model extent > 1, data extent 1) the rows are
CUDA blocks and `bank_scatter` runs on each rank's blocks. `gather`
returns the rank's column block of the rows it reads, all-reduced over
the data group. `gather_state` and `place_state` turn the rank's blocks
into the whole state of an unsplit bank (N + 1 rows) and back, for a run
snapshot. At extent 1 the bank is the mesh-less one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bank.base import MemoryBank, check_row_range, tree_nbytes
from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.ops import bank_update_tree, fleet_bank_update_tree
from repro_torch.sharding.clients import client_shard
from repro_torch.sharding.params import (block, block_shape, relayout,
                                         take_tree, whole_tree)
from repro_torch.sharding.rules import (P, bank_row_specs, padded_bank_rows,
                                        sharded_axes)
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
        self.row_specs = self.sum_specs = self.update_specs = None
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
        # without a mesh every leaf is whole: P() places nothing
        whole = tree_map(lambda p: P(), params)
        self.row_specs = self.sum_specs = whole
        if self.mesh is not None:
            self.n_rows = padded_bank_rows(n_clients, self.mesh)
            self.row_specs = bank_row_specs(params, self.cfg, self.mesh,
                                            self.n_rows)
            if self.cfg is not None:
                self.sum_specs = tree_map(lambda s: P(*s[1:]),
                                          self.row_specs)
            self.shard = client_shard(self.mesh, self.n_rows, self.device,
                                      what="DenseBank rows")
            self.update_specs = tree_map(lambda s: P(None, *s[1:]),
                                         self.row_specs)

        def zeros(shape, spec, dtype, what):
            if self.mesh is not None:
                shape = block_shape(shape, spec, self.mesh, self.device,
                                    f"DenseBank {what}", split=True)
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return {"rows": tree_map(lambda p, s: zeros(
                    (self.n_rows,) + tuple(p.shape), s, self.dtype, "rows"),
                    params, self.row_specs),
                "g_sum": tree_map(lambda p, s: zeros(
                    tuple(p.shape), s, torch.float32, "G_sum"),
                    params, self.sum_specs)}

    def place_state(self, state: dict) -> dict:
        """This rank's blocks of an unsplit bank's whole state (N + 1 rows,
        as `gather_state` gives it)."""
        if self.mesh is None:
            return state
        pad = self.n_rows - (self.n + 1)
        rows = tree_map(lambda r: torch.cat([r, r.new_zeros(
            (pad,) + tuple(r.shape[1:]))]) if pad else r, state["rows"])
        return {"rows": take_tree(rows, self.row_specs, self.mesh,
                                  "DenseBank rows", split=True),
                "g_sum": take_tree(state["g_sum"], self.sum_specs,
                                   self.mesh, "DenseBank G_sum", split=True)}

    def gather_state(self, state: dict) -> dict:
        """The whole state of an unsplit bank (N + 1 rows: the padding
        rows beyond the dummy row are never written) from every rank's
        blocks."""
        if self.mesh is None:
            return state
        rows = whole_tree(state["rows"], self.row_specs, self.mesh,
                          "DenseBank rows", split=True)
        return {**state,
                "rows": tree_map(lambda r: r[:self.n + 1], rows),
                "g_sum": whole_tree(state["g_sum"], self.sum_specs,
                                    self.mesh, "DenseBank G_sum",
                                    split=True)}

    def cols(self, updates):
        """The rows' column block (`update_specs`) of whole-column updates
        (C, ...)."""
        if self.mesh is None:
            return updates
        return tree_map(lambda u, s: block(u, s, self.mesh,
                                           "DenseBank updates").contiguous(),
                        updates, self.update_specs)

    def update_dtypes(self, state: dict):
        """The rows: an update moves to its rows' blocks in their dtype,
        to which the scatter rounds it first anyway."""
        return state["rows"]

    def _scatter_rows(self, state: dict, ids, updates, *, valid,
                      rng=None) -> dict:
        """`scatter`'s body: whole-column updates cut to the rows' column
        blocks, then staged."""
        return super()._scatter_rows(state, ids, self.cols(updates),
                                     valid=valid, rng=rng)

    def _to_sum(self, dsum):
        """Delta sums in the rows' column layout -> G_sum's placement."""
        if self.mesh is None:
            return dsum
        return tree_map(lambda d, s, g: relayout(d, P(*s[1:]), g, self.mesh,
                                                 split=True),
                        dsum, self.row_specs, self.sum_specs)

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
        g_sum = tree_map(torch.add, state["g_sum"], self._to_sum(dsum))
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
        if self.mesh is not None and sharded_axes(
                [self.row_specs, self.sum_specs], self.mesh):
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
