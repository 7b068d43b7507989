"""MemoryBank — sparse server memory for cohort-sized MIFA rounds.

MIFA's server state is one row per client: G^i, the client's latest K-step
update. A MemoryBank exposes it through row-sparse access so a round touches
only the active cohort A(t):

    scatter(state, ids, updates)  -> new state with those rows replaced

and maintains the running sum  G_sum = Σ_i G^i  incrementally via the delta
identity  G_sum += Σ_{a ∈ A} (u_a − G_old_a), so the server step's
mean_G = G_sum / N is O(d). Counterpart of `repro/bank/base.py`; the ported
backends are `DenseBank`, `PagedDeviceBank` (which pages rows on and off
the card in `prepare`; f32, bf16 or int8 pages) and the host banks
`HostBank` (f32 rows in pinned host memory) and `Int8PagedBank`. The
device banks run fleets: `scatter_fleet` and `gather_fleet` take states
whose leaves carry a leading trial axis (K, ...). `host_state` /
`load_host_state` carry a bank's host bookkeeping through a run snapshot
(`checkpoint.run_state`).

Two ways in. `scatter(state, ids, updates, valid=, rng=)` takes host
numpy ids, checks them and does any host work (paging). A round that runs
on the device (and may be captured as a CUDA graph) instead stages its
cohort on the host first, `stage_rows(ids, valid)` (range checks, the
row index the kernels take), and hands the staged tensors to
`scatter_staged(state, rows, valid, updates, rng=)`, which reads nothing
back to the host for the device banks. `rng` feeds the int8 banks'
stochastic rounding: `round_rng` says which of the run's round generators
a bank takes ("cpu" or "device"); the float banks ignore it.

Padding convention: the round loop pads a cohort to a fixed capacity. Pad slots
carry `valid=False` and point `ids` at the dummy row index N; they never
touch G_sum or any real row.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_index, tree_leaves, tree_stack


class MemoryBank:
    """Interface; `scatter` and `scatter_fleet` are template methods that
    enforce the duplicate-id invariant (`check_unique_ids`, per trial for
    the fleet) for every backend before they delegate to the backend's
    `_scatter_rows` / `_scatter_fleet_rows`, which by default stage the
    cohort and call `scatter_staged` / `scatter_fleet_staged`."""

    # the generator `scatter(rng=)` takes ("cpu" or "device"); whether the
    # rows live on the device, where a captured round can scatter them
    round_rng = "cpu"
    on_device = True
    device: torch.device
    # the column layout `scatter_staged` takes its updates in (a tree of
    # PartitionSpecs; None: whole columns)
    update_specs = None

    def cols(self, updates: Any) -> Any:
        """Whole-column updates in the layout `scatter_staged` takes (the
        identity for a bank that holds its rows' columns whole)."""
        return updates

    def update_dtypes(self, state: dict) -> Any:
        """A tree of tensors whose dtypes an update may move in before
        `scatter_staged` without changing what it stores, or None (f32:
        the int8 pages quantize from it)."""
        return None

    def init(self, params: Any, n_clients: int) -> dict:
        """Zero-filled bank state for `n_clients` rows shaped like `params`."""
        raise NotImplementedError

    def gather(self, state: dict, ids) -> Any:
        """Read rows `ids` (C,) (host numpy) out of the bank `state`: an f32
        tree with leading axis C = len(ids). Never mutates the state."""
        raise NotImplementedError

    def scatter(self, state: dict, ids, updates, *, valid=None,
                rng=None) -> dict:
        """Write the cohort's fresh updates and maintain G_sum.

        ids (C,) int row indices (host numpy); updates: f32 tree, leaves
        (C, ...); valid (C,) bool (None => all valid); rng the generator
        `round_rng` names (int8 banks only). Returns the new state (the old
        one must not be reused).
        """
        check_unique_ids(ids, valid)
        return self._scatter_rows(state, ids, updates, valid=valid, rng=rng)

    def _scatter_rows(self, state: dict, ids, updates, *, valid,
                      rng=None) -> dict:
        """Backend scatter body; `scatter` has already validated the ids."""
        ids, valid = host_cohort(ids, valid)
        rows, valid = self.upload(self.stage_rows(ids, valid), valid)
        return self.scatter_staged(state, rows, valid, updates, rng=rng)

    def stage_rows(self, ids: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Host side of a staged scatter: check the padded cohort `ids`
        ((C,) or (K, C) int64) and return the row index the backend's
        kernels take, the same shape."""
        raise NotImplementedError

    def upload(self, rows: np.ndarray, valid: np.ndarray):
        """A staged cohort as tensors on the bank's device."""
        return (torch.from_numpy(np.ascontiguousarray(rows)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(valid)).to(self.device))

    def scatter_staged(self, state: dict, rows: torch.Tensor,
                       valid: torch.Tensor, updates, *, rng=None) -> dict:
        """The scatter on a staged cohort: rows (C,) from `stage_rows` and
        valid (C,) bool, on the bank's device; updates leaves (C, ...) f32.
        For a paged bank every valid row must be resident (`prepare`)."""
        raise NotImplementedError

    def prepare(self, state: dict, ids) -> dict:
        """Pre-round residency hook; the identity for non-paging backends."""
        return state

    # ------------------------------------------------------------------ #
    # fleets: states whose leaves carry a leading trial axis (K, ...)
    # ------------------------------------------------------------------ #

    def gather_fleet(self, state: dict, ids) -> Any:
        """Batched gather over a stacked trial `state`: `ids` (K, C) host
        numpy -> rows (K, C, ...) f32, trial k's rows from trial k's bank."""
        ids = np.asarray(ids)
        return tree_stack([self._gather_trial(state, k, ids[k])
                           for k in range(ids.shape[0])])

    def _gather_trial(self, state: dict, k: int, ids) -> Any:
        """Trial k's rows `ids` out of a stacked state."""
        return self.gather(tree_index(state, k), ids)

    def scatter_fleet(self, state: dict, ids, updates, *, valid=None) -> dict:
        """Batched scatter over a stacked trial `state`: `ids`/`valid`
        (K, C) host numpy, `updates` leaves (K, C, ...) f32 -> the new
        stacked state, with per-trial G_sum maintenance (the old state must
        not be reused)."""
        ids, valid = host_cohort(ids, valid)
        if ids.ndim != 2:
            raise ValueError(f"fleet ids must be (K, C), got {ids.shape}")
        for k in range(ids.shape[0]):
            check_unique_ids(ids[k], valid[k])
        return self._scatter_fleet_rows(state, ids, updates, valid=valid)

    def _scatter_fleet_rows(self, state: dict, ids: np.ndarray, updates, *,
                            valid: np.ndarray) -> dict:
        """Backend fleet scatter body; `scatter_fleet` validated the ids."""
        rows, valid = self.upload(self.stage_rows(ids, valid), valid)
        return self.scatter_fleet_staged(state, rows, valid, updates)

    def scatter_fleet_staged(self, state: dict, rows: torch.Tensor,
                             valid: torch.Tensor, updates, *,
                             rng=None) -> dict:
        """`scatter_staged` for K stacked trials: rows/valid (K, C), update
        leaves (K, C, ...); `rng` a list of K generators for int8 banks."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the batched fleet "
            "scatter; backends that do: DenseBank, PagedDeviceBank")

    def host_state(self) -> dict:
        """Host-side bookkeeping to keep in a run snapshot, as a tree of
        arrays or tensors (`checkpoint.save_run`). Empty for banks whose
        state is all in `runner.state`; `PagedDeviceBank` returns its
        residency mirrors and spilled pages."""
        return {}

    def load_host_state(self, tree: dict) -> None:
        """Restore what `host_state` returned (after `init`, before the
        first round of the resumed run). The default does nothing."""
        del tree

    def mean_g(self, state: dict) -> Any:
        """G_sum / N as a tree with param-shaped leaves."""
        raise NotImplementedError

    def memory_bytes(self, state: dict) -> dict:
        """{'device': bytes, 'host': bytes} currently held by the bank."""
        raise NotImplementedError


def host_cohort(ids, valid) -> tuple[np.ndarray, np.ndarray]:
    """ids as int64 and valid as bool numpy arrays (valid None => all)."""
    ids = np.asarray(ids, np.int64)
    return ids, (np.ones(ids.shape, bool) if valid is None
                 else np.asarray(valid, bool))


def check_row_range(ids: np.ndarray, valid: np.ndarray, n: int,
                    n_rows: int | None = None) -> None:
    """Every id must be >= 0, every valid id below `n` and, when the bank
    stores its pad row (`n_rows`), every id below `n_rows`; otherwise pad
    ids may be any id >= n."""
    if ids.size and (ids.min() < 0 or (ids[valid] >= n).any()
                     or (n_rows is not None and ids.max() >= n_rows)):
        raise IndexError(f"bank row ids must be >= 0"
                         + ("" if n_rows is None else f" and < {n_rows}")
                         + f", valid ids < {n}; got [{ids.min()}, "
                         f"{ids.max()}]")


def tree_nbytes(tree) -> int:
    """Bytes held by the tensors of a tree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def broadcast_valid(valid: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """valid (C,) -> broadcastable to leaf (C, ...)."""
    return valid.reshape((valid.shape[0],) + (1,) * (leaf.ndim - 1))


def check_unique_ids(ids, valid=None) -> None:
    """Reject duplicate *valid* ids in one scatter call.

    With duplicates, each copy's delta is computed against the original row
    but only one write survives — G_sum would silently diverge from the sum
    of rows forever after. Cohorts are sets: deduplicate first.
    """
    ids = np.asarray(ids)
    if valid is not None:
        ids = ids[np.asarray(valid, bool)]
    if len(np.unique(ids)) != len(ids):
        raise ValueError(
            "duplicate client ids in one scatter call would corrupt G_sum; "
            "deduplicate the cohort (np.unique) before applying it")
