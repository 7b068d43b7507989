"""MemoryBank — sparse server memory for cohort-sized MIFA rounds.

MIFA's server state is one row per client: G^i, the client's latest K-step
update. A MemoryBank exposes it through row-sparse access so a round touches
only the active cohort A(t):

    scatter(state, ids, updates)  -> new state with those rows replaced

and maintains the running sum  G_sum = Σ_i G^i  incrementally via the delta
identity  G_sum += Σ_{a ∈ A} (u_a − G_old_a), so the server step's
mean_G = G_sum / N is O(d). Counterpart of `repro/bank/base.py`; the ported
backends are `DenseBank` and `PagedDeviceBank` (which pages rows on and off
the card in `prepare`). Both run fleets: `scatter_fleet` and
`gather_fleet` take states whose leaves carry a leading trial axis (K, ...).
The host and int8-paged banks and `host_state` are not ported yet (ROADMAP
Queue 1 items 9, 10, 17).

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
    `_scatter_rows` / `_scatter_fleet_rows`."""

    def init(self, params: Any, n_clients: int) -> dict:
        """Zero-filled bank state for `n_clients` rows shaped like `params`."""
        raise NotImplementedError

    def gather(self, state: dict, ids) -> Any:
        """Read rows `ids` (C,) (host numpy) out of the bank `state`: an f32
        tree with leading axis C = len(ids). Never mutates the state."""
        raise NotImplementedError

    def scatter(self, state: dict, ids, updates, *, valid=None) -> dict:
        """Write the cohort's fresh updates and maintain G_sum.

        ids (C,) int row indices (host numpy); updates: f32 tree, leaves
        (C, ...); valid (C,) bool (None => all valid). Returns the new state
        (the old one must not be reused).
        """
        check_unique_ids(ids, valid)
        return self._scatter_rows(state, ids, updates, valid=valid)

    def _scatter_rows(self, state: dict, ids, updates, *, valid) -> dict:
        """Backend scatter body; `scatter` has already validated the ids."""
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
        ids = np.asarray(ids, np.int64)
        if ids.ndim != 2:
            raise ValueError(f"fleet ids must be (K, C), got {ids.shape}")
        valid = (np.ones(ids.shape, bool) if valid is None
                 else np.asarray(valid, bool))
        for k in range(ids.shape[0]):
            check_unique_ids(ids[k], valid[k])
        return self._scatter_fleet_rows(state, ids, updates, valid=valid)

    def _scatter_fleet_rows(self, state: dict, ids: np.ndarray, updates, *,
                            valid: np.ndarray) -> dict:
        """Backend fleet scatter body; `scatter_fleet` validated the ids."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the batched fleet "
            "scatter; backends that do: DenseBank, PagedDeviceBank")

    def mean_g(self, state: dict) -> Any:
        """G_sum / N as a tree with param-shaped leaves."""
        raise NotImplementedError

    def memory_bytes(self, state: dict) -> dict:
        """{'device': bytes, 'host': bytes} currently held by the bank."""
        raise NotImplementedError


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
