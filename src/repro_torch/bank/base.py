"""MemoryBank — sparse server memory for cohort-sized MIFA rounds.

MIFA's server state is one row per client: G^i, the client's latest K-step
update. A MemoryBank exposes it through row-sparse access so a round touches
only the active cohort A(t):

    scatter(state, ids, updates)  -> new state with those rows replaced

and maintains the running sum  G_sum = Σ_i G^i  incrementally via the delta
identity  G_sum += Σ_{a ∈ A} (u_a − G_old_a), so the server step's
mean_G = G_sum / N is O(d). Counterpart of `repro/bank/base.py`; the ported
backends are `DenseBank` and `PagedDeviceBank` (which pages rows on and off
the card in `prepare`). The host and int8-paged banks, the fleet entry
points and `host_state` are not ported yet (ROADMAP Queue 1 items 9, 10,
15, 17).

Padding convention: the round loop pads a cohort to a fixed capacity. Pad slots
carry `valid=False` and point `ids` at the dummy row index N; they never
touch G_sum or any real row.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves


class MemoryBank:
    """Interface; `scatter` is a template method that enforces the
    duplicate-id invariant (`check_unique_ids`) for every backend before it
    delegates to the backend's `_scatter_rows`."""

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
