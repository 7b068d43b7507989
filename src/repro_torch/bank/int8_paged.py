"""Int8PagedBank — lazily paged int8 rows with per-(row, leaf) absmax scales,
in host memory (counterpart of `repro/bank/int8_paged.py`).

Uses `core.quantized_memory`'s stochastic rounding, so a stored row stays
an unbiased estimator of the true update. Rows are allocated in pages of
`page_size` only when a client of that page first participates, so under
long-tail availability the resident set follows the clients ever seen, not
N.

Layout (host numpy, per parameter leaf):
    pages[leaf][p]  = int8 (page_size, *leaf_shape)   quantized rows
    scales[leaf][p] = f32  (page_size,)               absmax / 127 per row
A missing page reads as exact zeros (every G^i starts at 0).

G_sum is kept in f32 over the *dequantized* values, so G_sum = Σ_i
dequant(row_i) (up to the order of the f32 sums) and mean_g agrees with
what gather returns.

A host bank: its rows live outside the device, so the scan engine runs it
on the loop (`on_device = False`). Its quantizer draws from the run's CPU
round generator (`round_rng = "cpu"`); the cohort's updates come to the
host for it, and gather and mean_g go back to the bank's `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bank.base import MemoryBank, check_row_range
from repro_torch.core import quantized_memory as qm
from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.tree import tree_map


def _map_leaves(tree) -> list:
    """The leaves of `tree` in the order `tree_map` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


class Int8PagedBank(MemoryBank):
    on_device = False
    round_rng = "cpu"

    def __init__(self, *, page_size: int = 1024,
                 device: str | torch.device = DEFAULT_DEVICE):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.page_size = page_size
        self.device = resolve_device(device)
        self.n = 0

    def init(self, params, n_clients: int) -> dict:
        self.n = n_clients
        leaves = _map_leaves(params)
        return {
            "like": tree_map(lambda p: None, params),   # the tree structure
            "shapes": [tuple(leaf.shape) for leaf in leaves],
            "pages": [{} for _ in leaves],     # page index -> int8 rows
            "scales": [{} for _ in leaves],    # page index -> f32 scales
            "g_sum": [np.zeros(tuple(leaf.shape), np.float32)
                      for leaf in leaves],
        }

    def _tree(self, state: dict, leaves: list):
        """Numpy `leaves` (in `_map_leaves` order) as tensors on the bank's
        device, in the params' tree structure."""
        it = iter(leaves)
        return tree_map(lambda _: torch.from_numpy(np.ascontiguousarray(
            next(it))).to(self.device), state["like"])

    def _rows(self, state: dict, li: int, ids: np.ndarray) -> np.ndarray:
        """Dequantized rows (len(ids), *shape) of leaf li; zeros if unseen."""
        out = np.zeros((len(ids),) + state["shapes"][li], np.float32)
        pages, scales = state["pages"][li], state["scales"][li]
        for k, i in enumerate(ids):
            p, off = divmod(int(i), self.page_size)
            if p in pages:
                out[k] = pages[p][off].astype(np.float32) * scales[p][off]
        return out

    def gather(self, state: dict, ids):
        ids = np.asarray(ids, np.int64)
        return self._tree(state, [self._rows(state, li, ids)
                                  for li in range(len(state["shapes"]))])

    def stage_rows(self, ids: np.ndarray, valid: np.ndarray) -> np.ndarray:
        check_row_range(ids, valid, self.n)
        return ids

    def scatter_staged(self, state: dict, rows: torch.Tensor,
                       valid: torch.Tensor, updates, *, rng=None) -> dict:
        if rng is None:
            raise ValueError("Int8PagedBank needs the run's CPU round "
                             "generator (rng=) for its rounding")
        keep = valid.cpu().numpy()
        ids = rows.cpu().numpy()[keep]
        if ids.size == 0:      # an empty round (a blackout)
            return state
        keep_t = torch.from_numpy(np.flatnonzero(keep))
        for li, u in enumerate(_map_leaves(updates)):
            u = u.detach().float().cpu()[keep_t]
            q, s = qm.quantize_leaf(rng, u)
            q, s = q.numpy(), s.numpy()
            # what the bank answers for these rows from now on
            u_eff = q.astype(np.float32) * s.reshape(
                (-1,) + (1,) * (q.ndim - 1))
            old = self._rows(state, li, ids)
            state["g_sum"][li] += (u_eff - old).sum(axis=0, dtype=np.float32)
            pages, scales = state["pages"][li], state["scales"][li]
            shape = state["shapes"][li]
            for k, i in enumerate(ids):
                p, off = divmod(int(i), self.page_size)
                if p not in pages:
                    pages[p] = np.zeros((self.page_size,) + shape, np.int8)
                    scales[p] = np.zeros((self.page_size,), np.float32)
                pages[p][off] = q[k]
                scales[p][off] = s[k]
        return state

    def mean_g(self, state: dict):
        return self._tree(state, [g / self.n for g in state["g_sum"]])

    def n_pages(self, state: dict) -> int:
        return max((len(p) for p in state["pages"]), default=0)

    def memory_bytes(self, state: dict) -> dict:
        host = sum(a.nbytes for leaf in state["pages"] for a in leaf.values())
        host += sum(a.nbytes for leaf in state["scales"]
                    for a in leaf.values())
        host += sum(g.nbytes for g in state["g_sum"])
        return {"device": 0, "host": host}
