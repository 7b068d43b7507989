"""HostBank — f32 rows in host memory; the bank holds no device memory.

Counterpart of `repro/bank/host.py`. The O(N·d) rows live where memory is
cheapest, host RAM (pinned when the run is on the card, so the cohort's
rows cross to the device by DMA); only the cohort's rows cross the host ↔
device boundary: updates (|A|, d) come to the host once a round, mean_G
(d,) goes to the device once a round.

Layout (per parameter leaf, host tensors):
    rows  : (N, *param_shape) f32
    g_sum : (*param_shape,) f32, the running Σ_i rows[i]

The scatter does its arithmetic on the tensors' numpy views, exactly as
the reference writes it (``gs += (u - r[ids]).sum(axis=0,
dtype=np.float32)``; ``r[ids] = u``), so `g_sum` and the rows are
array-equal to the reference's for the same inputs. `gather` stages the
cohort's rows in a pinned buffer and copies them to the device without
blocking; `mean_g` returns device tensors.

A host bank: the scan engine runs it on the loop (`on_device = False`),
and the cohort's staged rows come back to the host in `scatter_staged`.
It takes no round generator.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bank.base import MemoryBank, check_row_range, host_cohort
from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.tree import tree_leaves, tree_map


class HostBank(MemoryBank):
    on_device = False

    def __init__(self, *, device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.n = 0

    @property
    def pinned(self) -> bool:
        """Whether the rows sit in pinned memory (runs on the card)."""
        return self.device.type == "cuda"

    def _host_zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32,
                           pin_memory=self.pinned)

    def init(self, params, n_clients: int) -> dict:
        self.n = n_clients
        rows = tree_map(lambda p: self._host_zeros(
            (n_clients,) + tuple(p.shape)), params)
        g_sum = tree_map(lambda p: self._host_zeros(tuple(p.shape)), params)
        return {"rows": rows, "g_sum": g_sum}

    def gather(self, state: dict, ids):
        ids = np.asarray(ids, np.int64)

        def one(r):
            buf = torch.empty((len(ids),) + tuple(r.shape[1:]),
                              dtype=torch.float32, pin_memory=self.pinned)
            buf.numpy()[...] = r.numpy()[ids]
            return buf.to(self.device, non_blocking=True)

        return tree_map(one, state["rows"])

    def stage_rows(self, ids: np.ndarray, valid: np.ndarray) -> np.ndarray:
        check_row_range(ids, valid, self.n)
        return ids

    def _scatter_rows(self, state: dict, ids, updates, *, valid,
                      rng=None) -> dict:
        ids, valid = host_cohort(ids, valid)
        check_row_range(ids, valid, self.n)
        return self._scatter_host(state, ids[valid], valid, updates)

    def scatter_staged(self, state: dict, rows: torch.Tensor,
                       valid: torch.Tensor, updates, *, rng=None) -> dict:
        keep = valid.cpu().numpy()
        return self._scatter_host(state, rows.cpu().numpy()[keep], keep,
                                  updates)

    def _scatter_host(self, state: dict, ids: np.ndarray, keep: np.ndarray,
                      updates) -> dict:
        """The reference's scatter on the numpy views: ids are the valid
        rows, `keep` selects their updates."""
        keep_t = torch.from_numpy(np.flatnonzero(keep))
        for r, gs, u in zip(tree_leaves(state["rows"]),
                            tree_leaves(state["g_sum"]),
                            tree_leaves(updates)):
            u = u.detach().float().cpu()[keep_t].numpy()   # cohort rows only
            r, gs = r.numpy(), gs.numpy()
            gs += (u - r[ids]).sum(axis=0, dtype=np.float32)
            r[ids] = u
        return {"rows": state["rows"], "g_sum": state["g_sum"]}

    def mean_g(self, state: dict):
        return tree_map(lambda g: torch.from_numpy(g.numpy() / self.n).to(
            self.device), state["g_sum"])

    def memory_bytes(self, state: dict) -> dict:
        host = sum(t.numel() * t.element_size()
                   for t in tree_leaves([state["rows"], state["g_sum"]]))
        return {"device": 0, "host": host}
