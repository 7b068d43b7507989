"""Deterministic per-client batching for the FL round loop.

`sample_round(t)` yields a dict of numpy arrays whose leaves have shape
(N, K, mb, ...): one minibatch per client per local step, reproducible from
(seed, t). `sample_round(t, client_ids=ids)` yields the compact cohort
variant — leaves (len(ids), K, mb, ...) holding exactly the rows the full
call would have produced for those clients, in `ids` order.

Batches stay numpy on the host (array-equal to `repro/data/pipeline.py`);
`core.runner.RoundRunner` moves them to the run's device. The token,
procedural and in-program batchers are not ported yet (ROADMAP Queue 1
items 2 and 16).
"""
from __future__ import annotations

import numpy as np


class ClientBatcher:
    """Tabular classification batches: {'x': (N,K,mb,dim), 'y': (N,K,mb)}."""

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 client_indices: list[np.ndarray], *, batch_size: int,
                 k_steps: int, seed: int = 0):
        self.Xs = [X[idx] for idx in client_indices]
        self.ys = [y[idx] for idx in client_indices]
        self.n_clients = len(client_indices)
        self.batch_size = batch_size
        self.k_steps = k_steps
        self.seed = seed
        self.dim = X.shape[1]

    def sample_round(self, t: int, client_ids=None) -> dict:
        mb, K = self.batch_size, self.k_steps
        ids = (np.arange(self.n_clients) if client_ids is None
               else np.asarray(client_ids, np.int64))
        xs = np.empty((len(ids), K, mb, self.dim), np.float32)
        ys = np.empty((len(ids), K, mb), np.int32)
        for j, i in enumerate(ids):
            i = int(i)
            rng = np.random.default_rng((self.seed, t, i))
            idx = rng.integers(0, len(self.ys[i]), size=(K, mb))
            xs[j] = self.Xs[i][idx]
            ys[j] = self.ys[i][idx]
        return {"x": xs, "y": ys}
