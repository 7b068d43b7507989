"""Deterministic per-client batching for the FL round loop.

`sample_round(t)` yields a dict of numpy arrays whose leaves have shape
(N, K, mb, ...): one minibatch per client per local step, reproducible from
(seed, t). `sample_round(t, client_ids=ids)` yields the compact cohort
variant — leaves (len(ids), K, mb, ...) holding exactly the rows the full
call would have produced for those clients, in `ids` order.

Batches stay numpy on the host (array-equal to `repro/data/pipeline.py`);
`core.runner.RoundRunner` moves them to the run's device. `ClientBatcher`
draws from stored client shards; `ProceduralBatcher` stores nothing per
client, so a cohort run at N=10⁶ costs O(|A|) per round. The token and
in-program batchers are not ported yet (ROADMAP Queue 1 items 2 and 16).
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


class ProceduralBatcher:
    """Stateless tabular batches for million-client cohort runs.

    No per-client storage: client i's shard is an infinite stream defined by
    (seed, i) — features are a client-specific mean shift (non-iid) plus
    noise, labels come from a fixed random linear teacher. The same draws
    whether a client is sampled through the full path or a compact cohort.
    """

    def __init__(self, *, n_clients: int, dim: int, n_classes: int = 2,
                 batch_size: int, k_steps: int, shift: float = 1.0,
                 noise: float = 1.0, seed: int = 0):
        self.n_clients = n_clients
        self.dim = dim
        self.n_classes = n_classes
        self.batch_size = batch_size
        self.k_steps = k_steps
        self.shift = shift
        self.noise = noise
        self.seed = seed
        teacher_rng = np.random.default_rng((seed, 0x7EAC))
        self.teacher = teacher_rng.normal(size=(dim, n_classes)) \
            .astype(np.float32)

    def _client_mean(self, i: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 0xC11E27, i))
        return (self.shift * rng.normal(size=self.dim)).astype(np.float32)

    def sample_round(self, t: int, client_ids=None) -> dict:
        mb, K = self.batch_size, self.k_steps
        ids = (np.arange(self.n_clients) if client_ids is None
               else np.asarray(client_ids, np.int64))
        xs = np.empty((len(ids), K, mb, self.dim), np.float32)
        ys = np.empty((len(ids), K, mb), np.int32)
        for j, i in enumerate(ids):
            i = int(i)
            rng = np.random.default_rng((self.seed, t, i))
            x = rng.normal(size=(K, mb, self.dim)).astype(np.float32) \
                * self.noise + self._client_mean(i)
            xs[j] = x
            ys[j] = np.argmax(x @ self.teacher, axis=-1).astype(np.int32)
        return {"x": xs, "y": ys}
