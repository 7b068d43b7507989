"""Deterministic per-client batching for the FL round loop.

`sample_round(t)` yields a dict of numpy arrays whose leaves have shape
(N, K, mb, ...): one minibatch per client per local step, reproducible from
(seed, t). `sample_round(t, client_ids=ids)` yields the compact cohort
variant — leaves (len(ids), K, mb, ...) holding exactly the rows the full
call would have produced for those clients, in `ids` order.

Batches stay numpy on the host (array-equal to `repro/data/pipeline.py`);
`core.runner.RoundRunner` moves them to the run's device. `ClientBatcher`
draws from stored client shards; `ProceduralBatcher` stores nothing per
client, so a cohort run at N=10⁶ costs O(|A|) per round.
`JitProceduralBatcher` draws its rounds on the run's device from threefry
normals (`batch_fn`), so the simulator's rounds need no host batch.
`TokenBatcher` cuts the zoo's LM batches from per-client synthetic token
streams.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.synthetic import make_token_stream
from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.scenarios import _threefry


class ClientBatcher:
    """Tabular classification batches: {'x': (N,K,mb,dim), 'y': (N,K,mb)}."""

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 client_indices: list[np.ndarray], *, batch_size: int,
                 k_steps: int, seed: int = 0):
        # the shards as f32, the batches' dtype: the same values as
        # casting each gathered batch, with half the bytes to gather
        self.Xs = [X[idx].astype(np.float32) for idx in client_indices]
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


class TokenBatcher:
    """LM batches {'tokens': (N,K,mb,seq)} from per-client synthetic streams."""

    def __init__(self, *, n_clients: int, vocab: int, seq_len: int,
                 batch_size: int, k_steps: int, stream_len: int = 1 << 16,
                 seed: int = 0):
        self.streams = [
            make_token_stream(vocab, stream_len, seed=seed + i,
                              client_shift=i * (vocab // max(n_clients, 1)))
            for i in range(n_clients)]
        self.n_clients = n_clients
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.k_steps = k_steps
        self.seed = seed

    def sample_round(self, t: int, client_ids=None) -> dict:
        mb, K, S = self.batch_size, self.k_steps, self.seq_len
        ids = (np.arange(self.n_clients) if client_ids is None
               else np.asarray(client_ids, np.int64))
        out = np.empty((len(ids), K, mb, S), np.int32)
        window = np.arange(S)
        for j, i in enumerate(ids):
            i = int(i)
            rng = np.random.default_rng((self.seed, t, i, 7))
            starts = rng.integers(0, len(self.streams[i]) - S - 1, size=(K, mb))
            # every (k, b) window at once: the reference's slices
            out[j] = self.streams[i][starts[..., None] + window]
        return {"tokens": out}


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


class JitProceduralBatcher:
    """Procedural batches with a device surface (counterpart of the
    reference's `JitProceduralBatcher`): client-specific mean shifts plus
    noise, labels from a fixed random linear teacher, drawn from threefry
    streams keyed by ``split(PRNGKey(seed), 4)`` (teacher, means, data,
    eval).

      * `batch_fn()` returns a pure ``(t) -> {'x': (N, K, mb, dim) f32,
        'y': (N, K, mb) int32}`` on this batcher's device, keyed by
        ``fold_in(data key, t)`` (t an int or a 0-d int64 tensor), so the
        compiled simulator draws a round inside the captured round.
      * `sample_round(t)` materialises it as numpy: the same ops on the
        same device, so the host and the device surface are bit-equal.

    The normals are `jax.random.normal`'s bits through the device's
    `erfinv`, which differs from XLA's by a few ulp: the batches equal the
    reference's only in distribution. `eval_batch(n)` draws a held-out set
    from the eval stream.
    """

    def __init__(self, *, n_clients: int, dim: int, n_classes: int = 2,
                 batch_size: int, k_steps: int, shift: float = 1.0,
                 noise: float = 1.0, seed: int = 0,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.n_clients = n_clients
        self.dim = dim
        self.n_classes = n_classes
        self.batch_size = batch_size
        self.k_steps = k_steps
        self.shift = shift
        self.noise = noise
        self.seed = seed
        self.device = resolve_device(device)
        keys = _threefry.split(_threefry.seed_key(seed), 4)
        self._k_teacher, self._k_means, self._k_data, self._k_eval = (
            keys[i] for i in range(4))
        self._host_fn = None

    def _normal(self, key: torch.Tensor, shape: tuple) -> torch.Tensor:
        n = int(np.prod(shape))
        return _threefry.normal(key.to(self.device), n).reshape(shape)

    def _teacher(self) -> torch.Tensor:
        return self._normal(self._k_teacher, (self.dim, self.n_classes))

    def batch_fn(self):
        """Pure ``(t) -> {'x', 'y'}`` on the batcher's device."""
        n, k, mb, d = (self.n_clients, self.k_steps, self.batch_size,
                       self.dim)
        f32 = dict(dtype=torch.float32, device=self.device)
        teacher = self._teacher()
        means = torch.full((), float(np.float32(self.shift)), **f32) \
            * self._normal(self._k_means, (n, d))
        noise = torch.full((), float(np.float32(self.noise)), **f32)
        k_data = self._k_data.to(self.device)

        def draw(t):
            key = _threefry.round_key(k_data, t)
            z = _threefry.normal(key, n * k * mb * d).reshape(n, k, mb, d)
            x = noise * z + means[:, None, None, :]
            y = torch.argmax(x @ teacher, dim=-1).to(torch.int32)
            return {"x": x, "y": y}

        return draw

    def sample_round(self, t: int, client_ids=None) -> dict:
        """Round t's batch as numpy (the device surface materialised);
        `client_ids` selects a compact cohort view."""
        if self._host_fn is None:
            self._host_fn = self.batch_fn()
        batch = {k: v.cpu().numpy() for k, v in self._host_fn(
            torch.tensor(int(t), device=self.device)).items()}
        if client_ids is not None:
            ids = np.asarray(client_ids, np.int64)
            batch = {k: v[ids] for k, v in batch.items()}
        return batch

    def eval_batch(self, n_eval: int = 2048) -> dict:
        """Held-out {'x': (n_eval, dim), 'y': (n_eval,)} numpy from the eval
        stream: no client shift, noise, teacher labels."""
        noise = torch.tensor(float(np.float32(self.noise)),
                             dtype=torch.float32, device=self.device)
        x = noise * self._normal(self._k_eval, (n_eval, self.dim))
        y = torch.argmax(x @ self._teacher(), dim=-1).to(torch.int32)
        return {"x": x.cpu().numpy(), "y": y.cpu().numpy()}
