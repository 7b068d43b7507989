"""Non-i.i.d. label-skew partitioner (paper §7: 2 classes per device).

McMahan-style shard assignment: sort by label, cut into 2N shards, deal each
client 2 shards — so each device holds samples of (at most) two classes and
all devices hold equally many samples. numpy only, array-equal to
`repro/data/partition.py`.
"""
from __future__ import annotations

import numpy as np


def label_skew_partition(y: np.ndarray, n_clients: int,
                         shards_per_client: int = 2, seed: int = 0):
    """Returns (client_indices: list[np.ndarray], client_labels: (N, 2) int)."""
    rng = np.random.default_rng(seed)
    n_shards = n_clients * shards_per_client
    order = np.argsort(y, kind="stable")
    shards = np.array_split(order, n_shards)
    shard_ids = rng.permutation(n_shards)
    client_indices, client_labels = [], []
    for i in range(n_clients):
        sids = shard_ids[i * shards_per_client:(i + 1) * shards_per_client]
        idx = np.concatenate([shards[s] for s in sids])
        client_indices.append(idx)
        labels = sorted({int(y[shards[s]][0]) for s in sids})
        if len(labels) == 1:
            labels = labels * 2
        client_labels.append(labels[:2])
    return client_indices, np.asarray(client_labels, np.int64)
