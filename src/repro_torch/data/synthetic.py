"""Synthetic datasets (offline; counterpart of `repro/data/synthetic.py`).

`make_classification` builds a Gaussian-prototype mixture that structurally
matches the paper's image-classification tasks: C classes, per-class prototype
in R^dim, isotropic noise. Logistic regression on it (+ l2) is strongly convex;
the MLP model on it is non-convex — the two regimes of the paper's theory.
`make_token_stream` gives the zoo's synthetic LM data. Both draw from numpy
generators only, so they are array-equal to the reference.
"""
from __future__ import annotations

import numpy as np


def make_classification(n_classes: int = 10, dim: int = 64,
                        n_per_class: int = 500, noise: float = 0.8,
                        proto_scale: float = 1.0, seed: int = 0,
                        proto_seed: int = 1234):
    """Returns (X (n, dim) f32, y (n,) int32), features scaled to ~unit norm.

    `proto_seed` fixes the class prototypes independently of the sample seed,
    so train/test splits drawn with different `seed` share one distribution.
    """
    prng = np.random.default_rng(proto_seed)
    protos = prng.normal(0.0, proto_scale, (n_classes, dim))
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for c in range(n_classes):
        xs.append(protos[c] + rng.normal(0.0, noise, (n_per_class, dim)))
        ys.append(np.full(n_per_class, c, np.int32))
    X = np.concatenate(xs).astype(np.float32) / np.sqrt(dim)
    y = np.concatenate(ys)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def make_token_stream(vocab: int, length: int, seed: int = 0,
                      zipf_a: float = 1.2, client_shift: int = 0):
    """Synthetic non-iid LM data: Zipf marginal with a per-client vocabulary
    rotation (clients see the same language 'shape' over disjoint-ish token
    identities — a strong distribution shift, like the paper's label skew)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf_a, size=length).astype(np.int64)
    toks = (ranks + client_shift) % vocab
    return toks.astype(np.int32)
