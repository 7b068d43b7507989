"""Synthetic datasets (offline; counterpart of `repro/data/synthetic.py`).

`make_classification` builds a Gaussian-prototype mixture that structurally
matches the paper's image-classification tasks: C classes, per-class prototype
in R^dim, isotropic noise. Logistic regression on it (+ l2) is strongly convex;
the MLP model on it is non-convex — the two regimes of the paper's theory.
It draws from numpy generators only, so it is array-equal to the reference.
`make_token_stream` (LM data) is not ported yet (ROADMAP Queue 1 item 18).
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
