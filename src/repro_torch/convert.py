"""Carry parameter trees between the JAX package and the port.

Both packages use the same nested dict/list structure and keys, so a tree of
numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) maps leaf by leaf.
This module imports no JAX: the caller converts to numpy on its side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.tree import tree_map


def params_from_jax(tree_of_numpy, device: str | torch.device):
    """numpy leaves (same structure as the reference params) -> tensors on
    `device`. Leaves are copied, never shared with the numpy arrays."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev),
                    tree_of_numpy)


def params_to_numpy(params):
    """Tensor leaves -> numpy leaves on the host (bfloat16 widens to f32,
    which numpy lacks)."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(one, params)
