"""Carry parameter trees between the JAX package and the port.

Both packages use the same nested dict/list structure and keys, so a tree of
numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) maps leaf by leaf.
This module imports no JAX: the caller converts to numpy on its side.
bfloat16 leaves (numpy's `ml_dtypes.bfloat16`, which torch cannot read) are
carried by their bits through int16, so no value changes in either
direction.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.tree import tree_map


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def params_from_jax(tree_of_numpy, device: str | torch.device):
    """numpy leaves (same structure as the reference params) -> tensors on
    `device`. Leaves are copied, never shared with the numpy arrays."""
    dev = resolve_device(device)

    def one(a) -> torch.Tensor:
        a = np.asarray(a)
        if _is_bf16(a):
            bits = torch.from_numpy(a.view(np.int16).copy())
            return bits.view(torch.bfloat16).to(dev)
        return torch.tensor(a, device=dev)

    return tree_map(one, tree_of_numpy)


def params_to_numpy(params):
    """Tensor leaves -> numpy leaves on the host. bfloat16 leaves become
    numpy bfloat16 arrays with the same bits: the dtype `ml_dtypes`
    registers with numpy, which the caller's side (the JAX package) has
    imported; this package never imports it."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            try:
                bf16 = np.dtype("bfloat16")
            except TypeError:
                raise TypeError("numpy has no bfloat16 dtype until "
                                "ml_dtypes is imported (the JAX package "
                                "imports it)") from None
            return t.view(torch.int16).numpy().view(bf16)
        return t.numpy()
    return tree_map(one, params)
