"""Plain SGD (+momentum, weight decay) — the paper's optimizer, server side.

Counterpart of `repro/optim/sgd.py`. The FL algorithms apply `w -= η·Ḡ`
themselves; this is the standalone optimizer for non-FL training paths and
the momentum variant of the server update.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def sgd_init(params, momentum: float = 0.0) -> dict:
    """{} without momentum, else {"m": f32 zeros shaped like params}."""
    if momentum == 0.0:
        return {}
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)}


def sgd_step(params, grads, opt_state: dict, *, eta: float,
             momentum: float = 0.0, weight_decay: float = 0.0):
    """One step: g += λ·w; with momentum m = μ·m + g and w -= η·m, else
    w -= η·g. Returns (new_params, new_opt_state)."""
    if weight_decay:
        grads = tree_map(lambda g, w: g + weight_decay * w.to(g.dtype),
                         grads, params)
    if momentum:
        m = tree_map(lambda mm, g: momentum * mm + g.float(),
                     opt_state["m"], grads)
        params = tree_map(lambda w, mm: (w - eta * mm).to(w.dtype),
                          params, m)
        return params, {"m": m}
    params = tree_map(lambda w, g: (w - eta * g).to(w.dtype), params, grads)
    return params, opt_state
