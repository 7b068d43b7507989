"""K-step local SGD (paper Algorithm 1, DeviceUpdate).

An active device receives w_t, runs K steps of SGD at learning rate η_t on its
local objective, and returns G^i = (w_t − w^i_{t,K}) / η_t — which is exactly
the sum of its K stochastic gradients. The gradient sum is accumulated
directly, as in `repro/core/local_update.py`.

`client_updates` vmaps the device update over the leading client axis with
`torch.func.vmap`; the reference's `lax.scan` over the K steps is a Python
loop.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch.tree import tree_map


def device_update(loss_fn: Callable, params, client_batch, eta: float,
                  weight_decay: float = 0.0):
    """Run K local SGD steps for ONE device.

    client_batch: dict whose leaves have leading axis K (one minibatch per
    local step). Returns (G = Σ_k (∇f(w_{t,k}) + λ·w_{t,k}), mean local loss).
    Weight decay joins the gradient before both the step and the sum; the
    step is taken in f32.
    """
    grad_fn = grad_and_value(loss_fn, has_aux=True)
    k_steps = next(iter(client_batch.values())).shape[0]
    w, acc = params, None
    losses = []
    for k in range(k_steps):
        mb = {key: v[k] for key, v in client_batch.items()}
        g, (loss, _) = grad_fn(w, mb)
        if weight_decay:
            g = tree_map(lambda gg, ww: gg + weight_decay * ww, g, w)
        # the last step's weights are never read: not computing them (and
        # dropping each step's gradients once summed) keeps one client
        # copy of the weights and one of the gradients alive, not two
        w = (tree_map(lambda ww, gg: (ww.float() - eta * gg.float()
                                      ).to(ww.dtype), w, g)
             if k < k_steps - 1 else None)
        acc = (tree_map(lambda gg: gg.float(), g) if acc is None
               else tree_map(lambda aa, gg: aa + gg.float(), acc, g))
        del g
        losses.append(loss)
    return acc, torch.stack(losses).mean()


def client_updates(loss_fn: Callable, params, batches, eta: float, K: int,
                   weight_decay: float = 0.0):
    """vmap device_update over clients.

    batches: dict with leaves (N, K, ...) on the params' device.
    Returns (G (N, ...) f32, losses (N,)), every leaf contiguous: a leaf
    the loss does not read (an audio model's `embed`) has a zero gradient
    that vmap returns as one row expanded over the client axis, which the
    kernels cannot take, so it is materialized as the reference's is.
    """
    for v in batches.values():
        if v.shape[1] != K:
            raise ValueError(f"batch leaf has {v.shape[1]} local steps, "
                             f"expected K={K}")
    updates, losses = vmap(lambda b: device_update(loss_fn, params, b, eta,
                                                   weight_decay))(batches)
    return tree_map(torch.Tensor.contiguous, updates), losses
