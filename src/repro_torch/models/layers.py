"""Shared layers for the ported models (counterpart of
`repro/models/layers.py`, cut to what the tabular path uses).

Pure-functional: params are nested dicts of tensors. Initializers draw from
an explicit `torch.Generator` on the CPU and then move to the target device,
so an init is the same on every device. They do not reproduce the JAX
package's `jax.random` draws: parity tests pass the reference's params in
through `repro_torch.convert.params_from_jax`. Norms, rope, attention MLPs
and the chunked LM loss are not ported yet (ROADMAP Queue 1 item 18).
"""
from __future__ import annotations

import numpy as np
import torch


def _dense_init(gen: torch.Generator, shape: tuple, dtype: torch.dtype,
                device: torch.device, scale: float | None = None
                ) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over masked positions. logits (..., V) any float dtype; f32 math."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
