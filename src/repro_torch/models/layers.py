"""Shared layers for the ported models (counterpart of
`repro/models/layers.py`): norms, rope, the SwiGLU MLP, embeddings and the
losses.

Pure-functional: params are nested dicts of tensors. Initializers draw from
an explicit `torch.Generator`. They do not reproduce the JAX package's
`jax.random` draws: parity tests pass the reference's params in through
`repro_torch.convert.params_from_jax`. The tabular models draw on the CPU
and move the result (`_dense_init`), so their init is the same on every
device; the zoo draws each leaf on its target device with a generator that
lives there (`_device_init`), so a 7B model never passes through host f32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.remat import checkpoint
from repro_torch.sharding.tensor_parallel import to_model


def _dense_init(gen: torch.Generator, shape: tuple, dtype: torch.dtype,
                device: torch.device, scale: float | None = None
                ) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return w.to(device=device, dtype=dtype)


def _device_init(gen: torch.Generator, shape: tuple, dtype: torch.dtype,
                 scale: float | None = None) -> torch.Tensor:
    """The reference's `_dense_init` scaling, drawn in f32 on `gen`'s
    device and cast there."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale).to(dtype)


# --------------------------------------------------------------------------- #
# RMSNorm
# --------------------------------------------------------------------------- #

def rmsnorm_init(d: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary position embeddings
# --------------------------------------------------------------------------- #

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., :, None].float() * inv           # (..., S, hd/2)
    sin = torch.sin(ang)[..., :, None, :]                  # (..., S, 1, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# SwiGLU MLP
# --------------------------------------------------------------------------- #

def mlp_init(gen: torch.Generator, d: int, f: int, dtype: torch.dtype
             ) -> dict:
    return {"w1": _device_init(gen, (d, f), dtype),
            "w3": _device_init(gen, (d, f), dtype),
            "w2": _device_init(gen, (f, d), dtype)}


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #

def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype
               ) -> torch.Tensor:
    return _device_init(gen, (vocab, d), dtype, scale=0.02)


def head_init(gen: torch.Generator, d: int, vocab: int, dtype: torch.dtype
              ) -> torch.Tensor:
    return _device_init(gen, (d, vocab), dtype)


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #

class _VocabNLL(torch.autograd.Function):
    """-log softmax(logits)[label] over a vocab split across an axis's
    ranks, each holding its block of the logits (module function
    `vocab_split_nll`). Returns (nll, lse), lse carrying no gradient."""

    @staticmethod
    def forward(logits, labels, axis):
        vb = logits.shape[-1]
        # the shift carries no gradient: lse's own backward is softmax
        m = axis.max(logits.amax(-1))
        lse = axis.sum((logits - m.unsqueeze(-1)).exp().sum(-1)).log() + m
        idx = labels.long() - axis.rank * vb
        mine = (idx >= 0) & (idx < vb)
        gold = torch.gather(logits, -1, idx.clamp(0, vb - 1).unsqueeze(-1)
                            ).squeeze(-1)
        gold = axis.sum(torch.where(mine, gold, torch.zeros_like(gold)))
        return lse - gold, lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels, ctx.axis = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(logits, labels, output[1])

    @staticmethod
    def backward(ctx, g, _):
        logits, labels, lse = ctx.saved_tensors
        vb = logits.shape[-1]
        g = g.unsqueeze(-1)
        # softmax minus the one-hot, times the cotangent: g·p, and -g added
        # at the label where this rank's block holds it
        grad = g * (logits - lse.unsqueeze(-1)).exp()
        hit = (torch.arange(vb, device=logits.device)
               == (labels.long() - ctx.axis.rank * vb).unsqueeze(-1))
        return torch.where(hit, grad - g, grad), None, None

    @staticmethod
    def vmap(info, in_dims, logits, labels, axis):
        # the forward takes any leading dims: the batch dim goes first; the
        # Function is re-entered, so under a vmap around this one (a
        # fleet's trials) the collectives see a tensor of their own
        def first(x, d):
            return (x.movedim(d, 0) if d is not None
                    else x.expand((info.batch_size,) + tuple(x.shape)))
        out = _VocabNLL.apply(first(logits, in_dims[0]),
                              first(labels, in_dims[1]), axis)
        return out, (0, 0)


def vocab_split_nll(logits: torch.Tensor, labels: torch.Tensor, axis
                    ) -> torch.Tensor:
    """Each position's -log softmax(logits)[label] (f32) where `logits`
    (..., V/M) f32 is this rank's vocab block of the logits on `axis` (an
    object with `rank`, `size`, `sum` and `max` over its ranks, as
    `sharding.tensor_parallel.ModelAxis`): the row max through a max
    all-reduce (no gradient), the sum of the exp through a sum all-reduce,
    the gold logit from the rank whose block holds the label, sum-reduced;
    backward, on the rank's block, softmax minus the one-hot. On an axis of
    one rank it is `logsumexp - gather` as the unsplit losses take it, bit
    for bit."""
    return _VocabNLL.apply(logits, labels, axis)[0]


def chunked_lm_loss(h: torch.Tensor, lm_head: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor | None = None,
                    chunk: int = 512, axis=None) -> torch.Tensor:
    """Cross-entropy without materializing the full (B,S,V) logits at once.

    Loops over sequence chunks of the reference's size (`chunk`, at most S,
    halved until it divides S); each chunk's logits are taken in f32 with
    an f32 logsumexp. Each chunk's logits, logsumexp and gold go through
    `remat.checkpoint`, as the reference's chunk body goes through
    `jax.checkpoint`: the backward pass keeps the chunk's h and the head
    and recomputes its (B, chunk, V) f32 logits, so at most one chunk's
    logits are alive. With `axis` (`sharding.tensor_parallel.ModelAxis`)
    `lm_head` is this rank's vocab block: h enters it through
    `tensor_parallel.to_model` and each chunk takes `vocab_split_nll`.
    """
    B, S, _ = h.shape
    cs = min(chunk, S)
    while S % cs:
        cs //= 2
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    w = lm_head.to(h.dtype)
    if axis is not None:
        h = to_model(h, axis)
    for c0 in range(0, S, cs):
        mm = (torch.ones((B, cs), device=h.device) if mask is None
              else mask[:, c0:c0 + cs].float())
        ll = labels[:, c0:c0 + cs].long().unsqueeze(-1)

        def chunk_nll(hh, w, ll, mm):
            logits = (hh @ w).float()
            if axis is not None:
                return (vocab_split_nll(logits, ll.squeeze(-1), axis)
                        * mm).sum()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, ll).squeeze(-1)
            return ((lse - gold) * mm).sum()

        nll = nll + checkpoint(chunk_nll, h[:, c0:c0 + cs], w, ll, mm)
        cnt = cnt + mm.sum()
    return nll / cnt.clamp(min=1.0)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None, axis=None
                          ) -> torch.Tensor:
    """Mean CE over masked positions. logits (..., V) any float dtype; f32
    math. With `axis`, `logits` is this rank's vocab block
    (`vocab_split_nll`)."""
    logits = logits.float()
    if axis is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.long().unsqueeze(-1)).squeeze(-1)
        nll = lse - gold
    else:
        nll = vocab_split_nll(logits, labels, axis)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
