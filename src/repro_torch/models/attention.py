"""Attention for the ported models: GQA projections (+RoPE, QKV bias),
blockwise attention for training, prefill through the flash-attention
kernel, and decode over a KV cache (counterpart of
`repro/models/attention.py`).

Serving's prefill attention (q, k, v of one length, full or with a
sliding window) goes through `kernels.ops.attention`: the hand-written CUDA
kernel on the card, its plain version on the CPU. The training forward goes
through `blockwise_attention`, the reference's differentiable model
function, windowed as the reference windows it: the kernel is forward-only
and cannot run under `torch.func` transforms, and the reference's training
path calls no kernel either. MLA waits for ROADMAP Queue 1 item 18.3.
Decode attends one query over the cache (a ring of the last `window`
positions for a windowed layer) in plain PyTorch: the JAX package has no
decode kernel and the port adds none.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import _device_init, apply_rope

NEG_INF = -1e30


def gqa_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
             head_dim: int, qkv_bias: bool, dtype: torch.dtype) -> dict:
    """Weights kept flat (d, H*hd), as the reference keeps them;
    activations are reshaped to (B,S,H,hd) after the projection."""
    p = {"wq": _device_init(gen, (d, n_heads * head_dim), dtype),
         "wk": _device_init(gen, (d, n_kv * head_dim), dtype),
         "wv": _device_init(gen, (d, n_kv * head_dim), dtype),
         "wo": _device_init(gen, (n_heads * head_dim, d), dtype)}
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=gen.device)
    return p


def gqa_project(params: dict, x: torch.Tensor, positions: torch.Tensor,
                rope_theta: float, n_heads: int, n_kv: int, head_dim: int):
    """x (B,S,d) -> q (B,S,H,hd), k, v (B,S,KV,hd) with rope applied to
    q and k."""
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def _pick_block(s: int, target: int = 512) -> int:
    if s <= target:
        return s
    b = target
    while s % b:
        b //= 2
    return max(b, 1)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_block: int = 0) -> torch.Tensor:
    """Exact attention over query blocks, the training path's attention.

    q (B,S,H,hd); k, v (B,T,KV,hd) with H % KV == 0, queries and keys at
    positions 0..S-1 and 0..T-1. Each query block (`_pick_block`) takes one
    f32 softmax over its keys, masked with NEG_INF; q·scale is rounded to
    q's dtype before the scores and the probabilities to q's dtype before
    P·V, where the reference rounds them. With `window` > 0 (T == S) a
    query keeps the keys t with s - window < t (and t <= s when causal),
    and the block at q0 scores only the keys [q0 - window, q0 + bq), padded
    in front with zeros as the reference pads them: O(bq·(window + bq))
    scores a block instead of O(bq·T). Differentiable, with no in-place op,
    so `torch.func.vmap` and `grad` run through it. The reference
    rematerializes each block on the backward pass; here autograd keeps each
    block's probabilities.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    bq = q_block or _pick_block(S)
    if S % bq:
        raise ValueError(f"query block {bq} does not divide S={S}")
    q_scaled = (q * (1.0 / math.sqrt(hd))).to(q.dtype)
    if g > 1:  # kv head j serves query heads j·g .. j·g+g-1 (jnp.repeat)
        k = k[:, :, :, None].expand(B, T, KV, g, hd).reshape(B, T, H, hd)
        v = v[:, :, :, None].expand(B, T, KV, g, v.shape[-1]).reshape(
            B, T, H, v.shape[-1])
    if window > 0:
        if T != S:
            raise ValueError(f"windowed attention needs T == S (got S={S}, "
                             f"T={T}): queries and keys share positions")
        span = window + bq
        k, v = (torch.cat([x.new_zeros((B, window) + x.shape[2:]), x], dim=1)
                for x in (k, v))
    kf = k.float()
    outs = []
    for q0 in range(0, S, bq):
        qi = q_scaled[:, q0:q0 + bq]
        qpos = q0 + torch.arange(bq, device=q.device)
        if window > 0:  # padded row q0 + i holds key position q0 - window + i
            kk, vv = kf[:, q0:q0 + span], v[:, q0:q0 + span]
            kpos = q0 - window + torch.arange(span, device=q.device)
        else:
            kk, vv = kf, v
            kpos = torch.arange(T, device=q.device)
        scores = torch.einsum("bqhk,bthk->bhqt", qi.float(), kk)
        mask = kpos[None, :] <= qpos[:, None] if causal else None
        if window > 0:
            edge = (kpos[None, :] > qpos[:, None] - window) & (kpos >= 0)
            mask = edge if mask is None else mask & edge
        if mask is not None:
            scores = torch.where(mask, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(qi.dtype)
        outs.append(torch.einsum("bhqt,bthk->bqhk", p, vv))
    return torch.cat(outs, dim=1)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """Exact prefill attention, q (B,S,H,hd), k, v (B,S,KV,hd) with
    queries and keys at the same positions 0..S-1 -> (B,S,H,hd); a window
    (causal only, as the kernel takes it) keeps each query's last `window`
    keys."""
    return ops.attention(q, k, v, causal=causal, window=window)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: int, *, window: int = 0
                  ) -> torch.Tensor:
    """q (B,1,H,hd); caches (B,C,KV,hd); pos = the current position.

    For window>0 the cache is a ring buffer of size C == window: slot j
    holds absolute position pos - ((pos - j) mod C). Otherwise slot j holds
    position j, valid iff j <= pos. Scores and softmax in f32, the
    probabilities cast to q's dtype before P·V, as in the reference.
    """
    B, _, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    slots = torch.arange(C, device=q.device)
    if window > 0:
        valid = pos - torch.remainder(pos - slots, C) >= 0
    else:
        valid = slots <= pos
    qs = (q * (1.0 / math.sqrt(hd))).reshape(B, KV, g, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qs.float(), k_cache.float())
    scores = scores.masked_fill(~valid, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache)
    return out.reshape(B, 1, H, hd)


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, pos: int, *,
                window: int = 0) -> None:
    """Write one token's k, v (B,1,KV,hd) at `pos` (ring-buffered if
    window>0) into the caches, in place."""
    slot = pos % k_cache.shape[1] if window > 0 else pos
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]
