"""Attention for the ported models: GQA projections (+RoPE, QKV bias),
blockwise attention for training, prefill through the flash-attention
kernel, and decode over a KV cache (counterpart of
`repro/models/attention.py`).

Serving's prefill attention (full, unwindowed, q, k, v of one length) goes
through `kernels.ops.attention`: the hand-written CUDA kernel on the card,
its plain version on the CPU. The training forward goes through
`blockwise_attention`, the reference's differentiable model function: the
kernel is forward-only and cannot run under `torch.func` transforms, and
the reference's training path calls no kernel either. Sliding windows
(gemma3's local layers, `shared_attn_window`) raise in both (ROADMAP Queue 1
item 18.1), and MLA waits for item 18.3. Decode attends one query over the
cache in plain PyTorch: the JAX package has no decode kernel and the port
adds none.
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


def _windowed() -> NotImplementedError:
    return NotImplementedError(
        "windowed attention (local_attn, shared_attn_window) is not "
        "ported: it waits for blockwise_attention's windowed path "
        "(ROADMAP Queue 1 entry 3, item 18.1)")


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_block: int = 0) -> torch.Tensor:
    """Exact attention over query blocks, the training path's attention.

    q (B,S,H,hd); k, v (B,T,KV,hd) with H % KV == 0, queries and keys at
    positions 0..S-1 and 0..T-1. Each query block (`_pick_block`) takes one
    f32 softmax over all its keys, masked with NEG_INF; q·scale is rounded
    to q's dtype before the scores and the probabilities to q's dtype before
    P·V, where the reference rounds them. Differentiable, with no in-place
    op, so `torch.func.vmap` and `grad` run through it. The reference
    rematerializes each block on the backward pass; here autograd keeps each
    block's probabilities.
    """
    if window > 0:
        raise _windowed()
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
    kf = k.float()
    kpos = torch.arange(T, device=q.device)
    outs = []
    for q0 in range(0, S, bq):
        qi = q_scaled[:, q0:q0 + bq]
        scores = torch.einsum("bqhk,bthk->bhqt", qi.float(), kf)
        if causal:
            qpos = q0 + torch.arange(bq, device=q.device)
            scores = torch.where(kpos[None, :] <= qpos[:, None], scores,
                                 NEG_INF)
        p = torch.softmax(scores, dim=-1).to(qi.dtype)
        outs.append(torch.einsum("bhqt,bthk->bqhk", p, v))
    return torch.cat(outs, dim=1)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """Exact prefill attention, q (B,S,H,hd), k, v (B,S,KV,hd) with
    queries and keys at the same positions 0..S-1 -> (B,S,H,hd)."""
    if window > 0:
        raise _windowed()
    return ops.attention(q, k, v, causal=causal)


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
