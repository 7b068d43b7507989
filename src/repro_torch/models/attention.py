"""Attention for the ported models: GQA projections (+RoPE, QKV bias),
blockwise attention for training, prefill through the flash-attention
kernel, decode over a KV cache, and DeepSeek-V2's MLA (compressed-KV
attention) (counterpart of `repro/models/attention.py`).

Serving's prefill attention (q, k, v of one length, full or with a
sliding window) goes through `kernels.ops.attention`: the hand-written CUDA
kernel on the card, its plain version on the CPU. The training forward goes
through `blockwise_attention`, the reference's differentiable model
function, windowed as the reference windows it: the kernel is forward-only
and cannot run under `torch.func` transforms, and the reference's training
path calls no kernel either. Decode attends one query over the cache (a ring of the last `window`
positions for a windowed layer) in plain PyTorch: the JAX package has no
decode kernel and the port adds none.

MLA caches a compressed row `c` (kv_lora wide) and one roped key `pe`
(rope_hd wide) a position. Its prefill decompresses K and V per head and
attends with q/k head dim nope_hd + rope_hd and v head dim v_hd through
the attention function it is given (the kernel in serving, the
differentiable `blockwise_attention` in training); its decode is the
reference's absorbed form over the compressed cache, in plain PyTorch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import _device_init, apply_rope
from repro_torch.models.remat import checkpoint

NEG_INF = -1e30
# decode casts the k cache to f32 this many elements at a time: a chunk's
# f32 copy (and the batched product's own copy of it) stays at 1 GiB
# however long the cache, where the whole cache at once held 34.4 GB of
# f32 copies for a layer of qwen1.5-110b at B 128 over 32768 slots
DECODE_F32_CHUNK = 1 << 28


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
                rope_theta: float, n_heads: int, n_kv: int, head_dim: int,
                *, kv_gather=None, x_kv: torch.Tensor | None = None):
    """x (B,S,d) -> q (B,S,H,hd), k, v (B,S,KV,hd) with rope applied to
    q and k.

    Under split products (`sharding.tensor_parallel`) the weights and
    biases are this rank's column blocks, and the head counts are read
    from their widths (H/M and KV/M, or H and KV where a block is whole);
    `kv_gather(t)` (B,S,cols) -> (B,S,KV·hd) gathers k's and v's columns
    whole before they are cut into heads (their blocks may split a
    head), and `x_kv` (default `x`) is k's and v's input where it differs
    from q's (the training split's, whose collectives differ)."""
    B, S, _ = x.shape
    x_kv = x if x_kv is None else x_kv
    q = x @ params["wq"]
    k = x_kv @ params["wk"]
    v = x_kv @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if kv_gather is not None:
        k, v = kv_gather(k), kv_gather(v)
    q = q.reshape(B, S, q.shape[-1] // head_dim, head_dim)
    k = k.reshape(B, S, k.shape[-1] // head_dim, head_dim)
    v = v.reshape(B, S, v.shape[-1] // head_dim, head_dim)
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

    q (B,S,H,hd); k (B,T,KV,hd), v (B,T,KV,dv) with H % KV == 0 (dv may
    differ from hd, as MLA's does; the scale is q's), queries and keys at
    positions 0..S-1 and 0..T-1. Each query block (`_pick_block`) takes one
    f32 softmax over its keys, masked with NEG_INF; q·scale is rounded to
    q's dtype before the scores and the probabilities to q's dtype before
    P·V, where the reference rounds them. With `window` > 0 (T == S) a
    query keeps the keys t with s - window < t (and t <= s when causal),
    and the block at q0 scores only the keys [q0 - window, q0 + bq), padded
    in front with zeros as the reference pads them: O(bq·(window + bq))
    scores a block instead of O(bq·T). Differentiable, with no in-place op,
    so `torch.func.vmap` and `grad` run through it. With more than one
    block, each block's scores, mask, softmax and P·V go through
    `remat.checkpoint`, as the reference's `jax.checkpoint` of its block
    body, whatever `cfg.remat` says: the backward pass keeps the block's
    queries and the keys and values it reads (views, no copy) and
    recomputes its (B,H,bq,T) f32 probabilities, instead of keeping every
    block's.
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

    def block(q0: int):
        def attend(qi, kk, vv):
            qpos = q0 + torch.arange(bq, device=qi.device)
            if window > 0:  # padded row q0 + i holds key q0 - window + i
                kpos = q0 - window + torch.arange(span, device=qi.device)
            else:
                kpos = torch.arange(T, device=qi.device)
            scores = torch.einsum("bqhk,bthk->bhqt", qi.float(), kk)
            mask = kpos[None, :] <= qpos[:, None] if causal else None
            if window > 0:
                edge = (kpos[None, :] > qpos[:, None] - window) & (kpos >= 0)
                mask = edge if mask is None else mask & edge
            if mask is not None:
                scores = torch.where(mask, scores, NEG_INF)
            p = torch.softmax(scores, dim=-1).to(qi.dtype)
            return torch.einsum("bhqt,bthk->bqhk", p, vv)

        qi = q_scaled[:, q0:q0 + bq]
        if window > 0:
            kk, vv = kf[:, q0:q0 + span], v[:, q0:q0 + span]
        else:
            kk, vv = kf, v
        return (checkpoint(attend, qi, kk, vv) if S > bq
                else attend(qi, kk, vv))

    return torch.cat([block(q0) for q0 in range(0, S, bq)], dim=1)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """Exact prefill attention, q (B,S,H,hd), k (B,S,KV,hd) and v
    (B,S,KV,dv) with queries and keys at the same positions 0..S-1 ->
    (B,S,H,dv); a window (causal only, as the kernel takes it) keeps each
    query's last `window` keys."""
    return ops.attention(q, k, v, causal=causal, window=window)


def _decode_scores(q: torch.Tensor, k_cache: torch.Tensor, pos: int,
                   window: int, lo: int = 0, slots: int = 0) -> torch.Tensor:
    """The masked f32 scores (B,KV,g,C) of q (B,1,H,hd) over a cache
    block (B,C,KV,hd) holding slots lo..lo+C-1 of a cache of `slots`
    slots (default: the block is the whole cache)."""
    B, _, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    slots = slots or C
    slot = lo + torch.arange(C, device=q.device)
    if window > 0:
        valid = pos - torch.remainder(pos - slot, slots) >= 0
    else:
        valid = slot <= pos
    qs = (q * (1.0 / math.sqrt(hd))).reshape(B, KV, g, hd).float()
    step = max(1, DECODE_F32_CHUNK // (B * KV * hd))
    scores = torch.cat([torch.einsum("bkgd,btkd->bkgt", qs,
                                     k_cache[:, t:t + step].float())
                        for t in range(0, C, step)], dim=-1)
    return scores.masked_fill(~valid, NEG_INF)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: int, *, window: int = 0
                  ) -> torch.Tensor:
    """q (B,1,H,hd); caches (B,C,KV,hd); pos = the current position.

    For window>0 the cache is a ring buffer of size C == window: slot j
    holds absolute position pos - ((pos - j) mod C). Otherwise slot j holds
    position j, valid iff j <= pos. Scores and softmax in f32, the
    probabilities cast to q's dtype before P·V, as in the reference. The
    scores are taken over runs of slots, each cast to f32 on its own
    (`DECODE_F32_CHUNK`): every score is an f32 dot product of the same
    terms.
    """
    B, _, H, hd = q.shape
    scores = _decode_scores(q, k_cache, pos, window)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache)
    return out.reshape(B, 1, H, hd)


def decode_attend_partial(q: torch.Tensor, k_block: torch.Tensor,
                          v_block: torch.Tensor, pos: int, *, lo: int,
                          slots: int, window: int = 0):
    """`decode_attend` over one block of a cache split over its slots:
    q (B,1,H,hd) of every head; k_block, v_block (B,n,KV,hd) slots
    lo..lo+n-1 of a cache of `slots` slots (a ring where window > 0, its
    slots mapped to positions as `decode_attend` maps them). Returns the
    block's output o (B,KV,g,hd), normalised over the block alone (its f32
    softmax cast to q's dtype before P·V, as `decode_attend` casts it), and
    the f32 log-sum-exp lse (B,KV,g) of the block's scores:
    `combine_partials` joins the blocks."""
    scores = _decode_scores(q, k_block, pos, window, lo, slots)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return (torch.einsum("bkgt,btkd->bkgd", p, v_block),
            torch.logsumexp(scores, dim=-1))


def combine_partials(o: torch.Tensor, lse: torch.Tensor, axis
                     ) -> torch.Tensor:
    """Attention over the whole cache from every rank's
    `decode_attend_partial` (o (B,KV,g,hd), lse (B,KV,g)) over the ranks
    of `axis` (`sharding.tensor_parallel.ModelAxis`): the max L of the
    lse over the ranks, each block weighted by w = exp(lse − L), and
    Σ w·o / Σ w over the ranks, summed in f32. Returns (B,1,H,hd) in o's
    dtype. A block with no valid slot has lse ≈ NEG_INF and w = 0."""
    B, KV, g, hd = o.shape
    w = torch.exp(lse - axis.max(lse))
    num = axis.sum(o.float() * w[..., None])
    return (num / axis.sum(w)[..., None]).to(o.dtype).reshape(
        B, 1, KV * g, hd)


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, pos: int, *,
                window: int = 0) -> None:
    """Write one token's k, v (B,1,KV,hd) at `pos` (ring-buffered if
    window>0) into the caches, in place."""
    slot = pos % k_cache.shape[1] if window > 0 else pos
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]


# --------------------------------------------------------------------------- #
# MLA (DeepSeek-V2): compressed-KV attention
# --------------------------------------------------------------------------- #

def mla_init(gen: torch.Generator, d: int, n_heads: int, kv_lora: int,
             rope_hd: int, nope_hd: int, v_hd: int, dtype: torch.dtype
             ) -> dict:
    """Flat weight layout (d, H*...), as `gqa_init`; every leaf drawn on
    `gen`'s device."""
    return {"wq": _device_init(gen, (d, n_heads * (nope_hd + rope_hd)),
                               dtype),
            "w_dkv": _device_init(gen, (d, kv_lora), dtype),
            "w_kpe": _device_init(gen, (d, rope_hd), dtype),
            "w_uk": _device_init(gen, (kv_lora, n_heads * nope_hd), dtype),
            "w_uv": _device_init(gen, (kv_lora, n_heads * v_hd), dtype),
            "wo": _device_init(gen, (n_heads * v_hd, d), dtype)}


def mla_compress(params: dict, x: torch.Tensor, positions: torch.Tensor,
                 rope_theta: float):
    """x (B,S,d) -> c_kv (B,S,r), k_pe (B,S,rope_hd) with rope applied."""
    c_kv = x @ params["w_dkv"]
    k_pe = (x @ params["w_kpe"])[:, :, None, :]       # (B,S,1,rope_hd)
    k_pe = apply_rope(k_pe, positions, rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def _mla_dims(params: dict, nope_hd: int):
    rope_hd = params["w_kpe"].shape[1]
    H = params["wq"].shape[1] // (nope_hd + rope_hd)
    v_hd = params["w_uv"].shape[1] // H
    return H, rope_hd, v_hd


def mla_queries(params: dict, x: torch.Tensor, positions: torch.Tensor,
                rope_theta: float, nope_hd: int):
    """x (B,S,d) -> q_nope (B,S,H,nope_hd), q_pe (B,S,H,rope_hd) roped."""
    B, S, _ = x.shape
    H, rope_hd, _ = _mla_dims(params, nope_hd)
    q = (x @ params["wq"]).reshape(B, S, H, nope_hd + rope_hd)
    q_nope, q_pe = q[..., :nope_hd], q[..., nope_hd:]
    return q_nope, apply_rope(q_pe, positions, rope_theta)


def mla_prefill(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                rope_theta: float, nope_hd: int, causal: bool = True,
                attend=prefill_attention) -> tuple:
    """x (B,S,d) -> (out (B,S,d), (c_kv, k_pe) for the cache).

    K and V are decompressed per head: k_full is k_nope with k_pe
    repeated to every head, (B,S,H,nope_hd + rope_hd), and v is
    (B,S,H,v_hd); `attend(q, k, v, causal=)` scales by q's head dim.
    No in-place op, so `torch.func` runs through it with a differentiable
    `attend`."""
    B, S, _ = x.shape
    H, rope_hd, v_hd = _mla_dims(params, nope_hd)
    c_kv, k_pe = mla_compress(params, x, positions, rope_theta)
    q_nope, q_pe = mla_queries(params, x, positions, rope_theta, nope_hd)
    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, H, nope_hd)
    v = (c_kv @ params["w_uv"]).reshape(B, S, H, v_hd)
    k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        B, S, H, rope_hd)], dim=-1)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    ctx = attend(q_full, k_full, v, causal=causal)
    out = ctx.reshape(B, S, H * v_hd) @ params["wo"]
    return out, (c_kv, k_pe)


def mla_decode(params: dict, x: torch.Tensor, pos: int,
               c_cache: torch.Tensor, pe_cache: torch.Tensor, *,
               rope_theta: float, nope_hd: int):
    """Absorbed single-token MLA decode: x (B,1,d); c_cache (B,C,r) and
    pe_cache (B,C,rope_hd), this token's row written at `pos` in place.
    Returns (out (B,1,d), (c_cache, pe_cache)).

    Scores are taken in the compressed space, (W_uk^T q_nope)·c +
    q_pe·k_pe, and the context re-expanded once: W_uv (Σ_t p_t c_t). As
    in the reference, q_c, the summed and scaled scores, ctx_c and ctx
    are in x's dtype; the mask and the softmax in f32, p cast back."""
    positions = torch.tensor([pos], device=x.device)
    c_new, pe_new = mla_compress(params, x, positions, rope_theta)
    c_cache[:, pos] = c_new[:, 0]
    pe_cache[:, pos] = pe_new[:, 0]
    q_nope, q_pe = mla_queries(params, x, positions, rope_theta, nope_hd)
    B = x.shape[0]
    H, rope_hd, v_hd = _mla_dims(params, nope_hd)
    r = c_cache.shape[-1]
    w_uk = params["w_uk"].reshape(r, H, nope_hd)
    w_uv = params["w_uv"].reshape(r, H, v_hd)
    scale = 1.0 / math.sqrt(nope_hd + rope_hd)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)       # (B,1,H,r)
    scores = (torch.einsum("bshr,btr->bhst", q_c, c_cache)
              + torch.einsum("bshk,btk->bhst", q_pe, pe_cache)) * scale
    valid = torch.arange(c_cache.shape[1], device=x.device) <= pos
    scores = scores.float().masked_fill(~valid, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx_c = torch.einsum("bhst,btr->bshr", p, c_cache)       # (B,1,H,r)
    ctx = torch.einsum("bshr,rhk->bshk", ctx_c, w_uv)        # (B,1,H,v_hd)
    out = ctx.reshape(B, 1, H * v_hd) @ params["wo"]
    return out, (c_cache, pe_cache)
