"""Layer-stack assembly for training and serving: segments of homogeneous
blocks (counterpart of `repro/models/transformer.py`).

A model is a sequence of *segments*, each a maximal run of layers with the
same (block kind, ffn kind). A segment's params and cache leaves are
stacked along a leading layer axis under the reference's keys
(`{"segments": {"0": ...}, "shared_attn": ...}`), so trees map leaf by leaf
between the two packages; where the reference scans a segment with
`lax.scan`, the port loops over the layer axis. Zamba2's shared attention
block is stored once at the top level and used by every `shared_attn`
segment.

Ported block kinds: 'attn' (GQA, full), 'local_attn' (GQA with gemma3's
sliding window), 'shared_attn' (windowed when `shared_attn_window` > 0),
'mla' (DeepSeek-V2's compressed-KV attention: its cache holds `c` and
`pe` a position, its prefill attends through the kernel with a value
head dim of its own, its decode is the absorbed form) and 'ssm' (Mamba2);
FFN kinds 'mlp', 'moe' (`models.moe`, with shared experts and
`first_dense_layers`) and None. A windowed segment's cache is a ring of
min(window, cache_len) slots: position p sits in slot p mod C.
`prefill`, `decode` and `forward` sum the MoE layers' load-balance losses
in layer order, as the reference does; decode routes the whole batch's B
tokens in one call, so its expert capacity is that of B tokens.

`forward` is the training forward: differentiable torch ops with no
in-place write and no kernel call (`attention.blockwise_attention`, also
under MLA, and `ssm.ssd_chunked`), so `torch.func.vmap` and `grad` run
through it on both devices, as the reference differentiates its own jnp
model path. Under `cfg.remat` each layer, a stacked one or a use of the
shared attention block, goes through `remat.checkpoint`, as the reference
wraps each in `jax.checkpoint`: the backward pass keeps the layer's input
x (B,S,d) and its params, and runs the layer again. Remat changes memory
and time, never numbers. `prefill` and `decode` take no remat: the
reference's remat of its prefill scan sits under no derivative and changes
neither its numbers nor its memory.
Serving's `prefill` and `decode` write caches in place: they fill the cache
tree they are given and return it; `prefill` goes through the kernels.

Split products (`sharding.tensor_parallel`): `prefill` and `decode` take
a `ServeSplit`, and each GQA layer then runs on this rank's blocks of its
params and cache (`_gqa_prefill_split`, `_gqa_decode_split`, `_ffn`),
the activations whole between layers; `forward` takes a `TrainSplit`, and
each layer runs on the rank's blocks through collectives that
differentiate (`_gqa_train_split`); without one they are unchanged.

Head padding (`cfg.pad_q_heads`, `cfg.pad_kv_heads`, which
`launch.specs.plan(pad_heads=True)` sets): the training forward and the
prefill zero-pad q, k and v to those head counts before attention (the
prefill's kernel runs at the padded shape) and drop the padded query
heads after it, as the reference's `_gqa` / `_unpad_ctx` do; decode never
pads, and caches hold the real kv heads (`_unpad_kv`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (mlp_apply, mlp_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.remat import checkpoint
from repro_torch.tree import tree_index, tree_map


def _radd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Residual add that keeps the activation dtype."""
    return x + y.to(x.dtype)


def _attn_out(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = ctx.shape
    return ctx.reshape(B, S, H * hd) @ wo


@dataclass(frozen=True)
class SegmentSpec:
    index: int
    kind: str        # attn | local_attn | mla | ssm | shared_attn
    ffn: str | None  # mlp | moe | None
    n_layers: int
    window: int = 0  # >0 for local_attn


def build_segments(cfg: ArchConfig) -> list[SegmentSpec]:
    specs: list[tuple[str, str | None, int]] = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "attn" and cfg.kv_lora_rank:
            kind = "mla"
        if kind in ("ssm", "shared_attn"):
            ffn = None
        elif cfg.is_moe and i >= cfg.first_dense_layers:
            ffn = "moe"
        else:
            ffn = "mlp"
        if kind == "local_attn":
            window = cfg.swa_window
        elif kind == "shared_attn":
            window = cfg.shared_attn_window
        else:
            window = 0
        specs.append((kind, ffn, window))

    segments: list[SegmentSpec] = []
    run_start = 0
    for i in range(1, len(specs) + 1):
        if i == len(specs) or specs[i] != specs[run_start]:
            kind, ffn, window = specs[run_start]
            segments.append(SegmentSpec(len(segments), kind, ffn,
                                        i - run_start, window))
            run_start = i
    return segments


# block kinds of grouped-query attention with an optional window
_GQA_KINDS = ("attn", "local_attn", "shared_attn")


def _gqa(lp: dict, h: torch.Tensor, positions: torch.Tensor,
         cfg: ArchConfig, pad: bool = True):
    """q, k, v of a GQA layer; with `pad` (and `cfg.pad_q_heads` /
    `cfg.pad_kv_heads` set, as `launch.specs.plan(pad_heads=True)` sets
    them) q's and k, v's head axes zero-padded to those counts, as the
    reference pads them for its tensor-parallel layout. Attention then
    groups heads by pad_q // pad_kv, not H // KV: a real query head whose
    group falls on a zero kv head attends to zero keys and values and gets
    ctx = 0 (the reference's numbers, kept)."""
    q, k, v = attn_lib.gqa_project(lp["attn"], h, positions, cfg.rope_theta,
                                   cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim)
    if not pad:
        return q, k, v
    if cfg.pad_q_heads and cfg.pad_q_heads > cfg.n_heads:
        q = F.pad(q, (0, 0, 0, cfg.pad_q_heads - cfg.n_heads))
    if cfg.pad_kv_heads and cfg.pad_kv_heads > cfg.n_kv_heads:
        extra = (0, 0, 0, cfg.pad_kv_heads - cfg.n_kv_heads)
        k, v = F.pad(k, extra), F.pad(v, extra)
    return q, k, v


def _unpad_ctx(ctx: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Drop the padded query heads' outputs."""
    if cfg.pad_q_heads and cfg.pad_q_heads > cfg.n_heads:
        return ctx[:, :, :cfg.n_heads, :]
    return ctx


def _unpad_kv(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig):
    """Caches store the real (unpadded) kv heads."""
    if cfg.pad_kv_heads and cfg.pad_kv_heads > cfg.n_kv_heads:
        return k[:, :, :cfg.n_kv_heads, :], v[:, :, :cfg.n_kv_heads, :]
    return k, v


# --------------------------------------------------------------------------- #
# Parameter init
# --------------------------------------------------------------------------- #

def _layer_init(gen: torch.Generator, spec: SegmentSpec, cfg: ArchConfig,
                dtype: torch.dtype) -> dict:
    dev = gen.device
    p: dict = {}
    if spec.kind in _GQA_KINDS:
        p["ln1"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["attn"] = attn_lib.gqa_init(gen, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.resolved_head_dim,
                                      cfg.qkv_bias, dtype)
    elif spec.kind == "mla":
        p["ln1"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["attn"] = attn_lib.mla_init(gen, cfg.d_model, cfg.n_heads,
                                      cfg.kv_lora_rank, cfg.rope_head_dim,
                                      cfg.nope_head_dim, cfg.v_head_dim,
                                      dtype)
    elif spec.kind == "ssm":
        p["ln1"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["mixer"] = ssm_lib.mamba2_init(gen, cfg.d_model, cfg.ssm_expand,
                                         cfg.ssm_headdim, cfg.ssm_state,
                                         cfg.ssm_conv_width, dtype)
    if spec.kind == "shared_attn" or spec.ffn == "mlp":
        p["ln2"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    elif spec.ffn == "moe":
        p["ln2"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["moe"] = moe_lib.moe_init(gen, cfg.d_model, cfg.expert_d_ff,
                                    cfg.n_experts, cfg.n_shared_experts,
                                    dtype)
    return p


def _segment_init(gen: torch.Generator, spec: SegmentSpec, cfg: ArchConfig,
                  dtype: torch.dtype) -> dict:
    """The segment's layers drawn in order, each copied into its slice of
    a stacked leaf allocated once: the peak is the segment and one layer,
    not twice the segment (a 48-layer MoE segment is 56 GB in bf16)."""
    first = _layer_init(gen, spec, cfg, dtype)
    out = tree_map(lambda t: t.new_empty((spec.n_layers,) + tuple(t.shape)),
                   first)
    for i in range(spec.n_layers):
        layer = first if i == 0 else _layer_init(gen, spec, cfg, dtype)
        tree_map(lambda dst, src: dst[i].copy_(src), out, layer)
        first = layer = None
    return out


def init_segments(gen: torch.Generator, cfg: ArchConfig,
                  dtype: torch.dtype) -> dict:
    """Returns {'segments': {str(i): stacked params}, 'shared_attn': ...?},
    every leaf drawn on `gen`'s device."""
    out: dict = {"segments": {}}
    segments = build_segments(cfg)
    shared = next((s for s in segments if s.kind == "shared_attn"), None)
    if shared is not None:
        out["shared_attn"] = _layer_init(gen, shared, cfg, dtype)
    for seg in segments:
        if seg.kind == "shared_attn":
            out["segments"][str(seg.index)] = {}  # params live at top level
            continue
        out["segments"][str(seg.index)] = _segment_init(gen, seg, cfg, dtype)
    return out


# --------------------------------------------------------------------------- #
# Caches
# --------------------------------------------------------------------------- #

def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype: torch.dtype, device) -> dict:
    """Zero caches for every segment, stacked along the segment's layer
    axis (a shared_attn segment's has no layer axis, as in the reference);
    a windowed segment keeps a ring of min(window, cache_len) slots."""
    cache: dict = {}
    hd = cfg.resolved_head_dim
    for seg in build_segments(cfg):
        n = seg.n_layers
        if seg.kind in _GQA_KINDS:
            c = min(seg.window, cache_len) if seg.window else cache_len
            shp = (batch, c, cfg.n_kv_heads, hd)
            if seg.kind != "shared_attn":
                shp = (n,) + shp
            cache[str(seg.index)] = {
                "k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}
        elif seg.kind == "mla":
            cache[str(seg.index)] = {
                "c": torch.zeros((n, batch, cache_len, cfg.kv_lora_rank),
                                 dtype=dtype, device=device),
                "pe": torch.zeros((n, batch, cache_len, cfg.rope_head_dim),
                                  dtype=dtype, device=device)}
        elif seg.kind == "ssm":
            _, n_heads, conv_ch, _ = ssm_lib.mamba2_dims(
                cfg.d_model, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state,
                cfg.ssm_conv_width)
            cache[str(seg.index)] = {
                "state": torch.zeros((n, batch, n_heads, cfg.ssm_headdim,
                                      cfg.ssm_state), dtype=torch.float32,
                                     device=device),
                "conv": torch.zeros((n, batch, cfg.ssm_conv_width - 1,
                                     conv_ch), dtype=dtype, device=device)}
    return cache


# --------------------------------------------------------------------------- #
# Prefill (fill caches) and decode (consume caches)
# --------------------------------------------------------------------------- #

def _ffn(lp: dict, x: torch.Tensor, spec: SegmentSpec, cfg: ArchConfig,
         split=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's FFN -> (x, the MoE load-balance loss or None); under
    `split` (a `tensor_parallel.GQASplit`) the MLP runs on the rank's
    w1/w3 column and w2 row blocks, its partial output summed, and an MoE
    block on the rank's experts (`moe.moe_apply(split=)`)."""
    if spec.kind == "shared_attn" or spec.ffn == "mlp":
        h = rmsnorm(lp["ln2"], x)
        if split is None:
            return _radd(x, mlp_apply(lp["mlp"], h)), None
        return _radd(x, split.mlp_out(mlp_apply(lp["mlp"],
                                                split.mlp_in(h)))), None
    if spec.ffn == "moe":
        y, aux = moe_lib.moe_apply(lp["moe"], rmsnorm(lp["ln2"], x),
                                   top_k=cfg.top_k,
                                   capacity_factor=cfg.moe_capacity_factor,
                                   aux_coef=cfg.router_aux_coef,
                                   split=split)
        return _radd(x, y), aux
    return x, None


def _fill_slots(buf: torch.Tensor, new: torch.Tensor, lo: int, slots: int,
                ring: bool) -> None:
    """Write the prompt's `new` (B,S,...) into `buf` (B,n,...), slots
    lo..lo+n-1 of a cache of `slots` slots, in place: position p at slot
    p, or in a ring the last `slots` positions, p at slot p mod slots (the
    reference's `_ring_fill` where the block is the whole ring)."""
    n, S = buf.shape[1], new.shape[1]
    first = max(S - slots, 0) if ring else 0
    pos = torch.arange(first, S, device=buf.device)
    slot = pos % slots if ring else pos
    keep = (slot >= lo) & (slot < lo + n)
    buf[:, slot[keep] - lo] = new[:, pos[keep]].to(buf.dtype)


def _project_split(p: dict, h: torch.Tensor, positions: torch.Tensor,
                   cfg: ArchConfig, split):
    """q of this rank's query heads; k and v of its kv heads where the
    cache is split over them, else gathered whole."""
    gather = ((lambda t: split.axis.gather(t, -1)) if split.kv_gathered
              else None)
    return attn_lib.gqa_project(p, h, positions, cfg.rope_theta,
                                cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, kv_gather=gather)


def _gqa_prefill_split(p: dict, h: torch.Tensor, positions: torch.Tensor,
                       entry: dict, spec: SegmentSpec, cfg: ArchConfig,
                       split) -> torch.Tensor:
    """A GQA layer's attention output over the prompt on this rank's
    blocks (`tensor_parallel.GQASplit`): its query heads attend through
    `prefill_attention` (the kernel on the card) to the kv heads their
    groups map to, and it writes its block of the cache."""
    q, k, v = _project_split(p, h, positions, cfg, split)
    kq, vq = (k, v) if split.cache == "heads" else split.kv_for_heads(k, v)
    ctx = attn_lib.prefill_attention(q, kq.contiguous(), vq.contiguous(),
                                     causal=cfg.causal, window=spec.window)
    lo, _ = split.slot_block
    for name, t in (("k", k), ("v", v)):
        _fill_slots(entry[name], t, lo, split.slots, bool(spec.window))
    return split.out(_attn_out(ctx, p["wo"]))


def _gqa_decode_split(p: dict, h: torch.Tensor, pos: int, entry: dict,
                      spec: SegmentSpec, cfg: ArchConfig, split
                      ) -> torch.Tensor:
    """A GQA layer's attention output for one token on this rank's blocks:
    a head-split cache is written and read locally; a cache split over its
    slots is written by the rank that holds the token's slot and read by
    every rank for every head (q gathered), the partial softmaxes combined
    (`attention.combine_partials`) and the rank's heads kept; a whole
    cache is written and read whole on every rank."""
    q, k, v = _project_split(p, h, torch.tensor([pos], device=h.device),
                             cfg, split)
    if split.cache == "heads":
        attn_lib.cache_write(entry["k"], entry["v"], k, v, pos,
                             window=spec.window)
        ctx = attn_lib.decode_attend(q, entry["k"], entry["v"], pos,
                                     window=spec.window)
        return split.out(_attn_out(ctx, p["wo"]))
    slot = pos % split.slots if spec.window else pos
    lo, hi = split.slot_block
    if lo <= slot < hi:
        entry["k"][:, slot - lo] = k[:, 0]
        entry["v"][:, slot - lo] = v[:, 0]
    if split.heads:
        q = split.axis.gather(q, 2)
    if split.cache == "seq":
        o, lse = attn_lib.decode_attend_partial(
            q, entry["k"], entry["v"], pos, lo=lo, slots=split.slots,
            window=spec.window)
        ctx = attn_lib.combine_partials(o, lse, split.axis)
    else:
        ctx = attn_lib.decode_attend(q, entry["k"], entry["v"], pos,
                                     window=spec.window)
    a, b = split.head_block
    return split.out(_attn_out(ctx[:, :, a:b], p["wo"]))


def _gqa_train_split(p: dict, h: torch.Tensor, positions: torch.Tensor,
                     spec: SegmentSpec, cfg: ArchConfig, split
                     ) -> torch.Tensor:
    """A GQA layer's attention output in the training forward on this
    rank's blocks (`tensor_parallel.GQASplit` of a `TrainSplit`): q of
    its query heads from `to_model(h)`; k and v of its kv heads where M
    divides KV, else gathered whole and passed on through `to_model` (the
    rank's heads read part of them), or, where their columns are whole, k
    and v of every head from h itself, then through `to_model`; attention
    of its heads over the kv heads they group on (`kv_for_heads`),
    `blockwise_attention` as without a split, and the `wo` product summed
    by `from_model`. Where wq's columns are whole every rank computes the
    whole layer and nothing is summed."""
    from repro_torch.sharding.tensor_parallel import gather_model, to_model
    if not split.heads:
        q, k, v = _gqa(p, h, positions, cfg)
        ctx = attn_lib.blockwise_attention(q, k, v, causal=cfg.causal,
                                           window=spec.window)
        return _attn_out(ctx, p["attn"]["wo"])
    ax = split.axis
    if split.kv_gathered:
        def kv(t):
            return to_model(gather_model(t, -1, ax), ax)
    elif not split.kv_cols:
        def kv(t):
            return to_model(t, ax)
    else:
        kv = None
    q, k, v = attn_lib.gqa_project(p["attn"], to_model(h, ax), positions,
                                   cfg.rope_theta, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.resolved_head_dim,
                                   kv_gather=kv,
                                   x_kv=None if split.kv_cols else h)
    if kv is not None:
        k, v = split.kv_for_heads(k, v)
    ctx = attn_lib.blockwise_attention(q, k, v, causal=cfg.causal,
                                       window=spec.window)
    return split.out(_attn_out(ctx, p["attn"]["wo"]))


def _layer_prefill(lp: dict, x: torch.Tensor, positions: torch.Tensor,
                   entry: dict, spec: SegmentSpec, cfg: ArchConfig,
                   split=None):
    """One layer over the prompt; writes this layer's cache `entry` (no
    layer axis) in place. Returns (x, aux or None). Under `split` (a
    `tensor_parallel.GQASplit`) the layer runs on this rank's blocks."""
    h = rmsnorm(lp["ln1"], x)
    if split is not None:
        x = _radd(x, _gqa_prefill_split(lp["attn"], h, positions, entry,
                                        spec, cfg, split))
        return _ffn(lp, x, spec, cfg, split)
    if spec.kind in _GQA_KINDS:
        q, k, v = _gqa(lp, h, positions, cfg)
        ctx = attn_lib.prefill_attention(q, k, v, causal=cfg.causal,
                                         window=spec.window)
        x = _radd(x, _attn_out(_unpad_ctx(ctx, cfg), lp["attn"]["wo"]))
        k, v = _unpad_kv(k, v, cfg)
        if spec.window:
            for name, t in (("k", k), ("v", v)):
                _fill_slots(entry[name], t, 0, entry[name].shape[1], True)
        else:
            S = k.shape[1]
            entry["k"][:, :S] = k
            entry["v"][:, :S] = v
    elif spec.kind == "mla":
        out, (c_kv, k_pe) = attn_lib.mla_prefill(
            lp["attn"], h, positions, rope_theta=cfg.rope_theta,
            nope_hd=cfg.nope_head_dim, causal=cfg.causal,
            attend=attn_lib.prefill_attention)
        x = _radd(x, out)
        S = c_kv.shape[1]
        entry["c"][:, :S] = c_kv
        entry["pe"][:, :S] = k_pe
    else:
        out, (state, conv) = ssm_lib.mamba2_prefill(
            lp["mixer"], h, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
            d_state=cfg.ssm_state, chunk=cfg.ssm_chunk,
            conv_width=cfg.ssm_conv_width)
        x = _radd(x, out)
        entry["state"].copy_(state)
        entry["conv"].copy_(conv)
    return _ffn(lp, x, spec, cfg)


def _layer_decode(lp: dict, x: torch.Tensor, pos: int, entry: dict,
                  spec: SegmentSpec, cfg: ArchConfig, split=None):
    """Single-token step through one layer; updates `entry` in place.
    Returns (x, aux or None). Under `split` the layer runs on this rank's
    blocks."""
    h = rmsnorm(lp["ln1"], x)
    if split is not None:
        x = _radd(x, _gqa_decode_split(lp["attn"], h, pos, entry, spec, cfg,
                                       split))
        return _ffn(lp, x, spec, cfg, split)
    if spec.kind in _GQA_KINDS:
        positions = torch.tensor([pos], device=x.device)
        # decode is single-token: the reference pads no heads here
        q, k, v = _gqa(lp, h, positions, cfg, pad=False)
        attn_lib.cache_write(entry["k"], entry["v"], k, v, pos,
                             window=spec.window)
        ctx = attn_lib.decode_attend(q, entry["k"], entry["v"], pos,
                                     window=spec.window)
        x = _radd(x, _attn_out(ctx, lp["attn"]["wo"]))
    elif spec.kind == "mla":
        out, _ = attn_lib.mla_decode(lp["attn"], h, pos, entry["c"],
                                     entry["pe"], rope_theta=cfg.rope_theta,
                                     nope_hd=cfg.nope_head_dim)
        x = _radd(x, out)
    else:
        out, (state, conv) = ssm_lib.mamba2_decode(
            lp["mixer"], h, entry["state"], entry["conv"],
            expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
            d_state=cfg.ssm_state, conv_width=cfg.ssm_conv_width)
        x = _radd(x, out)
        entry["state"].copy_(state)
        entry["conv"].copy_(conv)
    return _ffn(lp, x, spec, cfg)


def _checkpointed(layer_fn, lp: dict, x: torch.Tensor, step,
                  spec: SegmentSpec, cfg: ArchConfig, **kw):
    """layer_fn(lp, x, step, None, spec, cfg, **kw) through
    `remat.checkpoint`: x, `step` (the positions) and lp's leaves are its
    inputs; `spec`, `cfg` and `kw` (a `split=`, which holds no tensor) are
    closed over, so a split layer's backward issues its collectives again
    as it recomputes. Returns (x, aux), aux a 0-d zero without MoE."""
    leaves: list = []
    tree_map(leaves.append, lp)

    def body(x, step, *leaves):
        it = iter(leaves)
        return layer_fn(tree_map(lambda _: next(it), lp), x, step, None,
                        spec, cfg, **kw)

    return checkpoint(body, x, step, *leaves)


def _run(layer_fn, params: dict, x: torch.Tensor, step, cache,
         cfg: ArchConfig, remat: bool = False, split=None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every layer in order: layer_fn(lp, x, step, entry, spec, cfg) ->
    (x, aux or None), with `entry` this layer's cache (None without a
    cache); with `remat` (no cache) each layer through `_checkpointed`;
    under `split` (a `tensor_parallel.ServeSplit` or `TrainSplit`) each
    layer also takes its segment's `GQASplit` as `split=`. Each layer's params are taken
    as `tree_index(seg_params, i)`, outside any checkpoint. Returns (x,
    the summed aux, f32)."""
    aux = torch.zeros((), device=x.device)
    for seg in build_segments(cfg):
        kw = {} if split is None else {"split": split.segment(seg.index)}
        entry = None if cache is None else cache[str(seg.index)]
        if seg.kind == "shared_attn":
            layers = [(params["shared_attn"], entry)]
        else:
            seg_params = params["segments"][str(seg.index)]
            layers = [(tree_index(seg_params, i),
                       None if entry is None else tree_index(entry, i))
                      for i in range(seg.n_layers)]
        for lp, e in layers:
            if remat:
                x, a = _checkpointed(layer_fn, lp, x, step, seg, cfg, **kw)
            else:
                x, a = layer_fn(lp, x, step, e, seg, cfg, **kw)
            if a is not None:
                aux = aux + a
    return x, aux


def prefill(params: dict, x: torch.Tensor, positions: torch.Tensor,
            cache: dict, cfg: ArchConfig, split=None):
    """x (B,S,d) through every layer, filling `cache` in place.
    Returns (x, aux, cache). Under `split` (a
    `tensor_parallel.ServeSplit`) params and cache are this rank's blocks
    and x is whole."""
    x, aux = _run(_layer_prefill, params, x, positions, cache, cfg,
                  split=split)
    return x, aux, cache


def decode(params: dict, x: torch.Tensor, pos: int, cache: dict,
           cfg: ArchConfig, split=None):
    """One token x (B,1,d) at position `pos` through every layer, updating
    `cache` in place. Returns (x, aux, cache). `split` as in `prefill`."""
    x, aux = _run(_layer_decode, params, x, pos, cache, cfg, split=split)
    return x, aux, cache


def _layer_fwd(lp: dict, x: torch.Tensor, positions: torch.Tensor,
               entry: None, spec: SegmentSpec, cfg: ArchConfig, split=None):
    """One layer of the training forward (no cache). Returns (x, aux or
    None). Under `split` (a `tensor_parallel.GQASplit`) the layer runs on
    this rank's blocks."""
    h = rmsnorm(lp["ln1"], x)
    if split is not None:
        x = _radd(x, _gqa_train_split(lp, h, positions, spec, cfg, split))
        return _ffn(lp, x, spec, cfg, split)
    if spec.kind in _GQA_KINDS:
        q, k, v = _gqa(lp, h, positions, cfg)
        ctx = attn_lib.blockwise_attention(q, k, v, causal=cfg.causal,
                                           window=spec.window)
        x = _radd(x, _attn_out(_unpad_ctx(ctx, cfg), lp["attn"]["wo"]))
    elif spec.kind == "mla":
        out, _ = attn_lib.mla_prefill(
            lp["attn"], h, positions, rope_theta=cfg.rope_theta,
            nope_hd=cfg.nope_head_dim, causal=cfg.causal,
            attend=attn_lib.blockwise_attention)
        x = _radd(x, out)
    else:
        out, _ = ssm_lib.mamba2_prefill(
            lp["mixer"], h, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
            d_state=cfg.ssm_state, chunk=cfg.ssm_chunk,
            conv_width=cfg.ssm_conv_width, scan=ssm_lib.ssd_chunked)
        x = _radd(x, out)
    return _ffn(lp, x, spec, cfg)


def forward(params: dict, x: torch.Tensor, positions: torch.Tensor,
            cfg: ArchConfig, split=None):
    """The training forward: x (B,S,d) through every segment -> (x, aux),
    aux the MoE layers' summed load-balance loss (0 without MoE). Under
    `cfg.remat` every layer is rematerialized on the backward pass. Under
    `split` (a `tensor_parallel.TrainSplit`) params are this rank's blocks
    and x is whole."""
    return _run(_layer_fwd, params, x, positions, None, cfg,
                remat=cfg.remat, split=split)
