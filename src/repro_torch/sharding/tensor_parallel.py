"""Split matrix products on the serving path: each rank of a mesh's `model`
axis runs prefill and decode on its blocks of the params and caches, as the
reference's compiled SPMD program computes on the blocks its specs give
(`sharding.rules.param_specs`, `cache_specs`), with only the collectives
the split needs.

Scope: the dense GQA stack (`attn` and `local_attn` layers with a dense
MLP, the embedding and the head: granite-3-8b, qwen1.5-110b, gemma3-4b and
llava-next-34b's language stack). Everything else raises
NotImplementedError naming its ROADMAP entry (`unsupported`): training
(12b), MoE experts (12c), MLA (12d), Mamba2 and the shared attention block
(12e), padded heads and the encoder (12f), and params or caches split over
the data axis (12g).

Layout, read from the spec `rules.sanitize` left on each leaf (never from
the config), per GQA segment (`GQASplit`):

  * `wq`/`bq` column blocks and `wo` row blocks of whole heads (H/M a
    rank), whose partial outputs are summed over `model`; or whole where
    H·hd does not divide (every rank computes every head, nothing summed).
    Columns split inside a head raise (12f: the reference pads heads).
  * `wk`/`wv`/`bk`/`bv` column blocks, or whole.
  * the cache: over its kv heads where M divides KV ("heads": written and
    read locally, the rank's kv heads those its query heads group on);
    else over its slots where M divides them ("seq", the reference's
    flash-decode layout: k and v are gathered whole along their columns,
    which may split inside a head, each rank writes its block of slots,
    and decode combines every rank's partial softmax); else whole on every
    rank ("whole": k and v gathered, every rank writes all of it).
  * `w1`/`w3` column blocks and `w2` row blocks (summed), or whole.
  * the embedding's d_model block (the looked-up rows gathered along d)
    and `lm_head`'s vocab block (each rank keeps its block of the logits,
    the plan's `(batch, MODEL)` logits spec), or whole.

Transport: gloo on the tensors themselves, CUDA tensors included (gloo
stages them through the host). A probe on an H100 (`scripts/
gloo_cuda_probe.py`, PERF.md) found all_reduce (SUM and MAX) and
all_gather working on CUDA f32 and bf16 tensors in a world of two ranks on
one card, and no all_to_all in gloo (the split needs none); NCCL cannot
hold two ranks on one device. There is one route, with no switch at run
time: a collective that fails, fails the step. Sums are reduced in f32 and
cast back to the tensor's dtype, whatever it is, so the rounding stays
close to an unsplit product's (which sums its K dim in f32); max and
gather move the tensor's own dtype, exactly.

No autograd: the split steps run under `torch.inference_mode()`
(`launch.steps`). Every mesh whose `model` axis has extent 1 (every mesh
of a world of one) gives no split (`model_axis` is None), so its steps are
today's, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.sharding.params import block_shape
from repro_torch.sharding.rules import (MODEL, _entry_axes, axis_names,
                                        cache_specs, data_axis_size,
                                        mesh_shape, param_specs)
from repro_torch.tree import tree_map


class ModelAxis:
    """This rank's view of a DeviceMesh's `model` axis: its group, its
    coordinate on it and its extent M; `moved` counts the bytes this rank
    put into each kind of collective."""

    def __init__(self, mesh):
        names = axis_names(mesh)
        self.size = mesh_shape(mesh)[MODEL]
        self.rank = mesh.get_coordinate()[names.index(MODEL)]
        self.group = mesh.get_group(MODEL)
        self.moved = {"all_reduce": 0, "all_gather": 0}

    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.moved[kind] += x.numel() * x.element_size()

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the axis of every rank's `x`, reduced in f32 and cast
        back to x's dtype (a new tensor)."""
        import torch.distributed as dist
        y = x.to(torch.float32, copy=True)
        self._count("all_reduce", y)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y.to(x.dtype)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the axis (a new tensor)."""
        import torch.distributed as dist
        y = x.clone(memory_format=torch.contiguous_format)
        self._count("all_reduce", y)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `x` concatenated along `dim` in coordinate order."""
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._count("all_gather", x)
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)


def model_axis(mesh) -> ModelAxis | None:
    """The `model` axis of a DeviceMesh, or None where nothing splits: no
    mesh, an abstract mesh (it places nothing) or a `model` extent of 1."""
    if mesh is None or not hasattr(mesh, "get_group"):
        return None
    if mesh_shape(mesh).get(MODEL, 1) == 1:
        return None
    return ModelAxis(mesh)


def _splits(entry, mesh, axis: str = MODEL) -> bool:
    return axis in _entry_axes(entry) and mesh_shape(mesh)[axis] > 1


def unsupported(cfg, mesh, batch: int) -> str | None:
    """Why the serving steps of `cfg` at a batch of `batch` cannot run on
    `mesh`'s blocks (naming the ROADMAP entry that will take it), or None
    where they can."""
    from repro_torch.models.transformer import build_segments
    if cfg.encoder_only or cfg.modality == "audio":
        return (f"{cfg.name}: the encoder's frontend_proj under split "
                "products (ROADMAP entry 12f)")
    for seg in build_segments(cfg):
        if seg.ffn == "moe":
            return (f"{cfg.name}: MoE experts over `model` (ROADMAP entry "
                    "12c)")
        if seg.kind == "mla":
            return f"{cfg.name}: MLA under split products (ROADMAP entry 12d)"
        if seg.kind not in ("attn", "local_attn"):
            return (f"{cfg.name}: {seg.kind} layers under split products "
                    "(ROADMAP entry 12e)")
    if cfg.pad_q_heads or cfg.pad_kv_heads:
        return (f"{cfg.name}: padded heads under split products (ROADMAP "
                "entry 12f)")
    m = mesh_shape(mesh)[MODEL]
    hd = cfg.resolved_head_dim
    if cfg.n_heads % m and (cfg.n_heads * hd) % m == 0:
        return (f"{cfg.name}: {cfg.n_heads} query heads over a model axis "
                f"of {m} split wq's columns inside a head; the reference "
                "pads the heads for that (ROADMAP entry 12f)")
    d = data_axis_size(mesh)
    if d > 1 and (cfg.fsdp or batch % d or batch < d):
        return (f"{cfg.name}: params or caches split over the data axis "
                f"(fsdp {cfg.fsdp}, batch {batch} over {d} data ranks) "
                "under split products (ROADMAP entry 12g)")
    return None


@dataclass(frozen=True)
class GQASplit:
    """One GQA segment's layout under the split (module docstring)."""

    axis: ModelAxis
    heads: bool       # wq/bq columns and wo rows split, whole heads
    kv_cols: bool     # wk/wv/bk/bv columns split
    cache: str        # "heads" | "seq" | "whole"
    slots: int        # the whole cache's slots
    mlp: bool         # w1/w3 columns and w2 rows split
    n_heads: int      # the whole model's query heads

    @property
    def kv_gathered(self) -> bool:
        """k and v are gathered whole along their columns (the cache is
        not split over heads, and their columns are)."""
        return self.kv_cols and self.cache != "heads"

    @property
    def head_block(self) -> tuple[int, int]:
        """The query heads [lo, hi) this rank computes."""
        if not self.heads:
            return 0, self.n_heads
        n = self.n_heads // self.axis.size
        return self.axis.rank * n, (self.axis.rank + 1) * n

    @property
    def slot_block(self) -> tuple[int, int]:
        """The cache slots [lo, hi) this rank holds."""
        if self.cache != "seq":
            return 0, self.slots
        n = self.slots // self.axis.size
        return self.axis.rank * n, (self.axis.rank + 1) * n

    def out(self, partial: torch.Tensor) -> torch.Tensor:
        """The attention's output from this rank's `wo` product."""
        return self.axis.sum(partial) if self.heads else partial

    def mlp_out(self, partial: torch.Tensor) -> torch.Tensor:
        """The MLP's output from this rank's `w2` product."""
        return self.axis.sum(partial) if self.mlp else partial

    def kv_for_heads(self, k: torch.Tensor, v: torch.Tensor):
        """From whole k, v (B,T,KV,hd), the kv heads this rank's query
        heads read, laid out for grouped attention over them: the
        contiguous run of kv heads their groups map to where it groups them
        evenly, else one kv head a query head."""
        KV = k.shape[2]
        g = self.n_heads // KV
        lo, hi = self.head_block
        idx = torch.arange(lo, hi) // g
        a, b = int(idx[0]), int(idx[-1]) + 1
        if (hi - lo) % (b - a) == 0 and torch.equal(
                idx, torch.arange(a, b).repeat_interleave((hi - lo)
                                                          // (b - a))):
            return k[:, :, a:b], v[:, :, a:b]
        idx = idx.to(k.device)
        return k.index_select(2, idx), v.index_select(2, idx)


@dataclass
class ServeSplit:
    """The split of a config's serving steps on a mesh: the model axis,
    the embedding's and the head's layouts, each GQA segment's `GQASplit`,
    and the specs of the params and caches they were read from."""

    mesh: object
    axis: ModelAxis
    embed: bool              # embed's d_model split
    head: bool               # lm_head's vocab split
    param_specs: object
    cache_specs: object
    segments: dict = field(default_factory=dict)

    def segment(self, index: int) -> GQASplit:
        return self.segments[index]

    def zeros(self, tree, specs, device) -> object:
        """Zeros of this rank's blocks of `tree`'s whole leaves (any
        device, meta too) under `specs`, on `device`."""
        return tree_map(lambda t, s: torch.zeros(
            block_shape(tuple(t.shape), s, self.mesh, device,
                        serving=True), dtype=t.dtype, device=device),
            tree, specs)


def serve_split(cfg, mesh, batch: int | None, cache_len: int | None
                ) -> ServeSplit | None:
    """The split of `cfg`'s prefill and decode steps at `batch` sequences
    and a cache of `cache_len` positions on `mesh` (whole shapes: they fix
    the cache's layout), or None where `model_axis` gives none. Raises
    NotImplementedError for what the split does not take yet
    (`unsupported`)."""
    axis = model_axis(mesh)
    if axis is None:
        return None
    if batch is None or cache_len is None:
        raise ValueError("a serving step on a mesh whose model axis splits "
                         "needs the whole batch= and cache_len=: they fix "
                         "the cache's layout (sharding.rules.cache_specs)")
    why = unsupported(cfg, mesh, batch)
    if why is not None:
        raise NotImplementedError(why)
    from repro_torch.launch.specs import param_shapes
    from repro_torch.models import transformer
    from repro_torch.models.model import DTYPES
    pspecs = param_specs(param_shapes(cfg), cfg, mesh)
    cache = transformer.init_cache(cfg, batch, cache_len,
                                   DTYPES[cfg.compute_dtype], "meta")
    cspecs = cache_specs(cache, cfg, mesh, batch)
    out = ServeSplit(mesh, axis, embed=_splits(pspecs["embed"][1], mesh),
                     head=_splits(pspecs["lm_head"][1], mesh),
                     param_specs=pspecs, cache_specs=cspecs)
    for seg in transformer.build_segments(cfg):
        lp = pspecs["segments"][str(seg.index)]
        kspec = cspecs[str(seg.index)]["k"]
        cache_kind = ("heads" if _splits(kspec[-2], mesh) else
                      "seq" if _splits(kspec[-3], mesh) else "whole")
        out.segments[seg.index] = GQASplit(
            axis, heads=_splits(lp["attn"]["wq"][-1], mesh),
            kv_cols=_splits(lp["attn"]["wk"][-1], mesh), cache=cache_kind,
            slots=cache[str(seg.index)]["k"].shape[-3],
            mlp=_splits(lp["mlp"]["w1"][-1], mesh), n_heads=cfg.n_heads)
    return out
