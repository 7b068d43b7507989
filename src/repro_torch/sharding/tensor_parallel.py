"""Split matrix products: each rank of a mesh's `model` axis runs the
serving steps (prefill and decode), the MIFA train step, the federated
round's local update (`run_fl(engine="scan", mesh=, cfg=)`, through
`sharding.params.StepPlacement`) and a fleet's (`run_fleet(mesh=, cfg=)`,
every trial under vmap over trials, through `sharding.params.
FleetPlacement`) on its blocks of the params (and caches), as the
reference's compiled SPMD program computes on the blocks its specs give
(`sharding.rules.param_specs`, `cache_specs`, `client_state_specs`,
`fleet_trial_specs`), with only the collectives the split needs.

Scope: the GQA stack (`attn` and `local_attn` layers, the embedding and
the head) with a dense MLP (granite-3-8b, qwen1.5-110b, gemma3-4b and
llava-next-34b's language stack) or an MoE block whose experts split over
`model` (olmoe-1b-7b, moonshot-v1-16b-a3b; `models.moe.moe_apply(split=)`).
Everything else raises NotImplementedError naming its ROADMAP entry
(`unsupported`): MLA (12d; deepseek-v2-lite-16b, whose MoE layers take
this split once its attention does), Mamba2 and the shared attention
block (12e), padded heads and the encoder (12f), and params, caches or the
sequential step split over the data axis, or the data axis on the card
(12g: a client or trial axis over data ranks).

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
    rank ("whole": k and v gathered, every rank writes all of it). The
    training forward has no cache: its k and v are the rank's kv heads
    where M divides KV ("heads"), else gathered whole ("whole").
  * `w1`/`w3` column blocks and `w2` row blocks (summed), or whole; an
    MoE segment's shared SwiGLU alike.
  * an MoE segment's experts: E/M of them a rank (`w1`/`w3`/`w2` blocks
    of their E dim), every token routed on every rank by the whole router
    and the partial outputs summed; or whole where M does not divide E.
  * the embedding's d_model block (the looked-up rows gathered along d)
    and `lm_head`'s vocab block (each rank keeps its block of the logits,
    the plan's `(batch, MODEL)` logits spec; training takes a
    cross-entropy over the split vocab, `models.layers.vocab_split_nll`),
    or whole.

Collectives that differentiate (`to_model`, `from_model`, `gather_model`):
`torch.autograd.Function`s with `setup_context` and an explicit `vmap`
rule, so `torch.func.grad`, `vmap(grad)` (the vmap train step) and
`remat.checkpoint`'s recompute pass through them, as Megatron's copy and
reduce regions do. A replicated value entering partitioned compute goes
through `to_model` (identity forward, the cotangent summed over `model`
backward); partial sums leave it through `from_model` (the f32 sum forward,
identity backward); a block gathered whole goes through `gather_model`
(all-gather forward, the rank's slice of the cotangent backward). Each
backward calls the other Function, never `dist`, so a backward that runs
under `vmap` or inside a checkpoint's recompute reaches a vmap rule too.
A vmap rule re-enters its Function on the physical tensor, its batch dim
in it, so the collective runs once, on a plain tensor with every batch dim
in it, however many vmaps are stacked (a fleet's vmap over trials around
the vmap over clients, `fleet.executor`): a rule that called the
collective itself would hand it a tensor still batched at an outer level,
which has no storage. Every rank vmaps the same trials and clients in the
same order, and must issue the same collectives in the same order, which
the autograd graph of one program guarantees; a mismatch deadlocks, and
the worlds' timeouts catch that.

Transport: gloo on the tensors themselves, CUDA tensors included (gloo
stages them through the host). A probe on an H100 (`scripts/
gloo_cuda_probe.py`, PERF.md) found all_reduce (SUM and MAX) and
all_gather working on CUDA f32 and bf16 tensors in a world of two ranks on
one card, and no all_to_all in gloo: the train step's move of each update
from the params' blocks into the update array's is an all-to-all built of
M - 1 all-gathers of one piece each where both layouts split one dim over
`model`, else an all-gather of the leaf, cut at once (`TrainSplit.move`).
NCCL cannot hold two ranks on one
device. There is one route, with no switch at run time: a collective that
fails, fails the step. Sums are reduced in f32 and cast back to the
tensor's dtype, whatever it is, so the rounding stays close to an unsplit
product's (which sums its K dim in f32); max and gather move the tensor's
own dtype, exactly.

The serving steps run under `torch.inference_mode()` (`launch.steps`).
Every mesh whose `model` axis has extent 1 (every mesh of a world of one)
gives no split (`model_axis` is None), so its steps are today's, bit for
bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.sharding.params import (block_shape, split_dims, take,
                                         whole)
from repro_torch.sharding.rules import (MODEL, P, _entry_axes, axis_names,
                                        cache_specs, client_state_specs,
                                        data_axis_size, mesh_shape,
                                        param_specs)
from repro_torch.tree import tree_map


class ModelAxis:
    """This rank's view of a DeviceMesh's `model` axis: its group, its
    coordinate on it and its extent M; `moved` counts the bytes this rank
    put into each kind of collective (the train step's moves into the
    update array's blocks apart, as "relayout")."""

    def __init__(self, mesh):
        names = axis_names(mesh)
        self.size = mesh_shape(mesh)[MODEL]
        self.rank = mesh.get_coordinate()[names.index(MODEL)]
        self.group = mesh.get_group(MODEL)
        self.moved = {"all_reduce": 0, "all_gather": 0, "relayout": 0}

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


# --------------------------------------------------------------------------- #
# collectives that differentiate (module docstring)
# --------------------------------------------------------------------------- #

class _ToModel(torch.autograd.Function):
    """Identity forward; the cotangent summed over `model` backward."""

    @staticmethod
    def forward(x, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _FromModel.apply(g, ctx.axis), None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _ToModel.apply(x, axis), in_dims[0]


class _FromModel(torch.autograd.Function):
    """The f32 sum over `model` forward (`ModelAxis.sum`); identity
    backward."""

    @staticmethod
    def forward(x, axis):
        return axis.sum(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ToModel.apply(g, ctx.axis), None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        # elementwise over ranks: the batch dim stays where it is
        return _FromModel.apply(x, axis), in_dims[0]


class _GatherModel(torch.autograd.Function):
    """Every rank's block concatenated along `dim` forward; this rank's
    slice of the cotangent backward (the gathered value is replicated, so
    its cotangent is too)."""

    @staticmethod
    def forward(x, axis, dim):
        return axis.gather(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.axis, ctx.dim = inputs
        ctx.width = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.width, ctx.width), \
            None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        if in_dims[0] is None:
            return _GatherModel.apply(x, axis, dim), None
        # the batch dim first: a logical dim d >= 0 is physical d + 1
        x = x.movedim(in_dims[0], 0)
        return _GatherModel.apply(x, axis, dim + 1 if dim >= 0 else dim), 0


def to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """`x` (replicated on the axis) into partitioned compute: identity,
    and Σ over the axis of the cotangent in the backward pass."""
    return _ToModel.apply(x, axis)


def from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """Σ over the axis of every rank's partial `x` (f32, cast back), with
    the identity backward."""
    return _FromModel.apply(x, axis)


def gather_model(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """Every rank's block `x` concatenated along `dim`, with this rank's
    slice of the cotangent backward. A gathered value that feeds
    partitioned compute (k and v read by the rank's query heads) goes on
    through `to_model`, so its cotangent is summed before it is sliced."""
    return _GatherModel.apply(x, axis, dim)


def _splits(entry, mesh, axis: str = MODEL) -> bool:
    return axis in _entry_axes(entry) and mesh_shape(mesh)[axis] > 1


def unsupported(cfg, mesh, batch: int, *, train: bool = False,
                fl_round: bool = False, fleet: bool = False) -> str | None:
    """Why the steps of `cfg` cannot run on `mesh`'s blocks (naming the
    ROADMAP entry that will take it), or None where they can: the serving
    steps at a batch of `batch` sequences, or with `train` the MIFA train
    step of `batch` clients (the vmap mode's client axis over data, the
    sequential mode at data extent 1 only). With `fl_round` (and `train`)
    the federated round's local update: it always vmaps its clients
    (`core.local_update`), over data where the data extent divides them
    and whole on every rank where it does not (`sharding.clients`). With
    `fleet` (and both) a fleet's, which vmaps its trials around that, the
    trial axis over data and each trial's clients whole on every rank."""
    from repro_torch.models.transformer import build_segments
    if cfg.encoder_only or cfg.modality == "audio":
        return (f"{cfg.name}: the encoder's frontend_proj under split "
                "products (ROADMAP entry 12f)")
    for seg in build_segments(cfg):
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
    what = "clients" if train else "batch"
    if d > 1 and (cfg.fsdp or (not fl_round and (batch % d
                                                  or batch < d))):
        return (f"{cfg.name}: params or caches split over the data axis "
                f"(fsdp {cfg.fsdp}, {what} {batch} over {d} data ranks) "
                "under split products (ROADMAP entry 12g)")
    if train and d > 1 and cfg.sequential_clients and not fl_round:
        return (f"{cfg.name}: the sequential train step over {d} data "
                "ranks, each client's batch split over data (the "
                "reference's batch_specs), under split products (ROADMAP "
                "entry 12g)")
    if train and d > 1 and getattr(mesh, "device_type", None) == "cuda":
        what = ("a fleet's trial axis" if fleet
                else "the train step's client axis")
        return (f"{cfg.name}: {what} over {d} data ranks on the card "
                "(ROADMAP entry 12g)")
    return None


@dataclass(frozen=True)
class GQASplit:
    """One GQA segment's layout under the split (module docstring)."""

    axis: ModelAxis
    heads: bool       # wq/bq columns and wo rows split, whole heads
    kv_cols: bool     # wk/wv/bk/bv columns split
    cache: str        # "heads" | "seq" | "whole" (training: "heads" | "whole")
    slots: int        # the whole cache's slots (training: 0)
    mlp: bool         # w1/w3 columns and w2 rows split (MoE: the shared's)
    n_heads: int      # the whole model's query heads
    experts: bool = False   # an MoE segment's experts split over their E

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
        return from_model(partial, self.axis) if self.heads else partial

    def expert_block(self, n_experts: int) -> tuple[int, int]:
        """The experts [lo, hi) of the whole model's `n_experts` that this
        rank computes."""
        if not self.experts:
            return 0, n_experts
        n = n_experts // self.axis.size
        return self.axis.rank * n, (self.axis.rank + 1) * n

    def experts_in(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated value (the tokens, the gates) into this rank's
        experts."""
        return to_model(t, self.axis) if self.experts else t

    def experts_out(self, partial: torch.Tensor) -> torch.Tensor:
        """The MoE block's output from this rank's experts."""
        return from_model(partial, self.axis) if self.experts else partial

    def mlp_in(self, h: torch.Tensor) -> torch.Tensor:
        """The MLP's (replicated) input to this rank's w1/w3 blocks."""
        return to_model(h, self.axis) if self.mlp else h

    def mlp_out(self, partial: torch.Tensor) -> torch.Tensor:
        """The MLP's output from this rank's `w2` product."""
        return from_model(partial, self.axis) if self.mlp else partial

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
                        split=True), dtype=t.dtype, device=device),
            tree, specs)


def _ffn_layout(lp, mesh) -> dict:
    """A segment's FFN layout from its param specs `lp`: the dense MLP's
    (or an MoE segment's shared SwiGLU's) split, and the experts' split
    over their E dim."""
    if "moe" not in lp:
        return {"mlp": _splits(lp["mlp"]["w1"][-1], mesh)}
    moe = lp["moe"]
    return {"mlp": "shared" in moe and _splits(moe["shared"]["w1"][-1],
                                               mesh),
            "experts": _splits(moe["w1"][-3], mesh)}


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
            n_heads=cfg.n_heads, **_ffn_layout(lp, mesh))
    return out


@dataclass
class TrainSplit:
    """The split of a config's MIFA train step on a mesh (a `ServeSplit`
    without caches): the model axis, the embedding's and the head's
    layouts, each GQA segment's `GQASplit`, the specs of the params and of
    the update array G (`client_state_specs` of the step's mode) they were
    read from, and the moves between the two."""

    mesh: object
    axis: ModelAxis
    embed: bool              # embed's d_model split
    head: bool               # lm_head's vocab split
    param_specs: object
    state_specs: object      # G's, (N, *param_shape) leaves
    segments: dict = field(default_factory=dict)

    def segment(self, index: int) -> GQASplit:
        return self.segments[index]

    def move(self, x: torch.Tensor, src, dst) -> torch.Tensor:
        """This rank's block under `dst` from its block `x` under `src`
        (specs of one whole tensor): `x` itself where both split it alike;
        where each splits one dim over `model` alone, an all-to-all
        (`_exchange`); else the leaf gathered whole over the axes `src`
        splits and cut at once. The bytes this rank puts in count as
        "relayout"."""
        s, d = split_dims(src, self.mesh), split_dims(dst, self.mesh)
        if s == d:
            return x
        if (len(s) == len(d) == 1 and s[0][1] == d[0][1] == (MODEL,)
                and x.shape[d[0][0]] % self.axis.size == 0):
            return self._exchange(x, s[0][0], d[0][0])
        if s:
            self.axis.moved["relayout"] += x.numel() * x.element_size()
        out = take(whole(x, src, self.mesh, split=True), dst, self.mesh,
                   split=True)
        return out.contiguous()

    def _exchange(self, x: torch.Tensor, a: int, b: int) -> torch.Tensor:
        """`x`, split on dim `a` over `model` and whole on `b`, as this
        rank's block of dim `b` whole on `a`. Gloo has no all_to_all, so
        it runs as M - 1 all-gathers of one (a, b) piece each: in gather
        k every rank puts in the piece that the rank k places after it
        needs, and keeps the one from the rank k places before it. A rank
        puts in (M - 1) / M of `x` where a whole gather takes all of it,
        and holds one more piece at a time, not the whole leaf."""
        import torch.distributed as dist
        m, r = self.axis.size, self.axis.rank
        w = x.shape[b] // m
        pieces = [None] * m
        pieces[r] = x.narrow(b, r * w, w)
        for k in range(1, m):
            send = x.narrow(b, (r + k) % m * w, w).contiguous()
            parts = [torch.empty_like(send) for _ in range(m)]
            self.axis.moved["relayout"] += send.numel() * send.element_size()
            dist.all_gather(parts, send, group=self.axis.group)
            pieces[(r - k) % m] = parts[(r - k) % m]
        return torch.cat(pieces, dim=a)

    def move_tree(self, tree, src, dst, via=None) -> object:
        """`move` leaf by leaf against spec trees of `tree`'s structure,
        each leaf of `tree` replaced in place as it moves, so one whole
        leaf is alive at a time. With `via` (a tree of tensors of the same
        structure) each leaf moves in its `via` leaf's dtype and comes back
        in its own: an update moves in the update array's dtype, to which
        the server step rounds it anyway. Returns `tree`."""
        def walk(t, s, d, v):
            for k in (t if isinstance(t, dict) else range(len(t))):
                if isinstance(t[k], (dict, list)):
                    walk(t[k], s[k], d[k], None if v is None else v[k])
                elif v is None:
                    t[k] = self.move(t[k], s[k], d[k])
                else:
                    t[k] = self.move(t[k].to(v[k].dtype), s[k], d[k]).to(
                        t[k].dtype)
        walk(tree, src, dst, via)
        return tree

    @property
    def update_specs(self):
        """An update tree's layout as the local update leaves it: the
        rank's rows of the client axis, the param dims of `param_specs`."""
        return tree_map(lambda s: P(None, *s), self.param_specs)

    @property
    def row_specs(self):
        """G's layout with its client axis taken as this rank's rows."""
        return tree_map(lambda s: P(None, *s[1:]), self.state_specs)

    @property
    def step_specs(self):
        """The server step's layout of the params, and of one row of G:
        G's param dims."""
        return tree_map(lambda s: P(*s[1:]), self.state_specs)


def train_split(cfg, mesh, n_clients: int, *, specs=None
                ) -> TrainSplit | None:
    """The split of `cfg`'s MIFA train step for `n_clients` clients on
    `mesh` (its mode from `cfg.sequential_clients`), or None where
    `model_axis` gives none. Raises NotImplementedError for what the split
    does not take yet (`unsupported`).

    `specs`: the (param specs, update array specs) a caller has already
    placed its carry by, for the federated round (`sharding.params.
    StepPlacement`): its clients are always vmapped, so its update array
    takes the vmap mode's `client_state_specs` whatever
    `cfg.sequential_clients` says (qwen1.5-110b and llava-next-34b train
    sequentially in the launch driver, not in `run_fl`)."""
    axis = model_axis(mesh)
    if axis is None:
        return None
    why = unsupported(cfg, mesh, n_clients, train=True,
                      fl_round=specs is not None)
    if why is not None:
        raise NotImplementedError(why)
    from repro_torch.launch.specs import param_shapes
    from repro_torch.models import transformer
    if specs is None:
        shapes = param_shapes(cfg)
        pspecs = param_specs(shapes, cfg, mesh)
        gspecs = client_state_specs(
            shapes, cfg, mesh, sequential_clients=cfg.sequential_clients,
            n_clients=n_clients)
    else:
        pspecs, gspecs = specs
    out = TrainSplit(mesh, axis, embed=_splits(pspecs["embed"][1], mesh),
                     head=_splits(pspecs["lm_head"][1], mesh),
                     param_specs=pspecs, state_specs=gspecs)
    for seg in transformer.build_segments(cfg):
        lp = pspecs["segments"][str(seg.index)]
        kv_cols = _splits(lp["attn"]["wk"][-1], mesh)
        local = kv_cols and cfg.n_kv_heads % axis.size == 0
        out.segments[seg.index] = GQASplit(
            axis, heads=_splits(lp["attn"]["wq"][-1], mesh), kv_cols=kv_cols,
            cache="heads" if local else "whole", slots=0,
            n_heads=cfg.n_heads, **_ffn_layout(lp, mesh))
    return out
