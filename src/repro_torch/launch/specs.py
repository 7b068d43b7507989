"""Dry-run planning: shape-only inputs and placements per (arch x shape)
(counterpart of `repro/launch/specs.py`).

`plan(arch, shape, mesh)` returns a `DryrunPlan` (the step function, its
arguments as meta tensors of the reference's shapes and dtypes, their in
and out placements, the donated arguments and the plan's `meta`) or a
`Skip` with the reference's reason: encoder-only archs have no decode;
long_500k runs only for sub-quadratic archs.

The arguments are built under a `FakeTensorMode` (no weights are
allocated) and handed out as meta tensors; `roofline.analysis.analyze_plan`
traces `fn` on fake CPU tensors of the same shapes, and a caller
materialises them on a device to run the step for real. Placements are
`sharding.rules.NamedSharding` trees: the port's `PartitionSpec`s with the
mesh, an `AbstractMesh` or a `DeviceMesh` (`rules.placements` gives the
DTensor placements of the latter). `plan_config` plans a config the caller
has already cut (a depth-cut model on the card); `plan` is the
reference's entry point, `get_config` and the overrides before it.
`run_placed` runs a plan's step on each rank's blocks of its arguments
(`sharding.params`) and returns the rank's blocks of the outputs, as the
reference's jitted step with its in and out shardings does; the prefill,
decode and train plans of the GQA stack (dense or MoE) on a DeviceMesh whose
`model` axis splits compute on the blocks (`sharding.tensor_parallel`).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs import INPUT_SHAPES, ArchConfig, get_config
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model
from repro_torch.models.model import DTYPES
from repro_torch.sharding import rules, tensor_parallel
from repro_torch.sharding.params import gather, place
from repro_torch.sharding.rules import P, named
from repro_torch.tree import tree_map


@dataclass
class Skip:
    arch: str
    shape: str
    reason: str


@dataclass
class DryrunPlan:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple          # meta tensors
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple
    meta: dict


def run_placed(p: DryrunPlan, *args) -> Any:
    """`p.fn` on this rank's blocks of its arguments under
    `p.in_shardings`, returning this rank's blocks of the outputs under
    `p.out_shardings`. A prefill, decode or train plan whose step is
    split (the GQA stack, dense or MoE, on a DeviceMesh whose `model`
    axis splits: the step's `split`, `sharding.tensor_parallel`) passes
    the blocks straight to it, and it computes on them. Every other plan
    gathers each argument whole, runs the whole step (the sequential step
    at data extent > 1 holds its accumulator in blocks under its own
    update spec) and cuts the outputs. On a mesh of extent 1 every block is the
    whole tensor and this is `p.fn(*args)`."""
    if getattr(p.fn, "split", None) is not None:
        return p.fn(*args)
    out = p.fn(*gather(tuple(args), p.in_shardings))
    return place(out, p.out_shardings)


def shapes_only(fn: Callable) -> Any:
    """fn() run under a FakeTensorMode (CPU tensors without storage), its
    tensors returned as meta tensors of the same shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = fn()
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


@functools.lru_cache(maxsize=64)
def _param_shapes(cfg: ArchConfig) -> Any:
    return shapes_only(lambda: build_model(cfg).init(0, device="cpu"))


def param_shapes(cfg: ArchConfig) -> Any:
    """`cfg`'s param tree as meta tensors (the init traced once a config,
    a fresh tree each call)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), _param_shapes(cfg))


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _train_batch(cfg: ArchConfig, n: int, K: int, mb: int, S: int,
                 compute_dtype: torch.dtype) -> dict:
    if cfg.modality == "vision_text":
        text = S - cfg.n_patches
        return {"tokens": _sds((n, K, mb, text), torch.int32),
                "patches": _sds((n, K, mb, cfg.n_patches, cfg.d_model),
                                compute_dtype)}
    if cfg.modality == "audio":
        return {"frames": _sds((n, K, mb, S, cfg.d_model), compute_dtype),
                "labels": _sds((n, K, mb, S), torch.int32)}
    return {"tokens": _sds((n, K, mb, S), torch.int32)}


def _serve_batch(cfg: ArchConfig, B: int, S: int,
                 compute_dtype: torch.dtype) -> dict:
    if cfg.modality == "vision_text":
        return {"tokens": _sds((B, S - cfg.n_patches), torch.int32),
                "patches": _sds((B, cfg.n_patches, cfg.d_model),
                                compute_dtype)}
    if cfg.modality == "audio":
        return {"frames": _sds((B, S, cfg.d_model), compute_dtype),
                "labels": _sds((B, S), torch.int32)}
    return {"tokens": _sds((B, S), torch.int32)}


def _lead_spec(lead, batch: Any) -> Any:
    """Each leaf's leading dim on `lead`, the rest replicated."""
    return tree_map(lambda leaf: P(*((lead,) + (None,) * (leaf.ndim - 1))),
                    batch)


def override_config(cfg: ArchConfig, *, memory_dtype: str | None = None,
                    sequential_clients: bool | None = None,
                    moe_capacity_factor: float | None = None,
                    ce_chunk: int | None = None, fsdp: bool | None = None,
                    pad_heads: bool | None = None) -> ArchConfig:
    """`cfg` with `plan`'s overrides: each given field replaced, and with
    `pad_heads` the head counts rounded up to multiples of 16 as the
    compute layout (`pad_q_heads`, `pad_kv_heads`)."""
    change = {k: v for k, v in (
        ("memory_dtype", memory_dtype),
        ("sequential_clients", sequential_clients),
        ("moe_capacity_factor", moe_capacity_factor),
        ("ce_chunk", ce_chunk), ("fsdp", fsdp)) if v is not None}
    if pad_heads:
        def up(n):
            return ((n + 15) // 16) * 16
        change.update(pad_q_heads=up(cfg.n_heads),
                      pad_kv_heads=up(cfg.n_kv_heads))
    return cfg.replace(**change) if change else cfg


def plan(arch: str, shape_name: str, mesh, *,
         memory_dtype: str | None = None,
         sequential_clients: bool | None = None,
         moe_capacity_factor: float | None = None,
         ce_chunk: int | None = None,
         fsdp: bool | None = None,
         pad_heads: bool | None = None,
         inner_update_constraint: bool | None = None,
         seq_shard_prefill: bool | None = None):
    """The `DryrunPlan` of `arch` at the input shape `shape_name` on
    `mesh`, or a `Skip`."""
    cfg = override_config(
        get_config(arch), memory_dtype=memory_dtype,
        sequential_clients=sequential_clients,
        moe_capacity_factor=moe_capacity_factor, ce_chunk=ce_chunk,
        fsdp=fsdp, pad_heads=pad_heads)
    return plan_config(cfg, shape_name, mesh, arch=arch,
                       inner_update_constraint=inner_update_constraint,
                       seq_shard_prefill=seq_shard_prefill)


def plan_config(cfg: ArchConfig, shape_name: str, mesh, *,
                arch: str | None = None,
                inner_update_constraint: bool | None = None,
                seq_shard_prefill: bool | None = None):
    """`plan` for a config the caller has built (overrides applied, depth
    cut); `arch` names it in a Skip and the plan (default `cfg.name`)."""
    arch = cfg.name if arch is None else arch
    shape = INPUT_SHAPES[shape_name]

    # ---- documented skips ----
    if shape.kind == "decode" and not cfg.supports_decode:
        return Skip(arch, shape_name,
                    "encoder-only architecture: no autoregressive decode")
    if shape_name == "long_500k" and not cfg.supports_long_decode:
        return Skip(arch, shape_name,
                    "long_500k requires sub-quadratic attention; "
                    f"{arch} is full-attention")
    if shape_name == "long_500k" and cfg.family == "hybrid":
        # window the shared attention block for the long-context mode
        cfg = cfg.replace(shared_attn_window=4096)

    dax = rules.data_axes(mesh)
    n_data = rules.data_axis_size(mesh)

    model = build_model(cfg)
    compute_dtype = model.compute_dtype
    params = param_shapes(cfg)
    pspecs = rules.param_specs(params, cfg, mesh)
    scalar = rules.NamedSharding(mesh, P())

    if shape.kind == "train":
        seq = cfg.sequential_clients
        n = cfg.fl_clients if seq else n_data
        K = cfg.fl_local_steps
        mb = shape.global_batch // (n * K)
        if mb < 1:
            raise ValueError(f"{arch} {shape_name}: a global batch of "
                             f"{shape.global_batch} gives no minibatch to "
                             f"{n} clients x {K} local steps")
        mem_dt = DTYPES[cfg.memory_dtype]
        G = tree_map(lambda p: _sds((n,) + tuple(p.shape), mem_dt), params)
        gspecs = rules.client_state_specs(params, cfg, mesh,
                                          sequential_clients=seq,
                                          n_clients=n)
        batch = _train_batch(cfg, n, K, mb, shape.seq_len, compute_dtype)
        bspecs = rules.batch_specs(batch, mesh, client_axis=True,
                                   sequential_clients=seq)
        active = _sds((n,), torch.bool)
        eta = _sds((), torch.float32)
        # the reference keeps the update constraint off unless the config
        # or the caller asks for it (its §Perf H2 note)
        update_spec = None
        if inner_update_constraint is None:
            inner_update_constraint = cfg.inner_update_constraint
        if seq and inner_update_constraint:
            update_spec = named(mesh, rules.param_specs(
                params, cfg.replace(fsdp=True), mesh))
        # split products: the train step of the GQA stack (dense or MoE)
        # runs on each rank's blocks where the mesh's model axis splits (a
        # DeviceMesh) and `unsupported` allows it
        train_mesh = (mesh if tensor_parallel.model_axis(mesh) is not None
                      and tensor_parallel.unsupported(
                          cfg, mesh, n, train=True) is None else None)
        fn = steps_lib.make_train_step(model, cfg, n, K,
                                       update_spec=update_spec,
                                       mesh=train_mesh)
        in_sh = (named(mesh, pspecs), named(mesh, gspecs),
                 named(mesh, bspecs), scalar, scalar)
        out_sh = (named(mesh, pspecs), named(mesh, gspecs),
                  {"loss": scalar})
        return DryrunPlan(
            arch, shape_name, "train", fn, (params, G, batch, active, eta),
            in_sh, out_sh, donate_argnums=(1,),
            meta={"n_clients": n, "k_steps": K, "mb": mb,
                  "sequential": seq, "memory_dtype": cfg.memory_dtype,
                  "tokens_per_round": shape.global_batch * shape.seq_len})

    B, S = shape.global_batch, shape.seq_len
    batch_sharded = B % n_data == 0 and B >= n_data
    bax = dax if batch_sharded else None
    # split products: the serving steps of the GQA stack (dense or MoE)
    # run on each rank's blocks where the mesh's model axis splits (a
    # DeviceMesh); the dry run's abstract meshes trace the whole step
    serve_mesh = (mesh if tensor_parallel.model_axis(mesh) is not None
                  and tensor_parallel.unsupported(cfg, mesh, B) is None
                  else None)

    if shape.kind == "prefill":
        batch = _serve_batch(cfg, B, S, compute_dtype)
        if cfg.encoder_only:
            fn = steps_lib.make_encoder_step(model)
            in_sh = (named(mesh, pspecs), named(mesh, _lead_spec(bax, batch)))
            return DryrunPlan(arch, shape_name, "encode", fn,
                              (params, batch), in_sh, scalar, (),
                              {"batch": B, "seq": S})
        cache = shapes_only(lambda: model.init_cache(B, S, device="cpu"))
        cspecs = rules.cache_specs(cache, cfg, mesh, B)
        if seq_shard_prefill:
            # sequence-parallel prefill: the token dim over `model`
            bspec = tree_map(lambda leaf: P(*rules.sanitize(
                (bax, rules.MODEL) + (None,) * (leaf.ndim - 2),
                tuple(leaf.shape), mesh)), batch)
        else:
            bspec = _lead_spec(bax, batch)
        fn = steps_lib.make_prefill_step(
            model, None if seq_shard_prefill else serve_mesh, batch=B,
            cache_len=S)
        in_sh = (named(mesh, pspecs), named(mesh, cspecs),
                 named(mesh, bspec))
        lspec = P(*rules.sanitize((bax, rules.MODEL), (B, cfg.vocab_size),
                                  mesh))
        out_sh = (rules.NamedSharding(mesh, lspec), named(mesh, cspecs))
        return DryrunPlan(arch, shape_name, "prefill", fn,
                          (params, cache, batch), in_sh, out_sh,
                          donate_argnums=(1,), meta={"batch": B, "seq": S})

    # decode: one new token against a seq_len cache
    cache = shapes_only(lambda: model.init_cache(B, S, device="cpu"))
    cspecs = rules.cache_specs(cache, cfg, mesh, B)
    tokens = _sds((B, 1), torch.int32)
    pos = _sds((), torch.int32)
    fn = steps_lib.make_decode_step(model, serve_mesh, batch=B, cache_len=S)
    in_sh = (named(mesh, pspecs), named(mesh, cspecs),
             rules.NamedSharding(mesh, P(bax, None)), scalar)
    lspec = P(*rules.sanitize((bax, rules.MODEL), (B, cfg.vocab_size), mesh))
    out_sh = (rules.NamedSharding(mesh, lspec), named(mesh, cspecs))
    return DryrunPlan(arch, shape_name, "decode", fn,
                      (params, cache, tokens, pos), in_sh, out_sh,
                      donate_argnums=(1,),
                      meta={"batch": B, "cache_len": S,
                            "batch_sharded": batch_sharded})
