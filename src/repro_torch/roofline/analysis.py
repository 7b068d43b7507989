"""A dry-run plan's work and bytes -> the three-term roofline
(counterpart of `repro/roofline/analysis.py`).

The reference compiles each plan with XLA and reads the optimized HLO
(`parse_hlo`, `analyze_compiled`: loop-expanded dot FLOPs, fusion bytes,
collective operand sizes). The port has no compiled SPMD program to read,
so those two have no counterpart; `analyze_plan` takes their place and
returns a dict under `analyze_compiled`'s keys, filled as follows:

  * ``hlo_flops_parsed`` and ``cost_analysis_flops``: the FLOPs of the
    whole step counted by `torch.utils.flop_counter.FlopCounterMode` while
    `plan.fn` runs on fake CPU tensors of the plan's shapes (matmuls,
    batched matmuls, attention; elementwise work is not counted, as the
    reference counts only dots), divided evenly over the mesh's ranks;
    ``flops_traced`` keeps the whole step's count.
  * ``memory``: per-rank bytes of each argument and output leaf, its whole
    size over the extents of the mesh axes its spec names
    (``argument_bytes``, ``output_bytes``), the donated arguments'
    (``alias_bytes``), and ``peak_estimate_bytes`` = arguments + outputs
    − donated. ``temp_bytes`` is None: a fake trace does not see the
    activations' lifetimes.
  * ``hlo_bytes_parsed`` and ``cost_analysis_bytes``: arguments read once
    and outputs written once, per rank (a lower bound on HBM traffic).
  * ``collective_bytes``: the all-reduces the port itself issues on the
    client axis (`sharding.clients.ClientShard`), counted from the
    shapes: a vmap train plan whose clients the mesh splits (data extent
    D > 1 dividing N) all-reduces, in MIFA's server step, the f32 column
    sum of every parameter leaf over the data group (4 B a parameter) and
    the active count and the loss sum (4 B each), per rank a round. A
    sequential train plan keeps the client axis whole and a serving plan
    has none: no collective.
  * ``conversion_bytes_cpu_artifact``: 0 (an XLA:CPU artifact).

A run places each argument as the plan's specs say (`sharding.params`,
`launch.specs.run_placed`), so the per-rank bytes are the blocks a rank
holds between steps; the step itself gathers whole params for the local
update, which the count leaves out (``params_placement`` says so in every
record).

`model_flops` and `roofline_terms` are the reference's, key for key.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.sharding.rules import (NamedSharding, data_axis_size,
                                        mesh_shape)
from repro_torch.tree import tree_leaves, tree_map

# NVIDIA H100 80GB HBM3 (SXM), 700 W: NVIDIA's data sheet, dense rates
HW = {
    "peak_flops": 989e12,   # bf16 FLOP/s, NVIDIA H100 80GB HBM3, 700 W
    "hbm_bw": 3.35e12,      # B/s of HBM3, NVIDIA H100 80GB HBM3, 700 W
    "ici_bw": 450e9,        # B/s of NVLink 4 per direction (18 links x
                            # 25 GB/s), NVIDIA H100 80GB HBM3, 700 W
    "card": "NVIDIA H100 80GB HBM3, 700 W",
}

PARAMS_PLACEMENT = ("params and state are placed as the plan's specs say "
                    "(sharding.params); per-rank bytes are the blocks a "
                    "rank holds between steps, without the whole params "
                    "the local update gathers")


def leaf_bytes(t: torch.Tensor, sharding: NamedSharding) -> int:
    """Bytes of one rank's block of `t` under `sharding`."""
    shape = mesh_shape(sharding.mesh)
    split = 1
    for entry in sharding.spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            split *= shape[a] if a is not None else 1
    return t.numel() * t.element_size() // split


def _pairs(values: Any, shardings: Any) -> list:
    """(tensor, NamedSharding) of every leaf of a value tree (a tuple of
    trees or one tree) against its sharding tree of the same structure;
    non-tensor leaves are skipped."""
    if isinstance(values, tuple):
        return [p for v, s in zip(values, shardings) for p in _pairs(v, s)]
    out: list = []
    tree_map(lambda v, s: out.append((v, s)), values, shardings)
    return [(v, s) for v, s in out if isinstance(v, torch.Tensor)]


def per_rank_bytes(values: Any, shardings: Any) -> int:
    return sum(leaf_bytes(v, s) for v, s in _pairs(values, shardings))


def trace(plan) -> tuple[dict, Any]:
    """Run `plan.fn` once on fake CPU tensors of the plan's argument
    shapes (0-d arguments, eta and a decode position, as Python numbers)
    under a FlopCounterMode. Returns ({aten op: FLOPs} over the whole
    step, the outputs as fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    def fake(t: torch.Tensor):
        if t.ndim == 0:
            return 0.0 if t.dtype.is_floating_point else 0
        return torch.empty(t.shape, dtype=t.dtype, device="cpu")

    with FakeTensorMode():
        args = tuple(tree_map(fake, a) for a in plan.args)
        counter = FlopCounterMode(display=False)
        with counter:
            out = plan.fn(*args)
    counts = counter.get_flop_counts().get("Global", {})
    return {str(op): int(n) for op, n in counts.items()}, out


def client_collective_bytes(plan, mesh) -> dict:
    """Per-rank all-reduce operand bytes a round on the client axis (the
    module docstring's count)."""
    if plan.kind != "train" or plan.meta["sequential"]:
        return {}
    d, n = data_axis_size(mesh), plan.meta["n_clients"]
    if d == 1 or n % d:
        return {}
    n_params = sum(p.numel() for p in tree_leaves(plan.args[0]))
    return {"all-reduce": float(4 * n_params + 8)}


def analyze_plan(plan, mesh) -> dict:
    """`analyze_compiled`'s dict for a `launch.specs.DryrunPlan` on
    `mesh` (module docstring)."""
    ops, out = trace(plan)
    flops = float(sum(ops.values()))
    n_ranks = math.prod(mesh_shape(mesh).values())
    arg_b = per_rank_bytes(plan.args, plan.in_shardings)
    out_b = per_rank_bytes(out, plan.out_shardings)
    alias_b = sum(per_rank_bytes(plan.args[i], plan.in_shardings[i])
                  for i in plan.donate_argnums)
    coll = client_collective_bytes(plan, mesh)
    return {
        "hlo_flops_parsed": flops / n_ranks,
        "hlo_bytes_parsed": float(arg_b + out_b),
        "conversion_bytes_cpu_artifact": 0.0,
        "collective_bytes": coll,
        "collective_bytes_total": float(sum(coll.values())),
        "cost_analysis_flops": flops / n_ranks,
        "cost_analysis_bytes": float(arg_b + out_b),
        "flops_traced": flops,
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": None,
            "alias_bytes": alias_b,
            "peak_estimate_bytes": arg_b + out_b - alias_b,
        },
        "params_placement": PARAMS_PLACEMENT,
    }


def roofline_terms(analysis: dict, hw: dict = HW) -> dict:
    """Seconds per step for each roofline term (per chip)."""
    # parsed values are loop-exact; cost_analysis counts while bodies once.
    # Fall back to cost_analysis only if parsing found (nearly) nothing.
    flops = analysis["hlo_flops_parsed"]
    if flops < 0.01 * analysis["cost_analysis_flops"]:
        flops = analysis["cost_analysis_flops"]
    nbytes = analysis["hlo_bytes_parsed"]
    if nbytes < 0.01 * analysis["cost_analysis_bytes"]:
        nbytes = analysis["cost_analysis_bytes"]
    cbytes = analysis["collective_bytes_total"]
    t_compute = flops / hw["peak_flops"]
    t_memory = nbytes / hw["hbm_bw"]
    t_coll = cbytes / hw["ici_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    return {**terms, "bottleneck": dom.replace("_s", ""),
            "step_time_lower_bound_s": max(terms.values())}


def model_flops(cfg, params_total: int, params_active: int, shape,
                kind: str) -> float:
    """Useful model FLOPs (6·N·D train / 2·N·D inference), MoE-active-aware."""
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * params_active * tokens
    if kind in ("prefill", "encode"):
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * params_active * tokens
    # decode: one token per sequence
    return 2.0 * params_active * shape.global_batch
