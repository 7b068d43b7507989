"""Dry-run driver: every (architecture x input shape) planned on the
production mesh and traced (counterpart of `repro/launch/dryrun.py`).

For each pair, `launch.specs.plan` builds the step (train_step for train
shapes, the serve steps for prefill/decode) on an abstract mesh of the
reference's production shape and axis names (16x16 ``data, model`` on one
pod, 2x16x16 ``pod, data, model`` across two), and
`roofline.analysis.analyze_plan` traces it on fake CPU tensors: per-rank
argument, output and donated bytes from the plan's specs, the step's FLOPs,
the client axis' all-reduce bytes and the roofline terms, written as one
JSON record a pair. No process group is started, no device is touched
and no environment variable is set: the meshes are abstract.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2_1_3b \\
      --shape decode_32k --mesh pod --out /tmp/dry
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

A trace runs the whole step on the host and scales with depth: a
2-layer mamba2 prefill_32k at smoke width takes about 100 s on a CPU, so
the full-depth train and prefill_32k plans of the large configs take far
longer.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.launch.specs import Skip, param_shapes, plan
from repro_torch.roofline.analysis import (HW, analyze_plan, model_flops,
                                           roofline_terms)
from repro_torch.sharding.rules import tree_map_with_path

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")

PRODUCTION_MESHES = {"pod": ((16, 16), ("data", "model")),
                     "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def production_mesh(mesh_kind: str):
    """The abstract production mesh of `mesh_kind` ("pod" or
    "multipod")."""
    return make_abstract_mesh(*PRODUCTION_MESHES[mesh_kind])


def count_params(arch: str) -> tuple[int, int]:
    """(total, active) parameter counts from shapes only (no allocation)."""
    cfg = get_config(arch)
    params = param_shapes(cfg)
    total = 0
    inactive = 0

    def walk(path, leaf):
        nonlocal total, inactive
        n = leaf.numel()
        total += n
        if "moe" in path and path[-1] in ("w1", "w2", "w3"):
            frac = 1.0 - cfg.top_k / cfg.n_experts
            inactive += int(n * frac)
        elif path[-1] == "embed":
            inactive += n  # table lookup, not a matmul: no 2/6 flops-per-param

    tree_map_with_path(walk, params)
    return total, total - inactive


def run_one(arch: str, shape_name: str, mesh_kind: str, *, out_dir: str,
            overrides: dict | None = None) -> dict:
    mesh = production_mesh(mesh_kind)
    p = plan(arch, shape_name, mesh, **(overrides or {}))
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    if overrides:
        tag += "__" + "_".join(f"{k}-{v}" for k, v in sorted(overrides.items()))
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "overrides": overrides or {}}
    if isinstance(p, Skip):
        record["status"] = "skip"
        record["reason"] = p.reason
        _save(out_dir, tag, record)
        print(f"[skip] {tag}: {p.reason}")
        return record

    try:
        t0 = time.time()
        analysis = analyze_plan(p, mesh)
        t1 = time.time()
        shape = INPUT_SHAPES[shape_name]
        total, active = count_params(arch)
        n_chips = mesh.size
        mf = model_flops(get_config(arch), total, active, shape, p.kind)
        terms = roofline_terms(analysis)
        flops_global = analysis["flops_traced"]
        record.update({
            "status": "ok",
            "kind": p.kind,
            "meta": p.meta,
            "n_chips": n_chips,
            "trace_s": round(t1 - t0, 2),
            "params_total": total,
            "params_active": active,
            "analysis": analysis,
            "roofline": terms,
            "model_flops": mf,
            "flops_global": flops_global,
            "useful_flops_ratio": (mf / flops_global
                                   if flops_global else None),
            "hw": HW,
        })
        mem = analysis["memory"]
        print(f"[ok]   {tag}: trace={t1 - t0:.1f}s "
              f"args/rank={mem['argument_bytes'] / 1e9:.2f}GB "
              f"bottleneck={terms['bottleneck']} "
              f"t>={terms['step_time_lower_bound_s'] * 1e3:.1f}ms "
              f"useful={record['useful_flops_ratio'] and round(record['useful_flops_ratio'], 3)}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:200]}")
    _save(out_dir, tag, record)
    return record


def _save(out_dir: str, tag: str, record: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod",
                                                      "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--memory-dtype", default=None)
    ap.add_argument("--sequential-clients", default=None,
                    choices=["true", "false"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--ce-chunk", type=int, default=None)
    ap.add_argument("--fsdp", default=None, choices=["true", "false"])
    ap.add_argument("--pad-heads", action="store_true")
    ap.add_argument("--inner-update-constraint", action="store_true")
    ap.add_argument("--seq-shard-prefill", action="store_true")
    args = ap.parse_args(argv)

    overrides = {}
    if args.memory_dtype:
        overrides["memory_dtype"] = args.memory_dtype
    if args.sequential_clients:
        overrides["sequential_clients"] = args.sequential_clients == "true"
    if args.capacity_factor:
        overrides["moe_capacity_factor"] = args.capacity_factor
    if args.ce_chunk is not None:
        overrides["ce_chunk"] = args.ce_chunk
    if args.fsdp:
        overrides["fsdp"] = args.fsdp == "true"
    if args.pad_heads:
        overrides["pad_heads"] = True
    if args.inner_update_constraint:
        overrides["inner_update_constraint"] = True
    if args.seq_shard_prefill:
        overrides["seq_shard_prefill"] = True

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    results = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                results.append(run_one(arch, shape, mesh_kind,
                                       out_dir=args.out,
                                       overrides=overrides or None))
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    fail = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run summary: {ok} ok / {skip} skip / {fail} fail ==")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
