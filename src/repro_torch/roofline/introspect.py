"""Profile view of one dry-run plan (counterpart of
`repro/roofline/introspect.py`): the traced step's top aten ops by FLOPs
and the plan's largest argument buffers, per rank under its specs. The
reference prints the top HLO computations of the compiled program; the
port has none, so it lists the ops `FlopCounterMode` counted while the
step ran on fake CPU tensors (`roofline.analysis.trace`).

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.introspect \\
      --arch granite_3_8b --shape decode_32k
"""
from __future__ import annotations

import argparse
import collections

from repro_torch.launch.dryrun import production_mesh
from repro_torch.launch.specs import plan
from repro_torch.roofline.analysis import leaf_bytes, trace
from repro_torch.sharding.rules import tree_map_with_path


def argument_buffers(p) -> list:
    """(per-rank bytes, argument index and path, shape, dtype) of every
    tensor argument of plan `p`, largest first."""
    rows = []
    for i, (arg, sh) in enumerate(zip(p.args, p.in_shardings)):
        def visit(path, leaf, i=i, sh=sh):
            s = sh
            for key in path:
                s = s[key]
            rows.append((leaf_bytes(leaf, s),
                         "/".join([str(i)] + [str(k) for k in path]),
                         tuple(leaf.shape), str(leaf.dtype)[6:]))
        tree_map_with_path(visit, arg)
    return sorted(rows, key=lambda r: -r[0])


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--memory-dtype", default=None)
    ap.add_argument("--sequential-clients", default=None,
                    choices=["true", "false"])
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    overrides = {}
    if args.memory_dtype:
        overrides["memory_dtype"] = args.memory_dtype
    if args.sequential_clients:
        overrides["sequential_clients"] = args.sequential_clients == "true"
    if args.capacity_factor:
        overrides["moe_capacity_factor"] = args.capacity_factor

    mesh = production_mesh(args.mesh)
    p = plan(args.arch, args.shape, mesh, **overrides)
    if not hasattr(p, "fn"):
        print(f"== {args.arch} x {args.shape}: skip: {p.reason}")
        return
    ops, _ = trace(p)
    bufs = argument_buffers(p)
    print(f"== {args.arch} x {args.shape} on {args.mesh} "
          f"{overrides or ''}")
    print(f"flops (whole step)={sum(ops.values()) / 1e12:.2f}TF "
          f"args/rank={sum(b for b, *_ in bufs) / 1e9:.2f}GB")

    print("\n-- top aten ops by FLOPs (whole step) --")
    for op, fl in sorted(ops.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"{fl / 1e9:14.1f} GF  {op}")

    print("\n-- largest argument buffers (per rank) --")
    same = collections.Counter((shape, dt) for _, _, shape, dt in bufs)
    for nbytes, path, shape, dt in bufs[:args.top]:
        print(f"{nbytes / 1e9:10.3f} GB  x{same[(shape, dt)]:4d}  "
              f"{dt}{list(shape)}  {path}")


if __name__ == "__main__":
    main()
