#!/usr/bin/env python3
"""Which gloo collectives carry CUDA tensors in a world of two ranks on one
card: the transport of `sharding.tensor_parallel`.

    python3 scripts/gloo_cuda_probe.py

Spawns two processes on cuda:0 that meet on a FileStore, start a gloo
process group and build `make_host_mesh(1, 2, device="cuda")`; on the
model axis' group each runs all_reduce (SUM and MAX), all_gather,
all_gather_into_tensor and all_to_all on CUDA f32 and bf16 tensors, and
times a host-staged all_reduce of 2^20 and 2^24 f32 elements on CUDA and
on CPU tensors (three calls after a warm-up). Prints each rank's results
as JSON: "ok" with the values, or "fail" with the exception.
"""
import json
import os
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _try(res: dict, key: str, fn) -> None:
    try:
        res[key] = ["ok", fn()]
    except RuntimeError as e:
        res[key] = ["fail", repr(e)[:300]]


def rank_main(rank: int, world: int, out: str) -> None:
    from repro_torch.launch.mesh import make_host_mesh
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(out, "store"), world), rank=rank, world_size=world,
        timeout=timedelta(seconds=60))
    res: dict = {}
    try:
        g = make_host_mesh(1, world, device="cuda").get_group("model")
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]

            def x():
                return (torch.arange(6, device="cuda", dtype=torch.float32)
                        + 10 * rank).to(dt)

            def reduce(op):
                t = x()
                dist.all_reduce(t, op=op, group=g)
                return t.float().tolist()

            def gather():
                parts = [torch.empty_like(x()) for _ in range(world)]
                dist.all_gather(parts, x(), group=g)
                return [p.float().tolist() for p in parts]

            def gather_into():
                out_t = torch.empty(6 * world, device="cuda", dtype=dt)
                dist.all_gather_into_tensor(out_t, x(), group=g)
                return out_t.float().tolist()

            def to_all():
                ins = [t.contiguous() for t in x().reshape(world, -1)]
                outs = [torch.empty_like(t) for t in ins]
                dist.all_to_all(outs, ins, group=g)
                return [o.float().tolist() for o in outs]

            _try(res, f"all_reduce_sum_{name}",
                 lambda: reduce(dist.ReduceOp.SUM))
            _try(res, f"all_reduce_max_{name}",
                 lambda: reduce(dist.ReduceOp.MAX))
            _try(res, f"all_gather_{name}", gather)
            _try(res, f"all_gather_into_tensor_{name}", gather_into)
            _try(res, f"all_to_all_{name}", to_all)
        for n in (1 << 20, 1 << 24):
            for where in ("cuda", "cpu"):
                t = torch.ones(n, device=where)
                dist.all_reduce(t, group=g)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    dist.all_reduce(t, group=g)
                torch.cuda.synchronize()
                res[f"all_reduce_s_{where}_{n}"] = (
                    (time.perf_counter() - t0) / 3)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(rank_main, args=(2, out), nprocs=2, join=True)
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                print(r, json.dumps(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
