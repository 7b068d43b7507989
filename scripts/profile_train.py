#!/usr/bin/env python3
"""Where a stub-frontend model's training round (and an encoder's score)
spends its time, on one GPU.

    python3 scripts/profile_train.py [--arch hubert-xlarge] [--clients 2]
        [--mb 2] [--seq 512] [--layers N] [--score-batch 4]
        [--score-seq 1024]

Builds a stub-frontend model (llava-next-34b or hubert-xlarge) at full
width (random params from seed 0; `--layers` cuts the depth) and each
round's batch as `chip_smoke.stub_batch` draws it: tokens and patches
(vision_text) or frames and labels (audio), leaves (N, K, mb, ...). For
an encoder-only model it first profiles one score
(`launch.steps.make_encoder_step`) of `--score-batch` x `--score-seq`
frames after a warm-up. Then it runs one warm-up round of
`launch.steps.make_train_step` (MIFA(array), G from zeros, all clients
active) and profiles the next, its batch made on the card first. For
each phase it prints the host ms, the device's busy ms and idle share,
the device ms by kind of work (the port's `mifa_aggregate` kernel,
matrix products, softmax, everything else), the device kernels and the
host's aten calls, the device ops that take the most time, and the
`torch.func.vmap` fallback warnings raised (an op without a batching
rule runs once a client). Prints one JSON object per phase; needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
KINDS = (("mifa_aggregate", ("mifa_aggregate_kernel",)),
         ("matmul", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas",
                     "splitK")),
         ("softmax", ("softmax", "SoftMax")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def split(prof, wall_ms: float) -> dict:
    """Device ms by kind, busy ms (the sum of kernel times: one stream),
    the idle share of the phase's wall time, the device kernels and the
    host's aten calls, and the top device ops."""
    by_kind = {k: 0.0 for k, _ in KINDS} | {"other": 0.0}
    ops, kernels, aten = {}, 0, 0
    for e in prof.key_averages():
        if e.device_type.name == "CPU" and e.key.startswith("aten::"):
            aten += e.count
        us = e.self_device_time_total
        if us <= 0 or e.device_type.name != "CUDA":
            continue
        by_kind[kind_of(e.key)] += us / 1e3
        ops[e.key] = (us / 1e3, e.count)
        kernels += e.count
    busy = sum(by_kind.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
    return {"host_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "device_ms_by_kind": by_kind,
            "device_kernels": kernels, "aten_calls": aten,
            "top_ops": [{"name": k[:90], "ms": v[0], "calls": v[1]}
                        for k, v in top]}


def profiled(fn) -> tuple[dict, list]:
    """Run fn() (ending in a device sync) under torch.profiler; its split
    and the distinct vmap fallback warnings it raised."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    fallbacks = sorted({str(w.message)[:160] for w in caught
                        if "performance drop" in str(w.message)})
    return split(prof, wall), fallbacks


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hubert-xlarge")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--mb", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--score-batch", type=int, default=4)
    ap.add_argument("--score-seq", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.backend import build_kernels, set_numerics
    from repro_torch.launch.steps import make_encoder_step, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import inv_t
    from repro_torch.tree import tree_map
    sys.path.insert(0, str(ROOT))
    from chip_smoke import stub_batch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    set_numerics()
    build_kernels(("mifa_aggregate",))
    cfg = get_config(args.arch)
    if cfg.modality not in ("vision_text", "audio"):
        print(f"profile_train: {cfg.name} is not a stub-frontend model",
              file=sys.stderr)
        return 1
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    n, k, mb, s = args.clients, cfg.fl_local_steps, args.mb, args.seq
    cfg = cfg.replace(fl_clients=n)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    head = {"arch": cfg.name, "layers": cfg.n_layers,
            "params": model.param_count(params)}
    if cfg.encoder_only:
        batch = {key: v[0, 0] for key, v in stub_batch(
            cfg, 1, 1, args.score_batch, args.score_seq, 0).items()}
        score = make_encoder_step(model)
        score(params, batch)
        torch.cuda.synchronize()
        row, fallbacks = profiled(lambda: score(params, batch))
        print(json.dumps({"phase": "score", **head,
                          "batch": args.score_batch, "seq": args.score_seq,
                          **row, "vmap_fallbacks": fallbacks}))
        del batch
    G = tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                       device="cuda"), params)
    step = make_train_step(model, cfg, n, k)
    active = torch.ones(n, dtype=torch.bool, device="cuda")
    state = {"params": params, "G": G}

    def one_round(r: int, batch: dict) -> None:
        eta = torch.tensor(inv_t(0.25)(r + 1), device="cuda")
        state["params"], state["G"], metrics = step(
            state["params"], state["G"], batch, active, eta)
        float(metrics["loss"])

    one_round(0, stub_batch(cfg, n, k, mb, s, 0))
    batch = stub_batch(cfg, n, k, mb, s, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row, fallbacks = profiled(lambda: one_round(1, batch))
    mode = "sequential" if cfg.sequential_clients else "vmap"
    print(json.dumps({"phase": "train_round", "mode": mode, **head,
                      "clients": n, "local_steps": k, "mb": mb, "seq": s,
                      "positions": n * k * mb * s, **row,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "vmap_fallbacks": fallbacks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
