#!/usr/bin/env python3
"""Where a served model's prefill and decode spend their time, on one GPU.

    python3 scripts/profile_serve.py [--arch zamba2-7b] [--batch 4]
        [--prompt-len 2048] [--decode-steps 8] [--layers N]

Builds the model at full width (random params from seed 0, as
`launch.serve.serve` draws them; `--layers` cuts the depth), runs one
prefill to warm up, then profiles one prefill of `--batch` prompts of
`--prompt-len` tokens (after the n_patches patch embeddings of a
vision_text model; `launch.serve.prompt_batch`, as `serve` draws them) and `--decode-steps`
greedy decode steps under torch.profiler. For each phase it prints the host ms, the device's busy
ms and idle share, the device ms by kind of work (the port's
`flash_attention` and `ssd_scan` kernels, matrix products, everything
else) and the device ops that take the most time. Prints one JSON object
per phase; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# device kernels by kind, matched on the kernel's name
KINDS = (("flash_attention", ("flash_bf16_kernel", "flash_f32_kernel")),
         ("ssd_scan", ("ssd_scan_bf16_kernel", "ssd_scan_f32_kernel")),
         ("matmul", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas",
                     "splitK")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def device_split(prof, wall_ms: float) -> dict:
    """Device ms by kind, busy ms (the sum of kernel times: one stream) and
    the idle share of the phase's wall time; the top device ops."""
    by_kind = {k: 0.0 for k, _ in KINDS} | {"other": 0.0}
    ops = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0 or e.device_type.name != "CUDA":
            continue
        by_kind[kind_of(e.key)] += us / 1e3
        ops[e.key] = (us / 1e3, e.count)
    busy = sum(by_kind.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_ms_by_kind": by_kind,
            "top_ops": [{"name": k[:90], "ms": v[0], "calls": v[1]}
                        for k, v in top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.backend import build_kernels, set_numerics
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import build_model

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    set_numerics()
    build_kernels(("flash_attention", "ssd_scan"))
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    B, P, T = args.batch, args.prompt_len, args.decode_steps
    batch, base = prompt_batch(cfg, B, P, torch.Generator().manual_seed(0),
                               "cuda")
    # the warm-up's cache is freed before the profiled one is made: a
    # llava-next-34b cache is 1.44 GB beside 68.8 GB of weights
    model.prefill(params, batch, model.init_cache(B, base + T,
                                                  device="cuda"))
    cache = model.init_cache(B, base + T, device="cuda")
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    rows = []
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows.append({"phase": "prefill", "arch": cfg.name,
                 "layers": cfg.n_layers, "batch": B, "prompt": P,
                 "positions": base,
                 "host_ms": wall, **device_split(prof, wall)})
    tok = logits.argmax(-1)[:, None]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for i in range(T):
            logits, cache = model.decode_step(params, tok, base + i, cache)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = device_split(prof, wall)
    rows.append({"phase": "decode", "arch": cfg.name, "layers": cfg.n_layers,
                 "batch": B, "steps": T, "host_ms_per_step": wall / T,
                 "device_busy_ms_per_step": split["device_busy_ms"] / T,
                 **split})
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
