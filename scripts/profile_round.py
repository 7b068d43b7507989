#!/usr/bin/env python3
"""Where a round of the port's main path spends its time, on one GPU.

    python3 scripts/profile_round.py [--rounds 20]

Builds the paper's problem at full width as `chip_smoke.py` does (paper_mlp,
N=100, K=5, batch 100, p_min=0.1) and, for MIFA(array),
BankedMIFA(DenseBank()) and BankedMIFA(PagedDeviceBank(page_size=8)),
drives `RoundRunner.step` round by round under torch.profiler. The
runner marks its phases with profiler ranges
(`core.runner.ROUND_PHASES`): the round's batches assembled on the host and
copied to the card, local training (`client_updates`, K-step SGD vmapped
over clients) and the server step (MIFA / bank kernels, the weight update
and the sync that reads the round's loss). For each phase the script gives
its median host ms and the device ms of the work launched inside it; for
the round, its median host ms, the device's busy time and idle share, the
device time of the port's own kernels, and the device ops that take the
most time. Then it does the same for the million-client run of
`chip_smoke.py` (N = 10⁶, `RoundRunner.step_cohort` through the paged bank),
whose page-in (evictions to the host, uploads) the bank marks with its own
range (`bank.paged_device.PAGE_IN_RANGE`, nested in `round.batch`). Last,
two fleets of `chip_smoke.py`'s Figure 2 phase, K=3 trials (seeds 0-2,
participation seeds 100+s) through `fleet.FleetRunner.step`, which marks
the same phases: MIFA(array), and the cohort fleet BankedMIFA(DenseBank())
at the pinned cohort width 64. Prints one JSON object per row; needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# the hand-written kernels' CUDA names (src/repro_torch/kernels/csrc); a
# scatter kernel serves one bank and a fleet's K trials alike
PORT_KERNELS = ("mifa_aggregate_kernel", "bank_scatter_kernel",
                "paged_scatter_kernel", "paged_gather_kernel")
# profiled rounds of the million-client run, all past the warm-up that fills
# the free slots, so each of them evicts
MILLION_PROFILE_ROUNDS = 8


def phase_split(prof, phases, n_rounds: int) -> dict:
    """Median host ms and mean device ms per round of each phase range."""
    host = {p: [] for p in phases}
    device_us = dict.fromkeys(phases, 0.0)
    for e in prof.events():
        if e.name in host and e.device_type.name == "CPU":
            host[e.name].append(e.time_range.elapsed_us() / 1e3)
            device_us[e.name] += e.device_time_total
    return {p: {"host_ms": float(np.median(host[p])),
                "device_ms": device_us[p] / n_rounds / 1e3,
                "ranges": len(host[p])} for p in phases}


def profile_rounds(name, inputs, step, warmup: int, rounds: int,
                   phases) -> None:
    """Run `warmup` rounds, then profile `rounds` rounds of
    `step(t, inputs(t))` (each ends in a device sync) and print the JSON
    line of the phase split, device busy/idle, the port's kernels and the
    top device ops."""
    from torch.profiler import ProfilerActivity, profile
    for t in range(warmup):
        step(t, inputs(t))
    torch.cuda.synchronize()
    round_ms = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(warmup, warmup + rounds):
            x = inputs(t)
            t0 = time.perf_counter()
            step(t, x)                              # ends in a device sync
            round_ms.append((time.perf_counter() - t0) * 1e3)
    split = phase_split(prof, phases, rounds)
    # device ops, without the phase ranges' own device-side copies
    ops = [e for e in prof.key_averages()
           if e.device_type.name == "CUDA" and e.key not in phases]
    device_us = sum(e.self_device_time_total for e in ops)
    wall_ms = sum(round_ms)
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    port = {k: {"us": sum(e.self_device_time_total for e in ops
                          if k in e.key) / rounds,
                "launches": sum(e.count for e in ops
                                if k in e.key) / rounds}
            for k in PORT_KERNELS}
    print(json.dumps({
        "algo": name, "rounds": rounds,
        "round_ms_median": float(np.median(round_ms)),
        "phases": split,
        "device_busy_ms_per_round": device_us / rounds / 1e3,
        "device_idle_share": 1 - device_us / 1e3 / wall_ms,
        "port_kernels_per_round": port,
        "top_device_ops_us_per_round": [
            {"op": e.key[:80], "us": e.self_device_time_total / rounds,
             "calls": e.count // rounds}
            for e in top],
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_round: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (FLEET_CAP, FLEET_SEEDS, MILLION_SLOTS,
                            million_runner, paper_problem)
    from repro_torch.bank import BankedMIFA, DenseBank, PagedDeviceBank
    from repro_torch.bank.paged_device import PAGE_IN_RANGE
    from repro_torch.core import MIFA, BernoulliParticipation, RoundRunner
    from repro_torch.core.runner import ROUND_PHASES
    from repro_torch.fleet import FleetRunner
    from repro_torch.kernels.backend import build_kernels
    from repro_torch.optim import inv_t

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    build_kernels()
    model, batcher, probs, _ = paper_problem(device="cuda")
    for name, algo in (("mifa_array", MIFA()),
                       ("banked_dense",
                        BankedMIFA(DenseBank(device="cuda"))),
                       ("banked_paged",
                        BankedMIFA(PagedDeviceBank(page_size=8,
                                                   device="cuda")))):
        runner = RoundRunner(model=model, algo=algo, batcher=batcher,
                             schedule=inv_t(1.0), weight_decay=1e-3,
                             device="cuda")
        part = BernoulliParticipation(probs, seed=1)
        profile_rounds(name, part.sample, runner.step, 5, args.rounds,
                       ROUND_PHASES)
    # the million-client run: its first rounds fill free slots, so the
    # profiled rounds are past them and evict every round
    runner, _, draw = million_runner(model, model.init(0, device="cuda"))
    warmup = -(-MILLION_SLOTS // 64)
    profile_rounds("million_paged", lambda t: draw(), runner.step_cohort,
                   warmup, MILLION_PROFILE_ROUNDS,
                   ROUND_PHASES + (PAGE_IN_RANGE,))
    # two Figure 2 fleets of K=3 trials
    for name, algo, cap in (
            ("fleet_mifa_array", MIFA(), None),
            ("fleet_banked_dense", BankedMIFA(DenseBank(device="cuda")),
             FLEET_CAP)):
        fleet = FleetRunner(model=model, algo=algo, batcher=batcher,
                            schedule=inv_t(1.0), seeds=FLEET_SEEDS,
                            weight_decay=1e-3, cohort_capacity=cap,
                            device="cuda")
        parts = [BernoulliParticipation(probs, seed=100 + s)
                 for s in FLEET_SEEDS]
        profile_rounds(name, lambda t, ps=parts: np.stack(
            [p.sample(t) for p in ps]), fleet.step, 5, args.rounds,
            ROUND_PHASES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
