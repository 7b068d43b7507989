"""Simulated fleet: K wall-clock trials on one stacked carry.

Counterpart of `repro/fleet/sim.py`, which runs K lanes as
``jit(scan(vmap(sim_body)))``. Here the K lanes share the compiled
simulator's carry (`sim.compiled`) with a leading trial axis: (K,) clocks,
(K, W+1, N) epoch windows, (K, 2) scenario and latency keys, stacked
scenario, latency and policy parameters. One fill and one round body run
all lanes: the fill count is the most any lane's clock asks for, and a
lane draws only while its own ``e_next <= k0 + W``.

The policy algebra is parametric (`sim.policies.policy_params`), so lanes
may mix policies (WaitForAll beside BufferedKofN) in one program.
Scenario processes and latency models must each share a class across the
lanes (one sample function over the stacked states); their parameters may
differ per lane. Local training is vmapped over the lanes and the server
step runs per lane (`fleet.executor.make_fleet_body`: a ctypes kernel
cannot run under `vmap`), so `MIFA(array)` launches `mifa_aggregate` K
times a round. Per lane the trajectory is the one `sim.compiled.
SimScanDriver` gives for that (seed, policy, scenario, latency)
(`tests/test_torch_sim_compiled.py`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.scan_engine import (_eval_rounds, chunk_bounds,
                                          run_pipelined_chunks)
from repro_torch.fleet.executor import FleetHistory, FleetRunner
from repro_torch.kernels.backend import DEFAULT_DEVICE
from repro_torch.scenarios.base import as_process
from repro_torch.sim.compiled import (SimChunkRunner, make_sim_scan_body,
                                      unpack_sim_metrics)
from repro_torch.sim.engine import SimConfig
from repro_torch.sim.policies import init_policy_state, policy_params
from repro_torch.tree import tree_stack


@dataclass(frozen=True)
class SimTrial:
    """One lane of a simulated fleet: the trial's model-init and round
    `seed`, its server `policy`, its availability `scenario` (a process or
    a Scenario) and its `latency` model; `label` names it in the
    history."""

    seed: int
    policy: object
    scenario: object
    latency: object
    label: str | None = None


def _check_homogeneous(objs: Sequence, what: str) -> None:
    """All trials must share one class for `what` (one sample function
    over the stacked lanes)."""
    kinds = {type(o).__name__ for o in objs}
    if len(kinds) > 1:
        raise ValueError(
            f"all trials in one simulated fleet must share a {what} class "
            f"(one sample function over the stacked lanes); got "
            f"{sorted(kinds)} — split the sweep")


def run_sim_fleet(*, model, algo, batcher, schedule: Callable, n_rounds: int,
                  trials: Sequence[SimTrial],
                  config: SimConfig = SimConfig(),
                  eta_local: Callable | float | None = None,
                  weight_decay: float = 0.0, scan_chunk: int = 64,
                  eval_fn: Callable | None = None, eval_every: int = 10,
                  batch_fn: Callable | None = None, verbose: bool = False,
                  device: str | torch.device = DEFAULT_DEVICE
                  ) -> tuple[Any, FleetHistory]:
    """Run K simulated wall-clock trials on one stacked carry, on `device`.

    `model`, `algo`, `batcher`, `schedule`, `eta_local`, `weight_decay`
    as `core.runner.run_fl` takes them; the algorithm must be dense.
    `trials` are the `SimTrial` lanes: policies may differ per lane,
    scenario processes and latency models must share a class. `config` is
    shared (its window is a shape). `scan_chunk` rounds are staged at once
    (chunks cut after evals). `eval_fn` takes stacked (K, ...) params and
    returns ((K,) losses, (K,) accs) (`fleet.make_fleet_eval`); it runs
    every `eval_every` rounds and at the last, stamped per lane at that
    round's close + server overhead. `batch_fn` (optional, pure ``(t) ->
    batch`` on `device`, `data.pipeline.JitProceduralBatcher.batch_fn`)
    draws each round's batch in the round instead of staging it.
    `verbose` prints a line at each eval.

    Returns (stacked (K, ...) params, `FleetHistory`) with per-lane
    `sim_seconds`/`eval_seconds`; `hist.trial(k)` is lane k's `FLHistory`.
    The history's `sim` attribute holds the chunk runner (fills, replays,
    the per-round sync).
    """
    k_trials = len(trials)
    if k_trials == 0:
        raise ValueError("need at least one SimTrial")
    if getattr(algo, "cohort_based", False):
        raise NotImplementedError(
            "cohort-based algorithms assemble compact batches on the host; "
            "the simulated fleet needs a dense algorithm")
    n = batcher.n_clients
    procs = [as_process(tr.scenario) for tr in trials]
    lats = [tr.latency for tr in trials]
    _check_homogeneous(procs, "scenario process")
    _check_homogeneous(lats, "latency model")
    for obj in procs + lats:
        if obj.n != n:
            raise ValueError(f"a trial has {obj.n} devices, the batcher "
                             f"{n} clients")
    runner = FleetRunner(
        model=model, algo=algo, batcher=batcher, schedule=schedule,
        seeds=[tr.seed for tr in trials], eta_local=eta_local,
        weight_decay=weight_decay, device=device,
        labels=[tr.label or f"seed{tr.seed}:"
                f"{getattr(tr.policy, 'name', 'policy')}" for tr in trials])
    dev = runner.device
    w = config.max_lookahead_epochs
    fill, body = make_sim_scan_body(
        runner.body, procs[0].sample_fn(), lats[0].sample_fn(), config,
        weight_aware=getattr(algo, "weight_aware", False),
        batch_fn=batch_fn)
    gens = (runner.device_rngs if runner.round_rngs[0] is
            runner.device_rngs[0] else ())
    chunks = SimChunkRunner(fill, body, dev, w, (k_trials,),
                            generators=gens)
    zeros = torch.zeros(k_trials, dtype=torch.int64, device=dev)
    carry = {
        "algo": runner.state,
        "now": torch.zeros(k_trials, dtype=torch.float32, device=dev),
        "k0": zeros.clone(), "e_next": zeros.clone(),
        "win": torch.zeros((k_trials, w + 1, n), dtype=torch.bool,
                           device=dev),
        "scen_state": tree_stack([p.init_state(dev) for p in procs]),
        "scen_key": torch.stack([p.key for p in procs]).to(dev),
        "lat_state": tree_stack([lt.init_state(dev) for lt in lats]),
        "lat_key": torch.stack([lt.key for lt in lats]).to(dev),
        "pp": tree_stack([policy_params(tr.policy, n, dev)
                          for tr in trials]),
        "pstate": tree_stack([init_policy_state(n, dev) for _ in trials]),
        "tau": torch.zeros((k_trials, n), dtype=torch.int32, device=dev),
        "tau_max": torch.zeros((k_trials, n), dtype=torch.int32,
                               device=dev)}

    hist = runner.hist
    hist.sim = chunks
    evals = _eval_rounds(n_rounds, eval_every, eval_fn is not None)
    overhead = np.float32(config.server_overhead_s)
    last_close = {}

    def build_xs(t0, t1):
        rounds = []
        for t in range(t0, t1):
            eta_loc, eta_srv = runner.learning_rates(t)
            x = {"t": np.full(k_trials, t, np.int64), "eta_loc": eta_loc,
                 "eta_srv": eta_srv}
            if batch_fn is None:
                x["batch"] = batcher.sample_round(t)
            if hasattr(algo, "host_draw"):
                x["draw"] = np.stack([np.asarray(algo.host_draw(g, n))
                                      for g in runner.rngs])
            rounds.append(x)
        return chunks.stage(rounds)

    def chunk_fn(c, xs):
        c, params, ys = chunks.run(*c, xs)
        return (c, params), ys

    def writeback(c):
        runner.state, runner.params = c[0]["algo"], c[1]

    def flush(t0, t1, ys, _carry):
        y = unpack_sim_metrics(ys.cpu().numpy(), chunks.keys)
        for j, t in enumerate(range(t0, t1)):
            hist.record_round(t, {k: y[k][j] for k in (
                "loss", "n_active", "global_updates") if k in y},
                sim_time=y["t_close"][j])
        last_close["v"] = y["t_close"][-1]

    def on_sync(t):
        sim_t = (last_close["v"].astype(np.float32) + overhead).astype(
            np.float64)
        el, ea = eval_fn(runner.params)
        hist.record_eval(t, el, ea, sim_time=sim_t)
        if verbose:
            print(f"  round {t:5d} sim_t={sim_t.mean():10.2f}s "
                  f"loss={np.asarray(el).mean():.4f} "
                  f"acc={np.asarray(ea).mean():.4f}")

    t0 = time.time()
    final = run_pipelined_chunks(
        (carry, runner.params), chunk_bounds(n_rounds, scan_chunk, evals),
        chunk_fn=chunk_fn, build_xs=build_xs, writeback=writeback,
        flush=flush, sync_rounds=evals, on_sync=on_sync)
    hist.wall_time = time.time() - t0
    return final[1], hist
