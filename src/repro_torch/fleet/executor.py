"""Fleet executor — K independent FL trials run together on a trial axis.

Counterpart of `repro/fleet/executor.py`. The fleet stacks K trials along
a leading trial axis:

    params : (K, *shape)    state : per-algorithm leaves with a (K,) prefix
    masks  : (K, N) drawn on the host by the K trials' own processes

and each round runs as one fleet step:

  * dense algorithms — the round's batch is sampled once and shared by all
    trials (under scenarios the (K, N) masks are drawn on the device in
    the body: one sample over the trials' stacked states, (K, 2) keys and
    the round index staged once per trial); local training is
    `torch.func.vmap` over the trial axis of the runner's
    `client_updates` (which vmaps over clients). The server step
    runs per trial on views `state[k]`, `params[k]`: `MIFA(array)` launches
    its kernel through ctypes, which `vmap` cannot trace. The kernel writes
    G in place, and a view of a contiguous stacked leaf is contiguous, so
    its writes land in the stacked state; a step that returns new tensors
    (the plain versions on the CPU, the baselines) is copied back into the
    trial's slice.
  * cohort algorithms (`BankedMIFA`) — each distinct client of the round's
    cohorts (the union over trials, padded to a power of two) is sampled
    once; every trial gathers its (cap, ...) slice on the device. One
    batched scatter applies all K cohorts to every leaf of the bank in one
    launch (`bank_scatter_batched`, `paged_bank_scatter_batched`, on a leaf
    table), and a paged bank faults the union of the trials' cohorts in
    before the round.

Per trial the fleet computes what `core.runner.run_fl` computes for the
same seed and process: trial k is initialised as `RoundRunner(seed=s_k)`
(or from the stacked `params=`) and keeps its own round generators, a CPU
one and one on the device, seeded with s_k. τ statistics are not tracked
(as in the reference).

As in `core.runner`, a fleet round is host inputs (`fleet_inputs` /
`cohort_inputs`) and a body of device work (`make_fleet_body`);
`run_fleet(engine="scan")` runs the body through `FleetScanDriver`, which
stages each chunk's inputs in one copy and, on the card, replays the body
captured as a CUDA graph, per trial bit-equal to the loop.

Windowed scenarios (trace replay, and elastic fleets over it): the
trials' stacked (K, W, N) window is re-pointed in place between rounds on
the loop and between chunks on the scan; every trial of a group shares one
window length.

Meshes (`FleetRunner(mesh=, cfg=)`, `run_fleet(mesh=, cfg=)`): the trial
axis is split over the mesh's data ranks, as the reference shards it
(`sharding.rules.fleet_trial_specs` / `fleet_axis_specs`). At data extent
D > 1 (a world of CPU ranks, `sharding.clients`) each rank builds and runs
only its block of K / D trials, on either engine; masks are drawn for all
K trials and each rank keeps its rows. With `cfg` the trial params'
param dims are placed by `fleet_trial_specs` (the zoo's tensor
parallelism over `model`, `sharding.params.FleetPlacement`): between
rounds each rank holds its column blocks, and the algorithm state keeps
its trial-axis placement (`fleet_axis_specs`: whole beyond the trial
axis). Where `model` splits and the config is the GQA stack (dense or MoE)
(`FleetPlacement.split`, `sharding.tensor_parallel`) every trial's local
update runs on the rank's blocks under vmap over trials (split products:
each collective issued once for all trials and clients) and its updates
move whole, in the state's dtype; a dense round's per-trial server step
runs on whole params and the whole state, its new params cut back to the
blocks, and a cohort round's batched scatter takes the whole updates,
its whole mean cut to the blocks before the rate is applied. This is the
way in on the card (a DeviceMesh of CUDA ranks), where every round runs
uncaptured (`FleetScanDriver.eager`: gloo cannot be captured). For any
other config a round gathers the blocks whole for the local update and
the server step, on CPU ranks only: CUDA trial params raise, naming the
config's ROADMAP entry. `finalize` gathers the params' columns, then the
params, the per-trial state and the history over the data group, so
every rank returns all K, whole. A K that D does not divide is replicated
(`sanitize`): every rank runs every trial. At extent 1 nothing changes.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.func import vmap
from torch.profiler import record_function

from repro_torch.bank.base import check_unique_ids
from repro_torch.core.local_update import client_updates
from repro_torch.core.runner import (ENGINES, ROUND_PHASES, FLHistory,
                                     _pow2_bucket, cohort_width,
                                     round_rng_of, to_device,
                                     warn_engine_fallback)
from repro_torch.core.scan_engine import (ChunkRunner, _eval_rounds,
                                          chunk_bounds, pad_cohort,
                                          run_pipelined_chunks, runs_eager)
from repro_torch.fleet.spec import FleetSpec, Trial
from repro_torch.scenarios.base import as_process
from repro_torch.kernels.backend import (DEFAULT_DEVICE, resolve_device,
                                         set_numerics)
from repro_torch.sharding.clients import client_shard
from repro_torch.sharding.params import FleetPlacement
from repro_torch.tree import tree_index, tree_leaves, tree_map, tree_stack


@dataclass
class FleetHistory:
    """Per-round metrics with a leading (K,) trial axis. `trial(k)` gives
    one trial's view as a plain `FLHistory`."""

    n_trials: int
    labels: list[str] = field(default_factory=list)
    rounds: list = field(default_factory=list)
    train_loss: list = field(default_factory=list)     # (K,) per round
    n_active: list = field(default_factory=list)       # (K,) per round
    global_updates: list = field(default_factory=list)
    eval_loss: list = field(default_factory=list)      # (t, (K,)) per eval
    eval_acc: list = field(default_factory=list)
    sim_seconds: list = field(default_factory=list)    # (K,) close per round
    eval_seconds: list = field(default_factory=list)   # (t, (K,)) per eval
    wall_time: float = 0.0

    def record_round(self, t: int, metrics: dict, sim_time=None) -> None:
        """Append round t's (K,) metric vectors (loss, n_active, optional
        global_updates); `sim_time` stamps it with per-trial simulated
        seconds (`fleet.sim.run_sim_fleet`)."""
        self.rounds.append(t)
        self.train_loss.append(_host(metrics["loss"]))
        self.n_active.append(_host(metrics["n_active"]))
        if "global_updates" in metrics:
            self.global_updates.append(_host(metrics["global_updates"]))
        if sim_time is not None:
            self.sim_seconds.append(_host(sim_time))

    def record_eval(self, t: int, eval_loss, eval_acc,
                    sim_time=None) -> None:
        """Append an eval point: (round, (K,) losses) and (round, (K,)
        accuracies); `sim_time` also stamps it on the per-trial
        simulated-seconds axis (`eval_seconds`)."""
        self.eval_loss.append((t, _host(eval_loss)))
        self.eval_acc.append((t, _host(eval_acc)))
        if sim_time is not None:
            self.eval_seconds.append((t, _host(sim_time)))

    def stacked(self) -> dict:
        """{'train_loss': (K, T), 'n_active': (K, T), ...} arrays."""
        empty = np.zeros((self.n_trials, 0))
        out = {"rounds": np.asarray(self.rounds),
               "train_loss": np.stack(self.train_loss, axis=1)
               if self.train_loss else empty,
               "n_active": np.stack(self.n_active, axis=1)
               if self.n_active else empty}
        if self.global_updates:
            out["global_updates"] = np.stack(self.global_updates, axis=1)
        if self.eval_loss:
            out["eval_rounds"] = np.asarray([t for t, _ in self.eval_loss])
            out["eval_loss"] = np.stack([v for _, v in self.eval_loss], 1)
            out["eval_acc"] = np.stack([v for _, v in self.eval_acc], 1)
        if self.sim_seconds:
            out["sim_seconds"] = np.stack(self.sim_seconds, axis=1)
        if self.eval_seconds:
            out["eval_seconds"] = np.stack(
                [v for _, v in self.eval_seconds], 1)
        return out

    def trial(self, k: int) -> FLHistory:
        """Trial k's view as a plain `FLHistory` (scalars, not (K,) rows)."""
        h = FLHistory()
        h.rounds = list(self.rounds)
        h.train_loss = [float(v[k]) for v in self.train_loss]
        h.n_active = [float(v[k]) for v in self.n_active]
        h.global_updates = [float(v[k]) for v in self.global_updates]
        h.eval_loss = [(t, float(v[k])) for t, v in self.eval_loss]
        h.eval_acc = [(t, float(v[k])) for t, v in self.eval_acc]
        h.sim_seconds = [float(v[k]) for v in self.sim_seconds]
        h.eval_seconds = [(t, float(v[k])) for t, v in self.eval_seconds]
        h.wall_time = self.wall_time
        return h


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _write_trial(stacked, k: int, new) -> None:
    """Put trial k's new state (or params) into slice k of the stacked
    tree. A leaf the step wrote in place (a kernel writing through the
    view) is left alone; any other leaf is copied in."""
    def put(dst, src):
        view = dst[k]
        if (src.data_ptr() != view.data_ptr() or src.shape != view.shape
                or src.stride() != view.stride()):
            view.copy_(src)
    tree_map(put, stacked, new)


def make_fleet_body(model, algo, k_steps: int, weight_decay: float, *,
                    cohort: bool, rngs, scen_fn=None, placement=None):
    """One fleet round as a function of device tensors only,
    ``body(state, params, x) -> (state, params, metrics with (K,)
    leaves)``, the counterpart of `core.runner.make_round_body`.

    x (dense): ``batch`` shared by all trials, ``active`` (K, N),
    ``eta_loc``/``eta_srv`` (K,) and, for an algorithm with a `host_draw`,
    ``draw`` (K, N). x (cohort): ``ubatch`` (each distinct client of the
    round once), ``idx`` (K, C) into it, ``rows``/``valid`` (K, C) staged
    by the bank, and the rates. `rngs` are the trials' round generators of
    the kind the algorithm names. With `scen_fn` (dense algorithms) x
    carries ``t`` (K,) int64 in place of ``active``, the masks are drawn
    in the body over the stacked trials, and the state is ``{"algo",
    "scen_state", "scen_key"}``, as `core.runner.make_round_body`'s.

    With `placement` (a `sharding.params.FleetPlacement`) holding a split
    `params` is this rank's blocks: every trial's local update runs on
    them (`model.loss_fn(split=)`) and its updates move whole in the
    state's dtype; the dense server step gets whole params and its new
    params are cut back to the blocks, the cohort round's whole mean is
    cut to them before the rate is applied.
    """
    _, local_ph, server_ph = ROUND_PHASES
    host_draw = hasattr(algo, "host_draw")
    split = None if placement is None else placement.split
    loss_fn = model.loss_fn if split is None else (
        lambda p, b: model.loss_fn(p, b, split))

    def local(params, batch, eta_loc, batch_dim):
        """Local training of every trial, vmapped over the trial axis:
        `batch_dim` None shares one batch, 0 gives each trial its own."""
        def one(p, b, eta):
            return client_updates(loss_fn, p, b, eta, K=k_steps,
                                  weight_decay=weight_decay)
        with record_function(local_ph):
            return vmap(one, in_dims=(0, batch_dim, 0))(params, batch,
                                                        eta_loc)

    def dense(state, params, x):
        updates, losses = local(params, x["batch"], x["eta_loc"], None)
        if split is not None:
            # an update moves in the update array's dtype, to which the
            # server step rounds it anyway
            updates = placement.updates(updates, via=state.get("G"))
            params = placement.to_step(params)
        with record_function(server_ph):
            per_trial = []
            for k in range(len(rngs)):
                kw = {"draw": x["draw"][k]} if host_draw else {}
                st, p, metrics = algo.round_step(
                    tree_index(state, k), tree_index(params, k),
                    tree_index(updates, k), losses[k], x["active"][k],
                    x["eta_srv"][k], rng=rngs[k], **kw)
                _write_trial(state, k, st)
                _write_trial(params, k, p)
                per_trial.append(metrics)
            if split is not None:
                params = placement.from_step(params)
            return state, params, {key: torch.stack([m[key]
                                                     for m in per_trial])
                                   for key in per_trial[0]}

    def cohort_round(state, params, x):
        batch = {key: v[x["idx"]] for key, v in x["ubatch"].items()}
        updates, losses = local(params, batch, x["eta_loc"], 0)
        if split is not None:
            updates = placement.updates(
                updates, via=algo.bank.update_dtypes(state["bank"]))
        with record_function(server_ph):
            state, mean_g, metrics = algo.round_step_cohort_fleet(
                state, x["rows"], x["valid"], updates, losses, rng=rngs)
            if split is not None:
                mean_g = placement.from_step(mean_g)
            eta = x["eta_srv"]
            params = tree_map(
                lambda w, g: (w - eta.reshape((-1,) + (1,) * (w.ndim - 1))
                              * g).to(w.dtype), params, mean_g)
            return state, params, metrics

    def scenario_round(state, params, x):
        masks, scen_state = scen_fn(state["scen_key"], x["t"],
                                    state["scen_state"])
        algo_state, params, metrics = dense(state["algo"], params,
                                            {**x, "active": masks})
        return ({"algo": algo_state, "scen_state": scen_state,
                 "scen_key": state["scen_key"]}, params, metrics)

    if scen_fn is not None:
        return scenario_round
    return cohort_round if cohort else dense


class FleetRunner:
    """K-trial counterpart of `core.runner.RoundRunner`.

    The driver feeds `step(t, masks)` a (K, N) availability matrix, one row
    per trial, drawn by that trial's own participation process. `params`
    (optional) is a tree of stacked (K, ...) tensors; without it trial k is
    initialised as `model.init(seeds[k])` (on the CPU exactly as
    `RoundRunner(seed=seeds[k])`; a text model draws from a generator on
    the card there). Each trial keeps its own round
    generators (`rngs` on the CPU, `device_rngs` on the device), seeded
    with its seed. `scenarios` (one per trial, all of one type) replace
    the masks: `step_scenario` draws them on the device for a dense
    algorithm, from the host surfaces for a cohort one. `device` defaults
    to "cuda" and raises without a GPU. Under `mesh` (module docstring)
    the runner holds its rank's block of the trials (`trial_shard`,
    None where nothing is split): `n_trials` counts the block, `step`
    takes the masks of all K trials, and `finalize` gathers. With `cfg`
    the trial params are this rank's column blocks (`placement`, a
    `sharding.params.FleetPlacement`, None where they are whole).
    """

    def __init__(self, *, model, algo, batcher, schedule: Callable,
                 seeds: Sequence[int],
                 eta_local: Callable | float | None = None,
                 weight_decay: float = 0.0, uses_update_clock: bool = False,
                 cohort_capacity: int | None = None,
                 labels: Sequence[str] | None = None, params=None,
                 mesh=None, cfg=None, scenarios: Sequence | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        labels = list(labels or [f"seed{s}" for s in seeds])
        self.trial_shard = None if mesh is None else client_shard(
            mesh, len(seeds), self.device, what="the fleet's trial axis")
        if self.trial_shard is not None:
            block = slice(self.trial_shard.lo, self.trial_shard.hi)
            seeds, labels = list(seeds)[block], labels[block]
            if scenarios is not None:
                scenarios = list(scenarios)[block]
            if params is not None:
                params = tree_map(self.trial_shard.block, params)
        set_numerics()
        self.model = model
        self.algo = algo
        self.batcher = batcher
        self.schedule = schedule
        self.eta_local = eta_local
        self.weight_decay = weight_decay
        self.uses_update_clock = uses_update_clock
        self.cohort_capacity = cohort_capacity
        self.n_trials = len(seeds)
        self.n_clients = batcher.n_clients
        if params is None:
            # a seed: tabular models draw on the CPU, as RoundRunner's
            # generator does; text models on the params' device
            self.params = tree_stack([model.init(int(s), device=self.device)
                                      for s in seeds])
        else:
            self.params = tree_map(lambda p: torch.as_tensor(p).to(
                self.device, copy=True), params)
            for p in tree_leaves(self.params):
                if p.shape[0] != self.n_trials:
                    raise ValueError(f"params= leaves must be stacked "
                                     f"(K={self.n_trials}, ...), got "
                                     f"{tuple(p.shape)}")
        self.mesh, self.placement = mesh, None
        if mesh is not None and cfg is not None:
            placement = FleetPlacement(self.params, cfg, mesh,
                                       self.n_clients)
            if placement.placed:
                self.placement = placement
        # each trial's state as RoundRunner builds it, stacked leaf by leaf
        # (a paged bank resets its host mirror at each init, so the fleet
        # ends with one fresh mirror and K equal device tables)
        self.state = tree_stack([
            algo.init_state(tree_index(self.params, k), self.n_clients)
            for k in range(self.n_trials)])
        self.rngs = [torch.Generator().manual_seed(int(s)) for s in seeds]
        self.device_rngs = [torch.Generator(device=self.device).manual_seed(
            int(s)) for s in seeds]
        self.hist = FleetHistory(self.n_trials, labels=labels)
        self.cohort_mode = getattr(algo, "cohort_based", False)
        self.round_rngs = [round_rng_of(algo, c, d) for c, d in
                           zip(self.rngs, self.device_rngs)]
        self._scen_fn = self._scen_samplers = None
        self._init_scenarios(scenarios)
        placement = self.placement
        self.body = make_fleet_body(
            model, algo, batcher.k_steps, weight_decay,
            cohort=self.cohort_mode, rngs=self.round_rngs,
            scen_fn=self._scen_fn, placement=placement)
        if placement is not None:
            # the state was built from whole params; the carry holds blocks
            self.params = placement.place(self.params)
        if placement is not None and placement.split is None:
            inner = self.body

            def body(state, params, x):
                state, params, metrics = inner(state,
                                               placement.whole(params), x)
                return state, placement.place(params), metrics
            self.body = body

    def whole_params(self, params=None):
        """The stacked trial params (default: the runner's) with whole
        param dims."""
        params = self.params if params is None else params
        if self.placement is None:
            return params
        return self.placement.whole(params)

    def _init_scenarios(self, scenarios) -> None:
        """Wire one scenario per trial in: a dense fleet stacks their states
        (K, ...) and keys (K, 2) on the device and draws in the body; a
        cohort fleet keeps their host surfaces."""
        if scenarios is None:
            return
        procs = [as_process(s) for s in scenarios]
        if len(procs) != self.n_trials:
            raise ValueError(f"{len(procs)} scenarios for {self.n_trials} "
                             "trials")
        if any(type(p) is not type(procs[0]) for p in procs):
            raise ValueError(
                "all trials in one fleet group must share a scenario type "
                "(one sample function over the stacked trials); got "
                f"{sorted({type(p).__name__ for p in procs})}: split the "
                "sweep into one FleetSpec per type")
        for p in procs:
            if p.n != self.n_clients:
                raise ValueError(f"a scenario has {p.n} devices, the "
                                 f"batcher {self.n_clients} clients")
        # windowed processes (trace replay): the stacked (K, W, N) window
        # must be rectangular
        windows = {p.scan_window for p in procs}
        if len(windows) > 1:
            raise ValueError(
                "all trials in one fleet group must share the scenario "
                f"window length, got {sorted(map(str, windows))}")
        if self.cohort_mode:
            self._scen_samplers = [p.host_sampler() for p in procs]
            return
        self._scen_procs = procs
        self._scen_fn = procs[0].sample_fn()
        self.scen_state = tree_stack([p.init_state(self.device)
                                      for p in procs])
        self.scen_keys = torch.stack([p.key for p in procs]).to(self.device)
        self._scen_win_start = 0

    # ------------------------------------------------------------------ #
    def learning_rates(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        """(η_local (K,), η_server (K,)) f32 — per-trial update clocks,
        read on the host (one sync per round)."""
        if self.uses_update_clock and "t_updates" in self.state:
            clocks = self.state["t_updates"].cpu().numpy().astype(
                np.int64) + 1
        else:
            clocks = np.full(self.n_trials, t + 1, np.int64)
        eta_srv = np.array([float(self.schedule(int(c))) for c in clocks],
                           np.float32)
        if self.eta_local is None:
            eta_loc = eta_srv
        elif callable(self.eta_local):
            eta_loc = np.array([float(self.eta_local(int(c)))
                                for c in clocks], np.float32)
        else:
            eta_loc = np.full(self.n_trials, float(self.eta_local),
                              np.float32)
        return eta_loc, eta_srv

    def _check_masks(self, masks) -> np.ndarray:
        masks = np.asarray(masks, bool)
        sh = self.trial_shard
        if sh is not None and masks.shape[0] == sh.n_rows:
            masks = sh.block(masks)     # this rank's trials of all K
        if masks.shape != (self.n_trials, self.n_clients):
            raise ValueError(f"masks must be (K={self.n_trials}, "
                             f"N={self.n_clients}), got {masks.shape}")
        return masks

    def fleet_inputs(self, t: int, masks: np.ndarray | None) -> dict:
        """The host side of dense fleet round t: the shared batch, the
        (K, N) masks, the (K,) rates and any per-trial host draws. A
        scenario round (`masks` None) carries ``t`` (K,) int64, the same
        round for every trial, instead of the masks."""
        eta_loc, eta_srv = self.learning_rates(t)
        x = {"batch": self.batcher.sample_round(t), "eta_loc": eta_loc,
             "eta_srv": eta_srv}
        if masks is None:
            x["t"] = np.full(self.n_trials, t, np.int64)
        else:
            x["active"] = masks
        if hasattr(self.algo, "host_draw"):
            x["draw"] = np.stack([np.asarray(self.algo.host_draw(
                g, self.n_clients)) for g in self.rngs])
        return x

    def cohort_inputs(self, t: int, padded: np.ndarray, valid: np.ndarray,
                      width: int | None = None) -> dict:
        """The host side of cohort fleet round t for the padded (K, C)
        cohorts: each distinct client of the round sampled once (the union,
        padded with its first id to `width`, or to its power-of-two
        bucket), every trial's (C,) index into it, the staged rows, valid
        and the (K,) rates."""
        eta_loc, eta_srv = self.learning_rates(t)
        # pad slots take client 0's batch, as RoundRunner.step_cohort
        wanted = np.where(valid, padded, 0)
        uniq, inv = np.unique(wanted, return_inverse=True)
        width = _pow2_bucket(len(uniq)) if width is None else width
        uniq = np.concatenate([uniq, np.full(width - len(uniq), uniq[0])])
        return {"ubatch": self.batcher.sample_round(t, client_ids=uniq),
                "idx": inv.reshape(padded.shape).astype(np.int64),
                "rows": self.algo.bank.stage_rows(padded, valid),
                "valid": valid, "eta_loc": eta_loc, "eta_srv": eta_srv}

    def step(self, t: int, masks: np.ndarray) -> dict:
        """Apply round t to all trials; masks (K, N) bool applied-updates.
        Returns the round's metrics with (K,) leaves."""
        masks = self._check_masks(masks)
        if self.cohort_mode:
            return self.step_cohort(t, [np.flatnonzero(m) for m in masks])
        with record_function(ROUND_PHASES[0]):
            x = to_device(self.fleet_inputs(t, masks), self.device)
        self.state, self.params, metrics = self.body(self.state,
                                                     self.params, x)
        self.hist.record_round(t, metrics)
        return metrics

    def scenario_carry(self) -> dict:
        """The scenario body's state: the trials' algorithm states, their
        stacked scenario states and keys."""
        return {"algo": self.state, "scen_state": self.scen_state,
                "scen_key": self.scen_keys}

    def scenario_masks(self, t: int) -> np.ndarray:
        """(K, N) masks of round t from the trials' host surfaces (cohort
        fleets)."""
        return np.stack([s.sample(t) for s in self._scen_samplers])

    def step_scenario(self, t: int) -> dict:
        """Apply round t with availability drawn by each trial's scenario.

        Dense fleets: the (K, N) masks are drawn in the body, one sample
        over the stacked trials. Cohort fleets: the host surfaces draw the
        same masks and the round goes through `step`."""
        if self._scen_samplers is not None:
            return self.step(t, self.scenario_masks(t))
        if self._scen_fn is None:
            raise ValueError("construct FleetRunner(scenarios=...) to use "
                             "step_scenario")
        procs = self._scen_procs
        w = procs[0].scan_window
        if w is not None and not (self._scen_win_start <= t
                                  < self._scen_win_start + w):
            t0 = (t // w) * w
            procs[0].load_window_fleet(self.scen_state, procs, t0)
            self._scen_win_start = t0
        with record_function(ROUND_PHASES[0]):
            x = to_device(self.fleet_inputs(t, None), self.device)
        carry, self.params, metrics = self.body(self.scenario_carry(),
                                                self.params, x)
        self.state, self.scen_state = carry["algo"], carry["scen_state"]
        self.hist.record_round(t, metrics)
        return metrics

    def step_cohort(self, t: int,
                    ids_per_trial: Sequence[np.ndarray]) -> dict:
        """Cohort round for all trials; ids_per_trial[k] are trial k's
        active rows. All trials pad to one shared width (the power-of-two
        bucket of the largest cohort, or `cohort_capacity`); pad slots are
        inert."""
        if not self.cohort_mode:
            raise ValueError("step_cohort needs a cohort_based algorithm")
        n_trials = self.n_trials
        ids_per_trial = [np.asarray(i, np.int64) for i in ids_per_trial]
        for ids in ids_per_trial:
            check_unique_ids(ids)
        cmax = max((len(i) for i in ids_per_trial), default=0)
        cap = cohort_width(cmax, self.cohort_capacity)
        if self.cohort_capacity is not None and cmax > self.cohort_capacity:
            # the widening is shared by all trials, so a trial whose own
            # cohort fits no longer pads as its sequential run does
            warnings.warn(
                f"cohort of {cmax} overflows pinned cohort_capacity="
                f"{self.cohort_capacity}; widening all trials to {cap}",
                stacklevel=2)
        padded = np.full((n_trials, cap), self.n_clients, np.int64)
        valid = np.zeros((n_trials, cap), bool)
        for k, ids in enumerate(ids_per_trial):
            padded[k, :len(ids)] = ids
            valid[k, :len(ids)] = True
        with record_function(ROUND_PHASES[0]):
            x = to_device(self.cohort_inputs(t, padded, valid), self.device)
            self.state = self.algo.prepare_cohort(self.state, padded[valid])
        self.state, self.params, metrics = self.body(self.state,
                                                     self.params, x)
        self.hist.record_round(t, metrics)
        return metrics

    def evaluate(self, t: int, eval_fn: Callable) -> tuple[Any, Any]:
        """eval_fn consumes stacked params -> ((K,) losses, (K,) accs)."""
        el, ea = eval_fn(self.whole_params())
        self.hist.record_eval(t, el, ea)
        return el, ea

    def finalize(self) -> tuple[Any, FleetHistory]:
        """Returns (stacked (K, ...) params, fleet history). Under a mesh
        that splits the trials it first gathers the params, the state and
        the history of all K trials from the data group (once)."""
        self.params, self.placement = self.whole_params(), None
        sh = self.trial_shard
        if sh is not None:
            self.params = tree_map(sh.gather, self.params)
            self.state = tree_map(sh.gather, self.state)
            self.hist = _gather_history(self.hist, sh.group)
            self.n_trials = self.hist.n_trials
            self.trial_shard = None
        return self.params, self.hist


def _gather_history(hist: FleetHistory, group) -> FleetHistory:
    """The histories of every rank's block of trials as one history of
    all K, in rank order (the trial order)."""
    import torch.distributed as dist
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, hist, group=group)
    out = FleetHistory(sum(h.n_trials for h in parts),
                       labels=[lb for h in parts for lb in h.labels])
    out.rounds, out.wall_time = list(hist.rounds), hist.wall_time
    for key in ("train_loss", "n_active", "global_updates", "sim_seconds"):
        setattr(out, key, [np.concatenate(rows) for rows in zip(
            *(getattr(h, key) for h in parts))])
    for key in ("eval_loss", "eval_acc", "eval_seconds"):
        setattr(out, key, [(pts[0][0], np.concatenate([v for _, v in pts]))
                           for pts in zip(*(getattr(h, key)
                                            for h in parts))])
    return out


def fleet_scan_supported(runner: FleetRunner) -> tuple[bool, str]:
    """Can this fleet run on the scan engine? (ok, reason)"""
    if runner.uses_update_clock:
        return False, ("update-clock schedules read per-trial device-side "
                       "counters between rounds; the host cannot precompute "
                       "a chunk of learning rates")
    bank = getattr(runner.algo, "bank", None)
    if runner.cohort_mode and not bank.on_device:
        return False, (f"{type(bank).__name__} is host-offloaded: its rows "
                       "live on the host, outside a captured round")
    return True, ""


class FleetScanDriver:
    """The fleet on the scan engine: K trials × a chunk of rounds staged
    at once, each round on the card a replay of the fleet body captured as
    a CUDA graph (`core.scan_engine.ChunkRunner`), per trial bit-equal to
    the loop. A dense scenario fleet stages each round's index for every
    trial and draws its masks in the graph; its scenario states ride the
    carry. Chunks cut after eval rounds as the single-run
    `core.scan_engine.ScanDriver`'s do; τ statistics are not tracked, as
    on the fleet's loop. A cohort fleet's shared batch is padded to one
    width for the whole run (the union's power-of-two bucket at most
    K·cap clients), so one graph serves every round. A split fleet on the
    card (`eager`, `core.scan_engine.runs_eager`: its rounds issue gloo
    collectives, which a CUDA graph cannot capture) runs every round
    uncaptured, counted in `eager_rounds`."""

    def __init__(self, runner: FleetRunner, *, scan_chunk: int = 64):
        if scan_chunk < 1:
            raise ValueError(f"scan_chunk must be >= 1, got {scan_chunk}")
        self.r = r = runner
        self.scan_chunk = scan_chunk
        self.scenario_mode = r._scen_fn is not None
        # windowed scenarios, as `core.scan_engine.ScanDriver`'s
        self._scan_window = (r._scen_procs[0].scan_window
                             if self.scenario_mode else None)
        if self._scan_window is not None and scan_chunk > self._scan_window:
            raise ValueError(
                f"scan_chunk={scan_chunk} exceeds the scenario's carried "
                f"availability window ({self._scan_window} rounds); raise "
                "the scenario's window= or lower scan_chunk")
        self._seg = None
        self._win_start = None
        if r.cohort_mode:
            self.cap = r.cohort_capacity or _pow2_bucket(r.n_clients)
            self.width = _pow2_bucket(min(r.n_clients, r.n_trials * self.cap))
        gens = (r.device_rngs if r.round_rngs[0] is r.device_rngs[0]
                else ())
        # decided once (`runs_eager`): does every round run the body itself
        # on the card?
        self.eager = runs_eager(r.device, r.placement)
        self.chunks = ChunkRunner(r.body, r.device, generators=gens,
                                  eager=self.eager)
        self._union = None

    @property
    def replays(self) -> int:
        return self.chunks.replays

    @property
    def eager_rounds(self) -> int:
        return self.chunks.eager_rounds

    def _build_xs(self, t0: int, t1: int, parts):
        r = self.r
        self._seg = (t0, t1)
        if self.scenario_mode:
            return self.chunks.stage([r.fleet_inputs(t, None)
                                      for t in range(t0, t1)])
        rounds, union = [], []
        for t in range(t0, t1):
            masks = r._check_masks(
                r.scenario_masks(t) if parts is None else
                np.stack([np.asarray(p.sample(t), bool) for p in parts]))
            if not r.cohort_mode:
                rounds.append(r.fleet_inputs(t, masks))
                continue
            padded = np.empty((r.n_trials, self.cap), np.int64)
            valid = np.empty((r.n_trials, self.cap), bool)
            for k in range(r.n_trials):
                ids = np.flatnonzero(masks[k])
                padded[k], valid[k] = pad_cohort(ids, self.cap, r.n_clients,
                                                 t)
            rounds.append(r.cohort_inputs(t, padded, valid, self.width))
            union.append(padded[valid])
        if r.cohort_mode:
            self._union = np.concatenate(union)
        return self.chunks.stage(rounds)

    def _pre_chunk(self, carry):
        """Page the chunk's cross-trial union in (cohort fleets), or
        re-point the trials' stacked window at the chunk in place
        (windowed scenarios)."""
        state, params = carry
        r = self.r
        if r.cohort_mode:
            return r.algo.prepare_cohort(state, self._union), params
        w, (t0, t1) = self._scan_window, self._seg
        if (self._win_start is None or not self._win_start <= t0
                or t1 > self._win_start + w):
            procs = r._scen_procs
            procs[0].load_window_fleet(state["scen_state"], procs, t0)
            self._win_start = r._scen_win_start = t0
        return carry

    def _chunk_fn(self, carry, xs):
        state, params, ys = self.chunks.run(*carry, xs)
        return (state, params), ys

    def _writeback(self, carry) -> None:
        state, self.r.params = carry
        if self.scenario_mode:
            self.r.state = state["algo"]
            self.r.scen_state = state["scen_state"]
        else:
            self.r.state = state

    def _flush(self, t0: int, t1: int, ys: torch.Tensor, carry) -> None:
        vals = ys.cpu().numpy()                       # (L, n_metrics, K)
        for j, t in enumerate(range(t0, t1)):
            self.r.hist.record_round(
                t, {k: vals[j, i] for i, k in enumerate(self.chunks.keys)})

    def run(self, n_rounds: int, *, parts=None,
            eval_fn: Callable | None = None, eval_every: int = 10,
            verbose: bool = False) -> None:
        """Rounds [0, n_rounds) for all trials, the runner updated in
        place. Without `parts` the trials' scenarios draw the masks;
        `verbose` prints a line at each eval."""
        r = self.r
        evals = _eval_rounds(n_rounds, eval_every, eval_fn is not None)

        def on_sync(t):
            el, ea = r.evaluate(t, eval_fn)
            if verbose:
                print(f"  round {t:5d} loss={np.asarray(el).mean():.4f} "
                      f"acc={np.asarray(ea).mean():.4f}")

        # the first carry is not kept here: a state that the rounds replace
        # (G_sum, params) is freed once the next chunk's is written back
        run_pipelined_chunks(
            ((r.scenario_carry() if self.scenario_mode else r.state),
             r.params),
            chunk_bounds(n_rounds, self.scan_chunk, evals),
            chunk_fn=self._chunk_fn,
            build_xs=lambda t0, t1: self._build_xs(t0, t1, parts),
            writeback=self._writeback, flush=self._flush,
            sync_rounds=evals, on_sync=on_sync,
            pre_chunk=(self._pre_chunk
                       if r.cohort_mode or self._scan_window is not None
                       else None))


def make_fleet_eval(model, eval_batch: dict, *,
                    device: str | torch.device = DEFAULT_DEVICE) -> Callable:
    """Vmapped eval: stacked params (K, ...) -> (losses (K,), accs (K,)) as
    numpy. `eval_batch` leaves (numpy or tensors) move to `device`; float
    leaves become float32, as the reference's `jnp.asarray` makes them."""
    dev = resolve_device(device)

    def as_tensor(v):
        t = torch.as_tensor(v)
        return (t.float() if t.is_floating_point() else t).to(dev)

    batch = {k: as_tensor(v) for k, v in eval_batch.items()}

    def one(p):
        loss, _ = model.loss_fn(p, batch)
        return loss, model.accuracy(p, batch)

    def ev(params_stack):
        with torch.no_grad():
            losses, accs = vmap(one)(params_stack)
        return losses.cpu().numpy(), accs.cpu().numpy()

    return ev


def run_fleet(*, model, batcher, schedule: Callable, n_rounds: int,
              spec: FleetSpec | None = None, algo=None,
              trials: Sequence[Trial] | None = None,
              eta_local: Callable | float | None = None,
              weight_decay: float = 0.0, eval_fn: Callable | None = None,
              eval_every: int = 10, uses_update_clock: bool = False,
              cohort_capacity: int | None = None, params=None, mesh=None,
              cfg=None, engine: str = "loop", scan_chunk: int | None = None,
              verbose: bool = False,
              device: str | torch.device = DEFAULT_DEVICE
              ) -> tuple[Any, FleetHistory]:
    """Run T rounds of K independent trials as one fleet on `device`.

    The K-trial counterpart of `core.runner.run_fl`: pass a `FleetSpec`
    (algo + trials + clock flag + capacity), or `algo` + `trials`. Each
    trial's participation process draws its (N,) mask on the host exactly
    as `run_fl` would. `params` (optional) are stacked (K, ...) initial
    params, the fleet's counterpart of `run_fl(params=)`. `eval_fn`
    consumes stacked params and returns ((K,) losses, (K,) accs) (see
    `make_fleet_eval`); it runs every `eval_every` rounds and at the last,
    with a line printed each time under `verbose`.
    `uses_update_clock` drives the schedules off each trial's applied
    global updates; `cohort_capacity` pins the cohort pad width. Trials
    with `scenario` draw their masks as `FleetRunner.step_scenario` does;
    one group is all-participation or all-scenario.
    `engine` "scan" runs chunks of `scan_chunk` rounds (None: the spec's,
    else 64) through `FleetScanDriver`, falling back to the loop with a
    warning for update-clock schedules and host banks; "scan_strict"
    raises for those instead. `mesh` (and `cfg`) split the trial axis over
    the mesh's data ranks on either engine (module docstring); every rank
    returns all K.
    Returns (stacked params with a leading (K,) axis, `FleetHistory`).
    """
    if spec is not None:
        algo = spec.algo
        trials = spec.trials
        uses_update_clock = spec.uses_update_clock
        cohort_capacity = spec.cohort_capacity or cohort_capacity
        if scan_chunk is None:
            scan_chunk = spec.scan_chunk
    if algo is None or not trials:
        raise ValueError("pass a FleetSpec, or algo= and trials=")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: expected 'loop', "
                         "'scan', or 'scan_strict'")
    n_scen = sum(tr.scenario is not None for tr in trials)
    if n_scen not in (0, len(trials)):
        raise ValueError("mixing scenario and participation trials in one "
                         "fleet group is not supported")
    runner = FleetRunner(
        model=model, algo=algo, batcher=batcher, schedule=schedule,
        seeds=[tr.seed for tr in trials], eta_local=eta_local,
        weight_decay=weight_decay, uses_update_clock=uses_update_clock,
        cohort_capacity=cohort_capacity,
        labels=[tr.label or f"seed{tr.seed}" for tr in trials],
        params=params, mesh=mesh, cfg=cfg, device=device,
        scenarios=[tr.scenario for tr in trials] if n_scen else None)
    parts = None if n_scen else [tr.participation for tr in trials]
    if engine != "loop":
        ok, why = fleet_scan_supported(runner)
        if ok:
            t0 = time.time()
            FleetScanDriver(runner, scan_chunk=64 if scan_chunk is None
                            else scan_chunk).run(
                n_rounds, parts=parts, eval_fn=eval_fn,
                eval_every=eval_every, verbose=verbose)
            runner.hist.wall_time = time.time() - t0
            return runner.finalize()
        if engine == "scan_strict":
            raise ValueError(f"engine='scan_strict': {why}")
        warn_engine_fallback(f"engine='scan' unsupported for this fleet "
                             f"({why}); falling back to the per-round loop")
    t0 = time.time()
    for t in range(n_rounds):
        if n_scen:
            runner.step_scenario(t)
        else:
            runner.step(t, np.stack([np.asarray(p.sample(t), bool)
                                     for p in parts]))
        if eval_fn is not None and (t % eval_every == 0 or t == n_rounds - 1):
            el, ea = runner.evaluate(t, eval_fn)
            if verbose:
                print(f"  round {t:5d} loss={np.asarray(el).mean():.4f} "
                      f"acc={np.asarray(ea).mean():.4f}")
    runner.hist.wall_time = time.time() - t0
    return runner.finalize()
