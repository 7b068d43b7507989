"""Host-side FL training loop: participation process + data + algorithm.

Counterpart of `repro/core/runner.py`. Each round the availability mask and
minibatches stream in from the host (they are the environment, not the
model); local K-step SGD and the server step run on the run's device,
which every entry point takes as `device=` (default "cuda", raising when
no GPU is present).

Availability comes from a host participation process (``.sample(t) ->
(N,) bool``) or from a scenario (`repro_torch.scenarios`). Under a
scenario, dense algorithms draw the mask inside the round body from the
scenario's device surface (keyed by the round index, a device tensor in
the round's inputs), and the loop reads it back once a round for the τ
statistics; cohort algorithms take the scenario's host surface, which
draws the same masks.

Two round paths, selected by the algorithm:
  * dense (default)              — `client_updates` over ALL N clients, then
    `algo.round_step` on the (N, ...) update array;
  * cohort (`algo.cohort_based`) — only the active cohort's batches are
    sampled and updated: compact (C, ...) leaves where C is |A(t)| padded to
    a power-of-two bucket (or `cohort_capacity`), applied through the
    algorithm's memory bank. Pad slots carry valid=False and point at the
    bank's dummy row N.

A round is split in two (`make_round_body`): the host assembles its inputs
(`RoundRunner.round_inputs` / `cohort_inputs`: the mask or the staged
cohort, the batch, both learning rates, any host draw) as numpy, and the
body runs the round on device tensors alone: local training, the server
step, the new state and params, the metrics. The loop engine moves one
round's inputs to the device and calls the body; the scan engine
(`core.scan_engine`) stages a chunk of rounds' inputs at once and, on the
card, replays the body captured as a CUDA graph. Both run the same body.

Randomness. Each run keeps two round generators seeded with the run's
seed: a CPU `torch.Generator` (`RoundRunner.rng`) and one on the run's
device (`RoundRunner.device_rng`). An algorithm names the one its
`round_step(..., rng=)` (or `round_step_cohort(..., rng=)`) takes in its
`round_rng` attribute: "device" for the int8 memories, whose stochastic
rounding draws inside the round, "cpu" otherwise (the default). An
algorithm that draws on the host (the sampling baselines' device
selection) defines `host_draw(rng, n)`: the runner calls it with the CPU
generator once a round, in round order, as part of the round's inputs,
and the body passes the draw to `round_step(..., draw=)`.

With `uses_update_clock` the schedules count applied global updates
(`state["t_updates"]`, read on the host before each round) instead of
rounds; the scan engine runs such schedules on the loop.

Simulated time (`run_fl(sim=)`, `repro_torch.sim`): the simulator decides
when each round closes and whose updates arrived, and stamps every round
(`sim_time=` on `step`, `step_scenario`, `step_cohort` and `evaluate`) in
simulated seconds: `FLHistory.sim_seconds` and `eval_seconds`, and the
`TauStats` timeline. A weight-aware algorithm (`FedBuffAvg`) takes the
simulator's staleness weights in place of the bool mask.

Windowed scenarios (trace replay, `scenarios.trace_replay`) carry a
window of masks in the scenario state; the loop re-points it between
rounds when the round leaves it (the scan engine between chunks).
Checkpoints (`run_fl(checkpoint=)`, `checkpoint.run_state`) ride the scan
engine's chunk cuts.

Meshes (`run_fl(mesh=, cfg=)`, `launch.mesh`, `sharding`) place the scan
engine's carry (`core.scan_engine`, "Meshes"). The reference's
`warn_legacy_threefry` has no counterpart: it warns when JAX's legacy,
sharding-dependent threefry lowering is on, and the port draws only the
partitionable stream (`scenarios._threefry`), whose masks do not depend
on the mesh.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.bank.base import check_unique_ids
from repro_torch.core.local_update import client_updates
from repro_torch.core.participation import TauStats
from repro_torch.kernels.backend import (DEFAULT_DEVICE, resolve_device,
                                         set_numerics)
from repro_torch.tree import tree_map


@dataclass
class FLHistory:
    """Per-round history. `global_updates` is filled by algorithms that
    report it (the sampling baselines); `sim_seconds` (each round's close)
    and `eval_seconds` ((round, seconds) per eval) by simulated runs."""

    rounds: list = field(default_factory=list)
    train_loss: list = field(default_factory=list)
    eval_loss: list = field(default_factory=list)
    eval_acc: list = field(default_factory=list)
    n_active: list = field(default_factory=list)
    global_updates: list = field(default_factory=list)
    sim_seconds: list = field(default_factory=list)
    eval_seconds: list = field(default_factory=list)
    wall_time: float = 0.0
    tau_bar: float = 0.0
    tau_max: int = 0

    def as_dict(self) -> dict:
        """Plain-dict view of every history field (JSON-serialisable)."""
        return {k: getattr(self, k) for k in
                ("rounds", "train_loss", "eval_loss", "eval_acc", "n_active",
                 "global_updates", "sim_seconds", "eval_seconds", "wall_time",
                 "tau_bar", "tau_max")}

    def record_round(self, t: int, metrics: dict,
                     sim_time: float | None = None) -> None:
        """Append round t's metrics dict (loss, n_active, optional
        global_updates); `sim_time` stamps it with simulated seconds."""
        self.rounds.append(t)
        self.train_loss.append(float(metrics["loss"]))
        self.n_active.append(float(metrics["n_active"]))
        if "global_updates" in metrics:
            self.global_updates.append(float(metrics["global_updates"]))
        if sim_time is not None:
            self.sim_seconds.append(float(sim_time))

    def record_eval(self, t: int, eval_loss: float, eval_acc: float,
                    sim_time: float | None = None) -> None:
        """Append an (round, value) eval point; `sim_time` also stamps it
        on the simulated-seconds axis (`eval_seconds`)."""
        self.eval_loss.append((t, float(eval_loss)))
        self.eval_acc.append((t, float(eval_acc)))
        if sim_time is not None:
            self.eval_seconds.append((t, float(sim_time)))

    def eval_curve(self) -> list[tuple[float, float, float]]:
        """(sim_seconds, eval_loss, eval_acc) triples; a round without a
        simulated stamp uses its round index as the time."""
        times = dict(self.eval_seconds)
        return [(times.get(t, float(t)), el, ea) for (t, el), (_, ea)
                in zip(self.eval_loss, self.eval_acc)]


def _pow2_bucket(c: int) -> int:
    """Smallest power of two >= c — pads cohorts into few shapes."""
    return 1 << max(int(np.ceil(np.log2(max(c, 1)))), 0)


def cohort_width(c: int, capacity: int | None) -> int:
    """Pad width of a cohort of c: `capacity` when pinned and c fits, else
    the power-of-two bucket of c."""
    return capacity if capacity is not None and c <= capacity \
        else _pow2_bucket(c)


def pad_cohort(ids: np.ndarray, n_clients: int,
               capacity: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Pad the cohort `ids` to `capacity` (a pinned pad width), or to its
    power-of-two bucket when none is pinned or the cohort overflows it. Pad
    slots point at the dummy row `n_clients` and are invalid. Returns
    (padded, valid)."""
    c = len(ids)
    cap = cohort_width(c, capacity)
    padded = np.full(cap, n_clients, np.int64)
    padded[:c] = ids
    return padded, np.arange(cap) < c


def apply_mean(params, mean_g, eta_srv):
    """Server step w <- w - η·mean_G (η a float or a 0-d tensor)."""
    return tree_map(lambda w, g: (w - eta_srv * g).to(w.dtype), params,
                    mean_g)


# Profiler ranges that split a round into its phases: the round's inputs
# assembled and on the device, local training, and the server step. The loop
# engine's history then reads the round's loss (a sync).
# `scripts/profile_round.py` reads them; with no profiler active a range
# costs one small host call.
ROUND_PHASES = ("round.batch", "round.local", "round.server")

_FALLBACK_WARNED: set[str] = set()


def warn_engine_fallback(msg: str, *, stacklevel: int = 3) -> None:
    """Warn ONCE per distinct message that a run falls back to the loop
    (sweeps hit one unsupported configuration many times; the message
    carries the reason, so distinct configurations still warn)."""
    if msg in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(msg)
    warnings.warn(msg, stacklevel=stacklevel)


def _reset_fallback_warnings() -> None:
    """Forget which fallback warnings fired (test isolation hook)."""
    _FALLBACK_WARNED.clear()


def to_device(tree, device: torch.device):
    """A tree of numpy arrays (0-d included) as tensors on `device`."""
    return tree_map(lambda v: torch.as_tensor(np.asarray(v)).to(device),
                    tree)



def make_round_body(model, algo, k_steps: int, weight_decay: float, *,
                    cohort: bool, rng=None, scen_fn=None,
                    track_tau: bool = False, clients=None, placement=None):
    """One round as a function of device tensors only:
    ``body(state, params, x) -> (state, params, metrics)``.

    x (dense): ``batch`` (leaves (N, K, mb, ...)), ``active`` (N,) bool,
    ``eta_loc`` and ``eta_srv`` (0-d f32) and, for an algorithm with a
    `host_draw`, ``draw``. x (cohort): ``batch`` (C, K, mb, ...), ``rows``
    (C,) as `bank.stage_rows` maps the padded cohort, ``valid`` (C,) bool
    and the two rates. `rng` is the round generator the algorithm names
    (`round_rng`). Nothing in the body reads a value back to the host, so
    the scan engine can capture it as a CUDA graph; the loop engine calls
    it once a round.

    With `scen_fn` (a scenario's `sample_fn()`, dense algorithms only) the
    mask is drawn in the body: x carries ``t`` (0-d int64) in place of
    ``active``, the state is ``{"algo", "scen_state", "scen_key"}`` and the
    metrics carry the round's ``mask``. With `track_tau` the state also
    carries ``tau`` and ``tau_max`` ((N,) int32, updated as `TauStats`
    updates them) and the metrics ``tau_sum`` and ``tau_sq_sum`` (int64),
    so the scan engine keeps the τ statistics on the device.

    With `clients` (a `sharding.clients.ClientShard`, under a mesh of data
    extent > 1) each rank trains only the clients it owns, on the batch
    every rank stages whole: the dense body takes the rank's block of the
    batch, the mask and any draw, and passes `clients=` to `round_step`;
    the cohort body (`clients` the bank's row shard) takes the cohort slots
    whose rows the rank owns. The reductions span the data group, so every
    rank computes the same params and metrics.

    With `placement` (a `sharding.params.StepPlacement`: params placed
    over mesh axes) `params` is this rank's blocks. Where the placement
    holds a split (`placement.split`, `model` of extent > 1 and a config
    of the GQA stack, dense or MoE) the local update runs on those blocks
    (`model.loss_fn(split=)`, split products) and the updates move from
    the params' blocks straight into the server step's: the update
    array's column blocks in its dtype (dense), or the bank's rows' column
    blocks, or whole for a bank held whole on every rank (cohort);
    otherwise the body gathers whole params for the local update (CPU
    ranks only) and cuts the updates. The dense server step runs on the
    client state's column blocks (the params moved to them) and its new
    params go back to their placement; the cohort server step's mean (the
    bank's G_sum) is taken to the params' placement.
    """
    _, local_ph, server_ph = ROUND_PHASES
    host_draw = hasattr(algo, "host_draw")
    sharded = {} if clients is None else {"clients": clients}
    split = None if placement is None else placement.split
    loss_fn = model.loss_fn if split is None else (
        lambda p, b: model.loss_fn(p, b, split))

    def updates_of(params, x):
        with record_function(local_ph):
            if cohort and not len(x["valid"]):
                # no slot of the cohort is this rank's
                return (tree_map(lambda p: p.new_zeros(
                            (0,) + tuple(p.shape), dtype=torch.float32),
                            params), x["eta_loc"].new_zeros(0))
            return client_updates(loss_fn, params, x["batch"],
                                  x["eta_loc"], K=k_steps,
                                  weight_decay=weight_decay)

    def dense(state, params, x):
        if clients is not None:
            x = {**x, "batch": tree_map(clients.block, x["batch"]),
                 "active": clients.block(x["active"])}
            if host_draw:
                x["draw"] = clients.block(x["draw"])
        if placement is None:
            updates, losses = updates_of(params, x)
        elif split is not None:
            updates, losses = updates_of(params, x)
            # an update moves in the update array's dtype, to which the
            # server step rounds it anyway
            updates = placement.updates(updates, via=state.get("G"))
            params = placement.to_step(params)
        else:
            whole = placement.whole(params)
            updates, losses = updates_of(whole, x)
            updates, params = (placement.updates(updates),
                               placement.to_step(whole))
        with record_function(server_ph):
            kw = {"draw": x["draw"]} if host_draw else {}
            state, params, metrics = algo.round_step(
                state, params, updates, losses, x["active"], x["eta_srv"],
                rng=rng, **kw, **sharded)
            if placement is not None:
                params = placement.from_step(params)
            return state, params, metrics

    def cohort_round(state, params, x):
        if clients is not None:
            rows = x["rows"]
            mine = torch.nonzero(x["valid"] & (rows >= clients.lo)
                                 & (rows < clients.hi)).flatten()
            x = {**x, "batch": tree_map(lambda v: v[mine], x["batch"]),
                 "rows": rows[mine], "valid": x["valid"][mine]}
        bank = algo.bank
        if split is None:
            updates, losses = updates_of(
                params if placement is None else placement.whole(params), x)
            updates = bank.cols(updates)
        else:
            updates, losses = updates_of(params, x)
            if len(x["valid"]):
                updates = placement.updates(
                    updates, bank.update_specs or placement.whole_specs,
                    via=bank.update_dtypes(state["bank"]))
        with record_function(server_ph):
            state, mean_g, metrics = algo.round_step_cohort(
                state, x["rows"], x["valid"], updates, losses, rng=rng,
                **sharded)
            if placement is not None:
                mean_g = placement.to_params(
                    mean_g, getattr(algo.bank, "sum_specs", None))
            return state, apply_mean(params, mean_g, x["eta_srv"]), metrics

    def scenario_round(state, params, x):
        mask, scen_state = scen_fn(state["scen_key"], x["t"],
                                   state["scen_state"])
        algo_state, params, metrics = dense(state["algo"], params,
                                            {**x, "active": mask})
        new = {"algo": algo_state, "scen_state": scen_state,
               "scen_key": state["scen_key"]}
        if track_tau:
            tau = torch.where(mask, 0, state["tau"] + 1)
            new["tau"] = tau
            new["tau_max"] = torch.maximum(state["tau_max"], tau)
            tau64 = tau.long()
            metrics = {**metrics, "tau_sum": tau64.sum(),
                       "tau_sq_sum": (tau64 * tau64).sum()}
        return new, params, {**metrics, "mask": mask}

    if scen_fn is not None:
        return scenario_round
    return cohort_round if cohort else dense


def round_rng_of(algo, cpu_rng, device_rng):
    """The round generator `algo.round_rng` names ("cpu" by default)."""
    kind = getattr(algo, "round_rng", "cpu")
    if kind not in ("cpu", "device"):
        raise ValueError(f"round_rng must be 'cpu' or 'device', got {kind!r}")
    return device_rng if kind == "device" else cpu_rng


class RoundRunner:
    """One federated round + bookkeeping.

    `params` (optional) is a tree of tensors, moved to `device`; without it
    the model is initialised from a torch.Generator seeded with `seed`.
    The round generators `rng` (CPU) and `device_rng` (on `device`) are
    seeded with `seed`, the same whether or not `params` is given (the
    reference splits its round key from PRNGKey(seed) either way).
    `cohort_capacity` pins the cohort path's pad width. `scenario` (a
    `repro_torch.scenarios` Scenario or process) wires in-round sampling
    for dense algorithms (`step_scenario`): its state and key live on the
    run's device (`scen_state`, `scen_key`). Cohort algorithms take its
    host surface.
    """

    def __init__(self, *, model, algo, batcher, schedule: Callable,
                 eta_local: Callable | float | None = None,
                 weight_decay: float = 0.0, seed: int = 0, params=None,
                 uses_update_clock: bool = False,
                 cohort_capacity: int | None = None, scenario=None,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        set_numerics()
        self.model = model
        self.algo = algo
        self.batcher = batcher
        self.schedule = schedule
        self.eta_local = eta_local
        self.weight_decay = weight_decay
        self.uses_update_clock = uses_update_clock
        self.cohort_capacity = cohort_capacity
        self.rng = torch.Generator().manual_seed(seed)
        self.device_rng = torch.Generator(device=self.device).manual_seed(
            seed)
        if params is None:
            self.params = model.init(torch.Generator().manual_seed(seed),
                                     device=self.device)
        else:
            self.params = tree_map(lambda p: p.to(self.device), params)
        self.n_clients = batcher.n_clients
        self.state = algo.init_state(self.params, self.n_clients)
        # strict=False, as in the reference: a round-0 absentee counts τ
        # from a virtual round −1
        self.stats = TauStats(self.n_clients, strict=False)
        self.hist = FLHistory()
        self.cohort_mode = getattr(algo, "cohort_based", False)
        self.round_rng = round_rng_of(algo, self.rng, self.device_rng)
        self.scen_process = self._scen_sampler = None
        scen_fn = self._init_scenario(scenario)
        # `body` takes the mask (or cohort) as an input, `scen_body` draws
        # it from the scenario (dense algorithms under a scenario)
        self.body = make_round_body(model, algo, batcher.k_steps,
                                    weight_decay, cohort=self.cohort_mode,
                                    rng=self.round_rng)
        self.scen_body = None if scen_fn is None else make_round_body(
            model, algo, batcher.k_steps, weight_decay, cohort=False,
            rng=self.round_rng, scen_fn=scen_fn)

    def _init_scenario(self, scenario):
        """Wire a scenario (or bare process) in; returns the sample
        function the dense body draws from (None without a scenario, and
        for cohort algorithms, which take the host surface)."""
        if scenario is None:
            return None
        from repro_torch.scenarios.base import as_process
        proc = as_process(scenario)
        if proc.n != self.n_clients:
            raise ValueError(f"the scenario has {proc.n} devices, the "
                             f"batcher {self.n_clients} clients")
        self.scen_process = proc
        if self.cohort_mode:
            self._scen_sampler = proc.host_sampler()
            return None
        self.scen_state = proc.init_state(self.device)
        self.scen_key = proc.key.to(self.device)
        # a windowed process's state covers rounds [0, W) at first; the
        # loop re-points it between rounds (`step_scenario`)
        self._scen_win_start = 0
        return proc.sample_fn()

    def learning_rates(self, t: int) -> tuple[float, float]:
        """η_local, η_server for round t (schedules count from 1; with the
        update clock they count applied global updates instead)."""
        if self.uses_update_clock and "t_updates" in self.state:
            clock = int(self.state["t_updates"]) + 1
        else:
            clock = t + 1
        eta_srv = float(self.schedule(clock))
        if self.eta_local is None:
            eta_loc = eta_srv
        elif callable(self.eta_local):
            eta_loc = float(self.eta_local(clock))
        else:
            eta_loc = float(self.eta_local)
        return eta_loc, eta_srv

    def _rates(self, t: int) -> dict:
        eta_loc, eta_srv = self.learning_rates(t)
        return {"eta_loc": np.asarray(eta_loc, np.float32),
                "eta_srv": np.asarray(eta_srv, np.float32)}

    def round_inputs(self, t: int, active: np.ndarray | None) -> dict:
        """The host side of dense round t: its numpy inputs for the body
        (the batch, the mask, both rates and any host draw). A scenario
        round (`active` None) carries the round index ``t`` (0-d int64)
        instead of the mask, which the body draws. A float `active` (the
        simulator's staleness weights) stays f32."""
        x = {"batch": self.batcher.sample_round(t), **self._rates(t)}
        if active is None:
            x["t"] = np.asarray(t, np.int64)
        else:
            active = np.asarray(active)
            x["active"] = (active if active.dtype == bool
                           else active.astype(np.float32))
        if hasattr(self.algo, "host_draw"):
            x["draw"] = np.asarray(self.algo.host_draw(self.rng,
                                                       self.n_clients))
        return x

    def cohort_inputs(self, t: int, padded: np.ndarray,
                      valid: np.ndarray) -> dict:
        """The host side of cohort round t for the padded cohort: the
        compact batch, the bank's staged rows, valid and both rates."""
        # pad slots still need some real client's batch; row 0's content
        # is computed then discarded by the valid mask
        return {"batch": self.batcher.sample_round(
                    t, client_ids=np.where(valid, padded, 0)),
                "rows": self.algo.bank.stage_rows(padded, valid),
                "valid": valid, **self._rates(t)}

    def step(self, t: int, active: np.ndarray,
             sim_time: float | None = None) -> dict:
        """Apply one round with `active` (N,) bool as the applied-update
        mask (f32 staleness weights for a weight-aware algorithm);
        `sim_time` stamps it with simulated seconds. Returns the round's
        metrics dict."""
        active = np.asarray(active)
        mask = active.astype(bool)
        self.stats.update(mask, sim_time=sim_time)
        if self.cohort_mode:
            return self.step_cohort(t, np.flatnonzero(mask),
                                    sim_time=sim_time)
        with record_function(ROUND_PHASES[0]):
            x = to_device(self.round_inputs(t, active), self.device)
        self.state, self.params, metrics = self.body(self.state,
                                                     self.params, x)
        self.hist.record_round(t, metrics, sim_time=sim_time)
        return metrics

    def scenario_carry(self) -> dict:
        """The scenario body's state: the algorithm's, the scenario's and
        its key."""
        return {"algo": self.state, "scen_state": self.scen_state,
                "scen_key": self.scen_key}

    def step_scenario(self, t: int, sim_time: float | None = None) -> dict:
        """Apply one round with availability drawn by the scenario;
        `sim_time` stamps it.

        Dense algorithms: the body draws the mask on the device from round
        t's key; the mask is read back once for the τ statistics. Cohort
        algorithms: the host surface draws the same mask and the round
        goes through `step`."""
        if self.scen_process is None:
            raise ValueError("construct RoundRunner(scenario=...) to use "
                             "step_scenario")
        if self.cohort_mode:
            return self.step(t, self._scen_sampler.sample(t),
                             sim_time=sim_time)
        w, ws = self.scen_process.scan_window, self._scen_win_start
        if w is not None and not ws <= t < ws + w:
            t0 = (t // w) * w
            self.scen_process.load_window(self.scen_state, t0)
            self._scen_win_start = t0
        with record_function(ROUND_PHASES[0]):
            x = to_device(self.round_inputs(t, None), self.device)
        carry, self.params, metrics = self.scen_body(self.scenario_carry(),
                                                     self.params, x)
        self.state, self.scen_state = carry["algo"], carry["scen_state"]
        self.stats.update(metrics["mask"].cpu().numpy(), sim_time=sim_time)
        self.hist.record_round(t, metrics, sim_time=sim_time)
        return metrics

    def step_cohort(self, t: int, ids: np.ndarray,
                    sim_time: float | None = None) -> dict:
        """Apply one O(|A|·d) cohort round; `ids` are the active client
        rows, `sim_time` the optional simulated-seconds stamp.

        Called directly, τ statistics are skipped (TauStats is O(N)); `step`
        keeps them.
        """
        if not self.cohort_mode:
            raise ValueError("step_cohort needs a cohort_based algorithm")
        with record_function(ROUND_PHASES[0]):
            ids = np.asarray(ids, np.int64)
            check_unique_ids(ids)    # duplicates would corrupt G_sum
            padded, valid = pad_cohort(ids, self.n_clients,
                                       self.cohort_capacity)
            x = to_device(self.cohort_inputs(t, padded, valid), self.device)
            self.state = self.algo.prepare_cohort(self.state, padded[valid])
        self.state, self.params, metrics = self.body(self.state,
                                                     self.params, x)
        self.hist.record_round(t, metrics, sim_time=sim_time)
        return metrics

    def evaluate(self, t: int, eval_fn: Callable,
                 sim_time: float | None = None) -> tuple[float, float]:
        """Run `eval_fn(params) -> (loss, acc)` and record it at round t
        (stamped at `sim_time` simulated seconds when given)."""
        el, ea = eval_fn(self.params)
        self.hist.record_eval(t, el, ea, sim_time=sim_time)
        return float(el), float(ea)

    def finalize(self) -> tuple[Any, FLHistory]:
        """Seal τ statistics into the history; returns (params, history)."""
        self.hist.tau_bar = self.stats.tau_bar
        self.hist.tau_max = self.stats.tau_max
        return self.params, self.hist


ENGINES = ("loop", "scan", "scan_strict")


def run_fl(*, model, algo, batcher, schedule: Callable, n_rounds: int,
           participation=None, scenario=None, sim=None,
           eta_local: Callable | float | None = None,
           weight_decay: float = 0.0, seed: int = 0,
           eval_fn: Callable | None = None, eval_every: int = 10,
           params=None, uses_update_clock: bool = False,
           cohort_capacity: int | None = None, engine: str = "loop",
           scan_chunk: int = 64, checkpoint=None, mesh=None, cfg=None,
           verbose: bool = False,
           device: str | torch.device = DEFAULT_DEVICE
           ) -> tuple[Any, FLHistory]:
    """Run T round-synchronous rounds of federated training on `device`.

    Availability comes from exactly one of `participation` (``.sample(t)
    -> (N,) bool``, one draw per round on the host) and `scenario` (a
    `repro_torch.scenarios` Scenario or process: dense algorithms draw the
    mask inside the round on the device, cohort algorithms take its host
    surface; the masks are the same). `batcher.sample_round(t)` gives numpy
    batches with leaves (N, K, mb, ...); `schedule(t)` the server learning
    rate (`eta_local` overrides the client-side rate);
    `uses_update_clock` drives the schedules off applied global updates
    (FedAvgSampling-style). `seed` keys model init (or pass `params`) and
    the round generators; `weight_decay` applies to the K local steps.
    `cohort_capacity` pins the cohort path's pad width (default: per-round
    power-of-two buckets); pad slots are inert, but the reduction grouping
    of local training depends on the padded length, so pin it when holding
    two drivers' trajectories together. `eval_fn(params) -> (loss, acc)`
    runs every `eval_every` rounds and at the last round; `verbose` prints
    a line at each eval, as the reference does.

    `engine`:
      * "loop" — one round at a time: its inputs to the device, the round
        body, the loss read back.
      * "scan" — `core.scan_engine.ScanDriver`: rounds in chunks of up to
        `scan_chunk` (cut after every eval round), each chunk's inputs
        staged to the device in one copy; on the card the round body is
        captured once as a CUDA graph and replayed, and the metrics are
        read one chunk late. Bit-equal to the loop. Configurations it
        cannot run (update-clock schedules, host banks) warn once and
        run on the loop; an unpinned cohort pads to the N-client bucket.
      * "scan_strict" — like "scan", but those configurations raise.

    `checkpoint` (a `repro_torch.checkpoint.CheckpointSpec`) snapshots the
    whole run (params, algorithm state with a bank's pages and host
    bookkeeping, the round generators, the scenario's state with a trace
    window, τ statistics, history) through `checkpoint.save_run` after
    every `checkpoint.every` completed rounds, atomically. With
    ``checkpoint.resume=True`` the latest snapshot in ``checkpoint.dir``
    is restored, host samplers are replayed to its round, and the run goes
    on from there, bit-equal to the uninterrupted run. Snapshots ride the
    scan engine's chunk cuts: "loop" raises, and a configuration the scan
    cannot run raises instead of falling back without durability.

    `sim` (a `repro_torch.sim.SimSpec`: server policy, latency model,
    temporal config) puts the run on a simulated clock: rounds open and
    close in simulated seconds under the policy, and the applied mask is
    the policy's arrival decision. Under "scan" the compiled simulator
    (`sim.compiled.SimScanDriver`) runs it when `sim_scan_supported` says
    yes; otherwise, and always under "loop", the discrete-event heap
    engine (`sim.engine.FedSimEngine`) does, with a warning naming the
    blocker under "scan" and a raise under "scan_strict".

    `mesh` (scan engines only; a `launch.mesh` mesh) places the scan
    engine's carry (`core.scan_engine`, "Meshes"): params by the model
    rules when `cfg` (an `ArchConfig`) is given (tensor parallelism over
    `model`, fsdp over `data`); MIFA's update array and bank rows with the
    client axis over the mesh's data axes and their param dims by the
    model rules. The returned params are this rank's blocks. A snapshot
    (`checkpoint=`) is the whole run's, and resumes on any mesh. A
    `DenseBank` constructed without its own mesh inherits `mesh` and
    `cfg`, so its rows pad to divide the data extent
    (`sharding.rules.padded_bank_rows`). At extent 1 the run is bit-equal
    to the run without a mesh, and so is a split of the param dims alone;
    at data extent > 1 (a world of CPU ranks) the client-axis sums are
    reduced per rank and all-reduced, so trajectories match the
    single-rank run to fp32 reduction-order tolerance, with the masks,
    n_active and τ statistics exact (int8 memory gathers its rows and is
    bit-equal). `cfg` without a mesh changes nothing.
    """
    if (participation is None) == (scenario is None):
        raise ValueError("pass exactly one of participation= or scenario=")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: expected 'loop', "
                         "'scan', or 'scan_strict'")
    if checkpoint is not None:
        if sim is not None:
            raise ValueError("checkpoint= is not supported for simulated "
                             "runs (the compiled simulator's carry holds "
                             "event-queue state with no snapshot schema)")
        if engine == "loop":
            raise ValueError("checkpoint= rides the scan engine's chunk "
                             "boundaries; pass engine='scan' (or "
                             "'scan_strict')")
    if mesh is not None:
        if engine == "loop":
            raise ValueError("mesh= places the scan carry; it has no effect "
                             "under engine='loop' — pass engine='scan'")
        if sim is not None:
            raise ValueError("mesh= is not supported for simulated runs "
                             "(the compiled simulator carry has no "
                             "sharding rules yet)")
        # banks build their rows inside RoundRunner.__init__ (algo.init_state
        # -> bank.init), so a mesh-less bank inherits the run's mesh here
        bank = getattr(algo, "bank", None)
        if (bank is not None and hasattr(bank, "mesh")
                and bank.mesh is None):
            bank.mesh = mesh
            bank.cfg = cfg if getattr(bank, "cfg", None) is None else bank.cfg
    runner = RoundRunner(model=model, algo=algo, batcher=batcher,
                         schedule=schedule, eta_local=eta_local,
                         weight_decay=weight_decay, seed=seed, params=params,
                         uses_update_clock=uses_update_clock,
                         cohort_capacity=cohort_capacity, scenario=scenario,
                         device=device)
    if sim is not None:
        return _run_sim(runner, sim, n_rounds, participation=participation,
                        engine=engine, scan_chunk=scan_chunk, seed=seed,
                        eval_fn=eval_fn, eval_every=eval_every,
                        verbose=verbose)
    def scan_driver():
        """The scan engine's driver, or None for the loop (after a warning
        naming the blocker, or a raise where falling back would drop a
        request)."""
        from repro_torch.core.scan_engine import ScanDriver, scan_supported
        ok, why = scan_supported(runner)
        if ok:
            return ScanDriver(runner, scan_chunk=scan_chunk, mesh=mesh,
                              cfg=cfg)
        if engine == "scan_strict":
            raise ValueError(f"engine='scan_strict': {why}")
        if checkpoint is not None:
            raise ValueError(
                f"checkpoint= needs the scan engine, but this "
                f"configuration cannot scan ({why}); refusing to fall "
                "back and silently drop durability")
        if mesh is not None:
            raise ValueError(f"engine='scan' with mesh= cannot fall back "
                             f"to the per-round loop (the loop ignores "
                             f"mesh); blocker: {why}")
        warn_engine_fallback(
            f"engine='scan' unsupported for this configuration "
            f"({why}); falling back to the per-round loop")
        return None

    # under a mesh the ScanDriver places the carry before a snapshot is
    # restored into it
    driver = scan_driver() if mesh is not None else None
    start_round = 0
    if checkpoint is not None and checkpoint.resume:
        from repro_torch.checkpoint.run_state import (fast_forward_sampler,
                                                      restore_run)
        start_round = (driver.restore(checkpoint) if driver is not None
                       else restore_run(runner, checkpoint))
        if start_round:
            # host availability streams are not in the snapshot: replay
            # them through the restored rounds
            fast_forward_sampler(participation, start_round)
            fast_forward_sampler(runner._scen_sampler, start_round)
        if start_round >= n_rounds:
            return runner.finalize()
    if engine != "loop" and driver is None:
        driver = scan_driver()
    if driver is not None:
        t0 = time.time()
        driver.run(n_rounds, participation=participation, eval_fn=eval_fn,
                   eval_every=eval_every, verbose=verbose,
                   checkpoint=checkpoint, start_round=start_round)
        runner.hist.wall_time = time.time() - t0
        return runner.finalize()
    t0 = time.time()
    for t in range(n_rounds):
        if scenario is not None:
            runner.step_scenario(t)
        else:
            runner.step(t, participation.sample(t))
        if eval_fn is not None and (t % eval_every == 0 or t == n_rounds - 1):
            el, ea = runner.evaluate(t, eval_fn)
            if verbose:
                print(f"  round {t:5d} train={runner.hist.train_loss[-1]:.4f} "
                      f"eval={el:.4f} acc={ea:.4f} "
                      f"active={int(runner.hist.n_active[-1])}")
    runner.hist.wall_time = time.time() - t0
    return runner.finalize()


def _run_sim(runner: RoundRunner, sim, n_rounds: int, *, participation,
             engine: str, scan_chunk: int, seed: int, eval_fn, eval_every,
             verbose: bool = False):
    """`run_fl(sim=)`: the compiled simulator where it can run, else the
    heap engine (the reference's dispatch)."""
    from repro_torch.sim.compiled import run_sim_scan, sim_scan_supported
    from repro_torch.sim.engine import FedSimEngine
    if engine != "loop":
        ok, why = sim_scan_supported(runner, sim)
        if ok:
            return run_sim_scan(runner, sim, n_rounds, scan_chunk=scan_chunk,
                                eval_fn=eval_fn, eval_every=eval_every,
                                verbose=verbose)
        if engine == "scan_strict":
            raise ValueError(f"engine='scan_strict': {why}")
        warn_engine_fallback(
            f"engine='scan' unsupported for this simulated configuration "
            f"({why}); falling back to the discrete-event heap engine",
            stacklevel=4)
    part = (participation if participation is not None
            else runner.scen_process.host_sampler())
    eng = FedSimEngine(runner, sim.policy, part, sim.latency, sim.config,
                       seed=seed)
    t0 = time.time()
    params, hist = eng.run(n_rounds, eval_fn=eval_fn, eval_every=eval_every)
    hist.wall_time = time.time() - t0
    return params, hist
