"""Fleet executor — K independent FL trials run together on a trial axis.

Counterpart of `repro/fleet/executor.py`, loop engine only. The fleet
stacks K trials along a leading trial axis:

    params : (K, *shape)    state : per-algorithm leaves with a (K,) prefix
    masks  : (K, N) drawn on the host by the K trials' own processes

and each round runs as one fleet step:

  * dense algorithms — the round's batch is sampled once and shared by all
    trials; local training is `torch.func.vmap` over the trial axis of the
    runner's `client_updates` (which vmaps over clients). The server step
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
(or from the stacked `params=`) and keeps its own round generator, seeded
with s_k. τ statistics are not tracked (as in the reference).

Not ported yet: scenario trials and `step_scenario` (ROADMAP Queue 1 item
13), `engine="scan"` (item 12) and meshes (`mesh=`, item 19).
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
from repro_torch.core.runner import (ROUND_PHASES, FLHistory, _pow2_bucket,
                                     _to_device, cohort_width)
from repro_torch.fleet.spec import FleetSpec, Trial, _not_ported
from repro_torch.kernels.backend import (DEFAULT_DEVICE, resolve_device,
                                         set_numerics)
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
    wall_time: float = 0.0

    def record_round(self, t: int, metrics: dict) -> None:
        """Append round t's (K,) metric vectors (loss, n_active, optional
        global_updates)."""
        self.rounds.append(t)
        self.train_loss.append(_host(metrics["loss"]))
        self.n_active.append(_host(metrics["n_active"]))
        if "global_updates" in metrics:
            self.global_updates.append(_host(metrics["global_updates"]))

    def record_eval(self, t: int, eval_loss, eval_acc) -> None:
        """Append an eval point: (round, (K,) losses) and (round, (K,)
        accuracies)."""
        self.eval_loss.append((t, _host(eval_loss)))
        self.eval_acc.append((t, _host(eval_acc)))

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


class FleetRunner:
    """K-trial counterpart of `core.runner.RoundRunner`.

    The driver feeds `step(t, masks)` a (K, N) availability matrix, one row
    per trial, drawn by that trial's own participation process. `params`
    (optional) is a tree of stacked (K, ...) tensors; without it trial k is
    initialised from `torch.Generator().manual_seed(seeds[k])`, exactly as
    `RoundRunner(seed=seeds[k])`. Each trial keeps its own round generator,
    seeded with its seed. `device` defaults to "cuda" and raises without a
    GPU.
    """

    def __init__(self, *, model, algo, batcher, schedule: Callable,
                 seeds: Sequence[int],
                 eta_local: Callable | float | None = None,
                 weight_decay: float = 0.0, uses_update_clock: bool = False,
                 cohort_capacity: int | None = None,
                 labels: Sequence[str] | None = None, params=None,
                 mesh=None, scenarios: Sequence | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        if mesh is not None:
            raise _not_ported("mesh=", "19")
        if scenarios is not None:
            raise _not_ported("scenarios=", "13")
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
        self.n_trials = len(seeds)
        self.n_clients = batcher.n_clients
        if params is None:
            self.params = tree_stack([
                model.init(torch.Generator().manual_seed(int(s)),
                           device=self.device) for s in seeds])
        else:
            self.params = tree_map(lambda p: torch.as_tensor(p).to(
                self.device, copy=True), params)
            for p in tree_leaves(self.params):
                if p.shape[0] != self.n_trials:
                    raise ValueError(f"params= leaves must be stacked "
                                     f"(K={self.n_trials}, ...), got "
                                     f"{tuple(p.shape)}")
        # each trial's state as RoundRunner builds it, stacked leaf by leaf
        # (a paged bank resets its host mirror at each init, so the fleet
        # ends with one fresh mirror and K equal device tables)
        self.state = tree_stack([
            algo.init_state(tree_index(self.params, k), self.n_clients)
            for k in range(self.n_trials)])
        self.rngs = [torch.Generator().manual_seed(int(s)) for s in seeds]
        self.hist = FleetHistory(self.n_trials, labels=list(
            labels or [f"seed{s}" for s in seeds]))
        self.cohort_mode = getattr(algo, "cohort_based", False)

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

    def _local(self, batch: dict, eta_loc: np.ndarray, batch_dim):
        """Local training of every trial, vmapped over the trial axis:
        `batch_dim` None shares one batch, 0 gives each trial its own."""
        def one(params, b, eta):
            return client_updates(self.model.loss_fn, params, b, eta,
                                  K=self.batcher.k_steps,
                                  weight_decay=self.weight_decay)
        eta = torch.from_numpy(eta_loc).to(self.device)
        return vmap(one, in_dims=(0, batch_dim, 0))(self.params, batch, eta)

    def step(self, t: int, masks: np.ndarray) -> dict:
        """Apply round t to all trials; masks (K, N) bool applied-updates.
        Returns the round's metrics with (K,) leaves."""
        masks = np.asarray(masks, bool)
        if masks.shape != (self.n_trials, self.n_clients):
            raise ValueError(f"masks must be (K={self.n_trials}, "
                             f"N={self.n_clients}), got {masks.shape}")
        if self.cohort_mode:
            return self.step_cohort(t, [np.flatnonzero(m) for m in masks])
        eta_loc, eta_srv = self.learning_rates(t)
        batch_ph, local_ph, server_ph = ROUND_PHASES
        with record_function(batch_ph):
            batch = _to_device(self.batcher.sample_round(t), self.device)
            active = torch.from_numpy(masks).to(self.device)
        with record_function(local_ph):
            updates, losses = self._local(batch, eta_loc, None)
        with record_function(server_ph):
            per_trial = []
            for k in range(self.n_trials):
                state, params, metrics = self.algo.round_step(
                    tree_index(self.state, k), tree_index(self.params, k),
                    tree_index(updates, k), losses[k], active[k],
                    float(eta_srv[k]), rng=self.rngs[k])
                _write_trial(self.state, k, state)
                _write_trial(self.params, k, params)
                per_trial.append(metrics)
            metrics = {key: torch.stack([m[key] for m in per_trial])
                       for key in per_trial[0]}
            self.hist.record_round(t, metrics)
        return metrics

    def step_scenario(self, t: int) -> dict:
        raise _not_ported("FleetRunner.step_scenario", "13")

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
        eta_loc, eta_srv = self.learning_rates(t)
        batch_ph, local_ph, server_ph = ROUND_PHASES
        with record_function(batch_ph):
            # pad slots take client 0's batch, as RoundRunner.step_cohort;
            # each distinct client is sampled once for the whole fleet (the
            # union padded to a power of two with its first id) and every
            # trial gathers its (cap, ...) slice on the device
            wanted = np.where(valid, padded, 0)
            uniq, inv = np.unique(wanted, return_inverse=True)
            uniq = np.concatenate(
                [uniq, np.full(_pow2_bucket(len(uniq)) - len(uniq), uniq[0])])
            ubatch = _to_device(self.batcher.sample_round(
                t, client_ids=uniq), self.device)
            idx = torch.from_numpy(inv.reshape(n_trials, cap)).to(
                self.device)
            batch = {key: v[idx] for key, v in ubatch.items()}
            self.state = self.algo.prepare_cohort(self.state, padded[valid])
        with record_function(local_ph):
            updates, losses = self._local(batch, eta_loc, 0)
        with record_function(server_ph):
            self.state, mean_g, metrics = self.algo.round_step_cohort_fleet(
                self.state, padded, valid, updates, losses)
            eta = torch.from_numpy(eta_srv).to(self.device)
            self.params = tree_map(
                lambda w, g: (w - eta.reshape((-1,) + (1,) * (w.ndim - 1))
                              * g).to(w.dtype), self.params, mean_g)
            self.hist.record_round(t, metrics)
        return metrics

    def evaluate(self, t: int, eval_fn: Callable) -> tuple[Any, Any]:
        """eval_fn consumes stacked params -> ((K,) losses, (K,) accs)."""
        el, ea = eval_fn(self.params)
        self.hist.record_eval(t, el, ea)
        return el, ea

    def finalize(self) -> tuple[Any, FleetHistory]:
        """Returns (stacked (K, ...) params, fleet history)."""
        return self.params, self.hist


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
              engine: str = "loop", device: str | torch.device = DEFAULT_DEVICE
              ) -> tuple[Any, FleetHistory]:
    """Run T rounds of K independent trials as one fleet on `device`.

    The K-trial counterpart of `core.runner.run_fl`: pass a `FleetSpec`
    (algo + trials + clock flag + capacity), or `algo` + `trials`. Each
    trial's participation process draws its (N,) mask on the host exactly
    as `run_fl` would. `params` (optional) are stacked (K, ...) initial
    params, the fleet's counterpart of `run_fl(params=)`. `eval_fn`
    consumes stacked params and returns ((K,) losses, (K,) accs) (see
    `make_fleet_eval`); it runs every `eval_every` rounds and at the last.
    `uses_update_clock` drives the schedules off each trial's applied
    global updates; `cohort_capacity` pins the cohort pad width.
    Returns (stacked params with a leading (K,) axis, `FleetHistory`).
    """
    if spec is not None:
        algo = spec.algo
        trials = spec.trials
        uses_update_clock = spec.uses_update_clock
        cohort_capacity = spec.cohort_capacity or cohort_capacity
    if algo is None or not trials:
        raise ValueError("pass a FleetSpec, or algo= and trials=")
    if engine in ("scan", "scan_strict"):
        raise _not_ported(f"engine={engine!r}", "12")
    if engine != "loop":
        raise ValueError(f"unknown engine {engine!r}: expected 'loop', "
                         "'scan', or 'scan_strict'")
    runner = FleetRunner(
        model=model, algo=algo, batcher=batcher, schedule=schedule,
        seeds=[tr.seed for tr in trials], eta_local=eta_local,
        weight_decay=weight_decay, uses_update_clock=uses_update_clock,
        cohort_capacity=cohort_capacity,
        labels=[tr.label or f"seed{tr.seed}" for tr in trials],
        params=params, mesh=mesh, device=device)
    parts = [tr.participation for tr in trials]
    t0 = time.time()
    for t in range(n_rounds):
        runner.step(t, np.stack([np.asarray(p.sample(t), bool)
                                 for p in parts]))
        if eval_fn is not None and (t % eval_every == 0 or t == n_rounds - 1):
            runner.evaluate(t, eval_fn)
    runner.hist.wall_time = time.time() - t0
    return runner.finalize()
