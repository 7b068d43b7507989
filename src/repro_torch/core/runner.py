"""Host-side FL training loop: participation process + data + algorithm.

Counterpart of `repro/core/runner.py`, loop engine only. Each round the
availability mask and minibatches stream in from the host (they are the
environment, not the model); local K-step SGD and the server step run on the
run's device, which every entry point takes as `device=` (default "cuda",
raising when no GPU is present).

Two round paths, selected by the algorithm:
  * dense (default)              — `client_updates` over ALL N clients, then
    `algo.round_step` on the (N, ...) update array;
  * cohort (`algo.cohort_based`) — only the active cohort's batches are
    sampled and updated: compact (C, ...) leaves where C is |A(t)| padded to
    a power-of-two bucket, applied through the algorithm's memory bank. Pad slots carry valid=False and point at the
    bank's dummy row N.

Each run keeps a round generator, a CPU `torch.Generator` seeded with the
run's seed, and passes it to `algo.round_step(..., rng=)`: the sampling
baselines draw their device selection from it. With `uses_update_clock`
the schedules count applied global updates (`state["t_updates"]`, read on
the host before each round) instead of rounds.

Not ported yet: scenarios (`scenario=`, ROADMAP Queue 1 item 13), the
runtime simulator (`sim=`, item 16), checkpoints (`checkpoint=`, item 17),
meshes (`mesh=`, item 19) and the scan engine (`engine="scan"`, item 12).
"""
from __future__ import annotations

import time
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
    report it (the sampling baselines). The reference's `sim_seconds` and
    `eval_seconds` come with the simulator (ROADMAP Queue 1 item 16)."""

    rounds: list = field(default_factory=list)
    train_loss: list = field(default_factory=list)
    eval_loss: list = field(default_factory=list)
    eval_acc: list = field(default_factory=list)
    n_active: list = field(default_factory=list)
    global_updates: list = field(default_factory=list)
    wall_time: float = 0.0
    tau_bar: float = 0.0
    tau_max: int = 0

    def as_dict(self) -> dict:
        """Plain-dict view of every history field (JSON-serialisable)."""
        return {k: getattr(self, k) for k in
                ("rounds", "train_loss", "eval_loss", "eval_acc", "n_active",
                 "global_updates", "wall_time", "tau_bar", "tau_max")}

    def record_round(self, t: int, metrics: dict) -> None:
        """Append round t's metrics dict (loss, n_active, optional
        global_updates)."""
        self.rounds.append(t)
        self.train_loss.append(float(metrics["loss"]))
        self.n_active.append(float(metrics["n_active"]))
        if "global_updates" in metrics:
            self.global_updates.append(float(metrics["global_updates"]))

    def record_eval(self, t: int, eval_loss: float, eval_acc: float) -> None:
        """Append an (round, value) eval point."""
        self.eval_loss.append((t, float(eval_loss)))
        self.eval_acc.append((t, float(eval_acc)))


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


def apply_mean(params, mean_g, eta_srv: float):
    """Server step w <- w - η·mean_G."""
    return tree_map(lambda w, g: (w - eta_srv * g).to(w.dtype), params,
                    mean_g)


# Profiler ranges that split `RoundRunner.step` into its phases: the round's
# batches on the device, local training, and the server step (which ends in
# the sync that reads the round's loss). `scripts/profile_round.py` reads
# them; with no profiler active a range costs one small host call.
ROUND_PHASES = ("round.batch", "round.local", "round.server")


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class RoundRunner:
    """One federated round + bookkeeping.

    `params` (optional) is a tree of tensors, moved to `device`; without it
    the model is initialised from a torch.Generator seeded with `seed`.
    The round generator `rng` is a second CPU generator seeded with `seed`,
    the same whether or not `params` is given (the reference splits its
    round key from PRNGKey(seed) either way). `cohort_capacity` pins the
    cohort path's pad width.
    """

    def __init__(self, *, model, algo, batcher, schedule: Callable,
                 eta_local: Callable | float | None = None,
                 weight_decay: float = 0.0, seed: int = 0, params=None,
                 uses_update_clock: bool = False,
                 cohort_capacity: int | None = None,
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

    def _updates(self, batch: dict, eta_loc: float):
        return client_updates(self.model.loss_fn, self.params, batch, eta_loc,
                              K=self.batcher.k_steps,
                              weight_decay=self.weight_decay)

    def step(self, t: int, active: np.ndarray) -> dict:
        """Apply one round with `active` (N,) bool as the applied-update
        mask. Returns the round's metrics dict."""
        active = np.asarray(active, bool)
        self.stats.update(active)
        if self.cohort_mode:
            return self.step_cohort(t, np.flatnonzero(active))
        eta_loc, eta_srv = self.learning_rates(t)
        batch_ph, local_ph, server_ph = ROUND_PHASES
        with record_function(batch_ph):
            batch = _to_device(self.batcher.sample_round(t), self.device)
        with record_function(local_ph):
            updates, losses = self._updates(batch, eta_loc)
        with record_function(server_ph):
            self.state, self.params, metrics = self.algo.round_step(
                self.state, self.params, updates, losses,
                torch.from_numpy(active).to(self.device), eta_srv,
                rng=self.rng)
            self.hist.record_round(t, metrics)
        return metrics

    def step_cohort(self, t: int, ids: np.ndarray) -> dict:
        """Apply one O(|A|·d) cohort round; `ids` are the active client rows.

        Called directly, τ statistics are skipped (TauStats is O(N)); `step`
        keeps them.
        """
        if not self.cohort_mode:
            raise ValueError("step_cohort needs a cohort_based algorithm")
        eta_loc, eta_srv = self.learning_rates(t)
        batch_ph, local_ph, server_ph = ROUND_PHASES
        with record_function(batch_ph):
            ids = np.asarray(ids, np.int64)
            check_unique_ids(ids)    # duplicates would corrupt G_sum
            padded, valid = pad_cohort(ids, self.n_clients,
                                       self.cohort_capacity)
            # pad slots still need some real client's batch; row 0's content
            # is computed then discarded by the valid mask
            batch = _to_device(self.batcher.sample_round(
                t, client_ids=np.where(valid, padded, 0)), self.device)
            self.state = self.algo.prepare_cohort(self.state, padded[valid])
        with record_function(local_ph):
            updates, losses = self._updates(batch, eta_loc)
        with record_function(server_ph):
            self.state, mean_g, metrics = self.algo.round_step_cohort(
                self.state, padded, valid, updates, losses)
            self.params = apply_mean(self.params, mean_g, eta_srv)
            self.hist.record_round(t, metrics)
        return metrics

    def evaluate(self, t: int, eval_fn: Callable) -> tuple[float, float]:
        """Run `eval_fn(params) -> (loss, acc)` and record it at round t."""
        el, ea = eval_fn(self.params)
        self.hist.record_eval(t, el, ea)
        return float(el), float(ea)

    def finalize(self) -> tuple[Any, FLHistory]:
        """Seal τ statistics into the history; returns (params, history)."""
        self.hist.tau_bar = self.stats.tau_bar
        self.hist.tau_max = self.stats.tau_max
        return self.params, self.hist


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item}); the port runs "
                               "participation= with engine='loop'")


def run_fl(*, model, algo, batcher, schedule: Callable, n_rounds: int,
           participation=None, scenario=None, sim=None,
           eta_local: Callable | float | None = None,
           weight_decay: float = 0.0, seed: int = 0,
           eval_fn: Callable | None = None, eval_every: int = 10,
           params=None, uses_update_clock: bool = False,
           cohort_capacity: int | None = None, engine: str = "loop",
           checkpoint=None, mesh=None,
           device: str | torch.device = DEFAULT_DEVICE
           ) -> tuple[Any, FLHistory]:
    """Run T round-synchronous rounds of federated training on `device`.

    Availability comes from `participation` (``.sample(t) -> (N,) bool``),
    one draw per round on the host. `batcher.sample_round(t)` gives numpy
    batches with leaves (N, K, mb, ...); `schedule(t)` the server learning
    rate (`eta_local` overrides the client-side rate);
    `uses_update_clock` drives the schedules off applied global updates
    (FedAvgSampling-style). `seed` keys model init (or pass `params`) and
    the round generator; `weight_decay` applies to the K local steps.
    `cohort_capacity` pins the cohort path's pad width (default: per-round
    power-of-two buckets); pad slots are inert, but the reduction grouping
    of local training depends on the padded length, so pin it when holding
    two drivers' trajectories together. `eval_fn(params) -> (loss, acc)`
    runs every `eval_every` rounds and at the last round.
    """
    if scenario is not None:
        raise _not_ported("scenario=", "13")
    if sim is not None:
        raise _not_ported("sim=", "16")
    if checkpoint is not None:
        raise _not_ported("checkpoint=", "17")
    if mesh is not None:
        raise _not_ported("mesh=", "19")
    if engine != "loop":
        raise _not_ported(f"engine={engine!r}", "12")
    if participation is None:
        raise ValueError("pass participation=")
    runner = RoundRunner(model=model, algo=algo, batcher=batcher,
                         schedule=schedule, eta_local=eta_local,
                         weight_decay=weight_decay, seed=seed, params=params,
                         uses_update_clock=uses_update_clock,
                         cohort_capacity=cohort_capacity, device=device)
    t0 = time.time()
    for t in range(n_rounds):
        active = participation.sample(t)
        runner.step(t, active)
        if eval_fn is not None and (t % eval_every == 0 or t == n_rounds - 1):
            runner.evaluate(t, eval_fn)
    runner.hist.wall_time = time.time() - t0
    return runner.finalize()
