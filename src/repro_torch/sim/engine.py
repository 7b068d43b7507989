"""FedSimEngine — discrete-event driver for federated rounds.

Counterpart of `repro/sim/engine.py`, the heap engine: host code, copied
from the reference, driving the port's `RoundRunner` (so each round's
update runs on the runner's device). The RTTs are the latency model's
device surface materialised on the runner's device
(`LatencyModel.sample(t, device=)`), so the heap and the compiled engine
see the same bits on the card as on the CPU.

Simulated time advances on a heap of arrival events; nothing sleeps. The
availability processes from `core.participation` are reinterpreted on a
*temporal* axis: one draw per fixed-length availability epoch (`epoch_s`
simulated seconds), cached so each epoch is drawn exactly once, in order
(the processes hold stateful RNGs). A device dispatched while unavailable
responds only after its next active epoch — this is where wait-for-straggler
policies bleed wall-clock.

Per server round t:
  1. policy.select(t) picks the cohort; latency.sample(t) draws device RTTs.
  2. Each cohort device's arrival time = (dispatch now, or the start of its
     next active epoch) + its RTT; arrivals are pushed on the event heap.
  3. policy.resolve(...) returns (close_time, applied_mask); the heap is
     drained up to close_time. Arrivals after it are logged as LATE 6-tuples
     ``(arrival_time, seq, LATE, client, round, close_time)`` — the true
     arrival time is preserved so lateness is measurable. Stateful policies
     (``policy.stateful``, e.g. `BufferedKofN`) instead keep late arrivals
     *in flight* on the heap and merge them into later rounds, with
     staleness weights passed to weight-aware algorithms.
  4. RoundRunner.step(t, applied_mask, sim_time=close_time) applies the
     global update through the runner's unchanged round body.

Simulated time is float32 end to end with the same op ordering as the
compiled engine (`repro_torch.sim.compiled`), so the two drivers produce
bit-equal close times and applied masks — the heap stays the reference
semantics; the compiled engine is the fast path.

The same algorithm/round API therefore runs under any temporal policy, and
FLHistory/TauStats carry a simulated-seconds axis for time-to-accuracy plots.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.core.runner import RoundRunner
from repro_torch.sim.events import ARRIVAL, LATE, ROUND_CLOSE, EventQueue


@dataclass(frozen=True)
class SimConfig:
    epoch_s: float = 4.0             # availability re-poll granularity
    server_overhead_s: float = 0.05  # aggregation + broadcast per round
    max_lookahead_epochs: int = 10_000  # device never back => arrival = inf


class FedSimEngine:
    """Discrete-event driver: simulated-seconds rounds over a RoundRunner.

    `policy` decides who is dispatched and when rounds close;
    `participation` (any ``.sample(t)`` process, incl. scenario host
    samplers) is replayed on the temporal axis; `latency` draws per-device
    RTTs on the runner's device. See the module docstring for the
    per-round event flow.
    """

    def __init__(self, runner: RoundRunner, policy, participation, latency,
                 config: SimConfig = SimConfig(), seed: int = 0):
        if latency.n != runner.n_clients:
            raise ValueError(f"the latency model has {latency.n} devices, "
                             f"the runner {runner.n_clients} clients")
        self.runner = runner
        self.policy = policy
        self.participation = participation
        self.latency = latency
        self.config = config
        self.rng = np.random.default_rng(seed)
        self.queue = EventQueue()
        # simulated time is float32 end to end, with the same op order as
        # the compiled engine (repro_torch.sim.compiled) — close times and
        # applied masks are therefore bit-equal across the two drivers
        self.now = np.float32(0.0)
        self.event_log: list[tuple] = []
        self.round_log: list[dict] = []
        self.applied_log: list[np.ndarray] = []
        self.pstate = (policy.init_pstate(runner.n_clients)
                       if getattr(policy, "stateful", False) else None)
        self.n_never_total = 0
        self._warned_never = False
        # seed the cache with the epoch-0 draw: validates the process width
        # without consuming a second sample(0) from stateful processes
        mask0 = np.asarray(participation.sample(0), bool)
        if mask0.shape != (runner.n_clients,):
            raise ValueError(f"availability masks of shape {mask0.shape} "
                             f"for {runner.n_clients} clients")
        self._avail_cache: list[np.ndarray] = [mask0]
        # epoch lookahead memo (valid because drawn epochs are immutable and
        # queries move forward in time): next known active epoch per device,
        # and the exclusive end of the last failed scan
        self._next_active: dict[int, int] = {}
        self._dark_until = np.zeros(runner.n_clients, np.int64)

    # ------------------------------------------------------------------ #
    def avail(self, epoch: int) -> np.ndarray:
        """Availability mask for an epoch; drawn once, in epoch order."""
        while len(self._avail_cache) <= epoch:
            k = len(self._avail_cache)
            self._avail_cache.append(
                np.asarray(self.participation.sample(k), bool))
        return self._avail_cache[epoch]

    def _next_active_epoch(self, i: int, k0: int) -> int | None:
        cached = self._next_active.get(i)
        if cached is not None and cached > k0:
            return cached
        end = k0 + 1 + self.config.max_lookahead_epochs
        for k in range(max(k0 + 1, int(self._dark_until[i])), end):
            if self.avail(k)[i]:
                self._next_active[i] = k
                return k
        self._dark_until[i] = end   # device i known inactive before `end`
        return None

    # ------------------------------------------------------------------ #
    def run_round(self, t: int) -> dict:
        """Simulate one server round: dispatch, drain arrivals, apply the
        policy's mask through RoundRunner, advance the clock. Returns the
        round record (open/close times, dispatch/applied/late counts, plus
        n_never — dispatched devices past the lookahead horizon)."""
        cfg = self.config
        n = self.runner.n_clients
        now = np.float32(self.now)
        epoch_s = np.float32(cfg.epoch_s)
        stateful = getattr(self.policy, "stateful", False)
        if stateful:
            cohort = np.asarray(
                self.policy.select_pending(t, n, self.pstate), bool)
        else:
            cohort = np.asarray(self.policy.select(t, n, self.rng), bool)
        rtt = np.asarray(self.latency.sample(t, device=self.runner.device),
                         np.float32)
        k0 = int(now // epoch_s)
        avail_now = self.avail(k0)

        n_never = 0
        arrivals = np.full(n, np.inf, np.float32)
        for i in np.flatnonzero(cohort):
            if avail_now[i]:
                start = now
            else:
                k = self._next_active_epoch(i, k0)
                if k is None:
                    n_never += 1
                    continue                      # never returns: stays inf
                start = np.float32(np.float32(k) * epoch_s)
            arrivals[i] = np.float32(start + rtt[i])
            self.queue.push(arrivals[i], ARRIVAL, client=i, round=t)
        if n_never:
            self.n_never_total += n_never
            if not self._warned_never:
                self._warned_never = True
                warnings.warn(
                    f"{n_never} dispatched device(s) in round {t} never "
                    "become available again within "
                    f"SimConfig.max_lookahead_epochs={cfg.max_lookahead_epochs}"
                    " epochs; their arrivals stay inf and they are dropped "
                    "(raise the knob to look further ahead)", stacklevel=2)

        weights = None
        if stateful:
            close, applied, weights, self.pstate = \
                self.policy.resolve_pending(self.pstate, cohort, avail_now,
                                            arrivals, now, epoch_s, t)
        else:
            close, applied = self.policy.resolve(cohort, avail_now, arrivals,
                                                 now, epoch_s)
        n_late = 0
        if stateful:
            # buffered policies: arrivals after close stay IN FLIGHT on the
            # heap (they merge into a later round's buffer) — drain <= close
            while len(self.queue) and self.queue.peek().time <= close:
                ev = self.queue.pop()
                if applied[ev.client]:
                    self.event_log.append(ev.as_tuple())
                else:
                    n_late += 1
                    self.event_log.append((ev.time, ev.seq, LATE, ev.client,
                                           t, close))
        else:
            while len(self.queue):
                ev = self.queue.pop()
                if ev.time <= close and applied[ev.client]:
                    self.event_log.append(ev.as_tuple())
                else:  # late responder (deadline) or unwaited-for (impatient)
                    n_late += 1
                    self.event_log.append((ev.time, ev.seq, LATE, ev.client,
                                           t, close))
        self.event_log.append((close, -1, ROUND_CLOSE, -1, t))

        active = applied
        if weights is not None and getattr(self.runner.algo, "weight_aware",
                                           False):
            active = weights
        metrics = self.runner.step(t, active, sim_time=close)
        self.applied_log.append(applied.copy())
        self.now = np.float32(close) + np.float32(cfg.server_overhead_s)
        rec = {"round": t, "t_open": float(now), "t_close": float(close),
               "duration_s": float(close - now),
               "n_dispatched": int(cohort.sum()),
               "n_applied": int(applied.sum()), "n_late": n_late,
               "n_never": n_never,
               "train_loss": float(metrics["loss"])}
        self.round_log.append(rec)
        return rec

    def run(self, n_rounds: int, *, eval_fn: Callable | None = None,
            eval_every: int = 10, max_sim_seconds: float | None = None):
        """Simulate up to n_rounds (or until the simulated clock runs out).

        `max_sim_seconds` is checked at round close — rounds are not
        pre-empted, so the final round may overshoot the budget (by however
        long that round's policy blocked). Returns (params, FLHistory) with
        sim_seconds/eval_seconds populated."""
        for t in range(n_rounds):
            self.run_round(t)
            last = (t == n_rounds - 1 or
                    (max_sim_seconds is not None
                     and self.now >= max_sim_seconds))
            if eval_fn is not None and (t % eval_every == 0 or last):
                self.runner.evaluate(t, eval_fn, sim_time=self.now)
            if last:
                break
        return self.runner.finalize()
