"""Concrete availability processes, counterpart of
`repro/scenarios/processes.py`.

  * Bernoulli         — i.i.d. per-device rates (Definition 5.2).
  * BernoulliDrift    — independent, rates drifting linearly, clipped.
  * GilbertElliott    — a two-state Markov chain per device: bursts of
                        unavailability of tunable length.
  * ClusterCorrelated — a shared outage chain per cluster gates groups of
                        devices (spatially correlated).
  * Diurnal           — day/night duty cycle with per-device phases.
  * StagedBlackout    — a piecewise-constant rate schedule.
  * Adversarial       — periodic deterministic blackouts, the masks of
                        `core.AdversarialParticipation`.

Each process writes its transition once, as torch ops over its state: the
device surface runs it on the run's device inside the round, the host
surface on CPU tensors. The uniforms are `jax.random`'s bits
(`_threefry`), so both surfaces are array-equal to the reference's.

Layout: every numeric parameter lives in the state (`init_state`), none in
the sample function's closure, so a fleet stacks the states of trials
with different parameters and samples them together: keys (K, 2), the
round t as a (K,) tensor, every state leaf with a leading (K,) axis.

Roundings that must match the reference's, where a threshold compare
would flip on one ulp:
  * BernoulliDrift computes ``p0 + drift * t`` as two ops (a product, then
    a sum), as the reference does; an FMA would round once.
  * Diurnal precomputes one period of rates in numpy f32 exactly as the
    reference does and indexes it by t mod period; nothing evaluates sin
    on the device.
  * StagedBlackout finds its stage with `torch.searchsorted(right=True)`.
  * ClusterCorrelated draws one (m + n,) vector and splits it.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.scenarios import _threefry
from repro_torch.scenarios.base import AvailabilityProcess, TauBound


def _per_device(x, n: int, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    out = np.broadcast_to(np.asarray(x, np.float32), (n,)).copy()
    if not np.all((out >= lo) & (out <= hi)):
        raise ValueError(f"values must lie in [{lo}, {hi}], got {x}")
    return out


def _geometric_expected_tau(rate: np.ndarray) -> float:
    """Stationary E[τ] averaged over devices for i.i.d. Bernoulli(rate):
    P(τ=k) = p(1−p)^k  =>  E[τ] = (1−p)/p."""
    p = np.asarray(rate, np.float64)
    return float(np.mean((1.0 - p) / np.maximum(p, 1e-12)))


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in arrays.items()}


def _round(t, key: torch.Tensor) -> torch.Tensor:
    """The round index as an int64 tensor on the key's device."""
    return torch.as_tensor(t, dtype=torch.int64, device=key.device)


def _col(x: torch.Tensor) -> torch.Tensor:
    """() -> (1,), (K,) -> (K, 1): broadcastable against (..., n)."""
    return x.reshape(tuple(x.shape) + (1,))


def _draw(key: torch.Tensor, t: torch.Tensor, n: int) -> torch.Tensor:
    """Round t's (..., n) f32 uniforms: uniform(fold_in(key, t), (n,))."""
    return _threefry.uniform(_threefry.round_key(key, t), n)


def _row(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row idx of a (..., R, n) table: idx () -> (n,), (K,) -> (K, n)."""
    shape = tuple(idx.shape)
    ix = idx.reshape(shape + (1, 1)).expand(shape + (1, table.shape[-1]))
    return torch.take_along_dim(table, ix, dim=-2).squeeze(-2)


class _ThresholdProcess(AvailabilityProcess):
    """Memoryless family: active iff u_t(i) < p_i(t).

    Subclasses implement `probs_at(t, state)`: the (..., n) f32 rates at
    round t (an int64 tensor, () or (K,)) from the state's parameters.
    """

    stateless = True

    def probs_at(self, t: torch.Tensor, state: dict) -> torch.Tensor:
        raise NotImplementedError

    def sample_fn(self) -> Callable:
        n = self.n
        probs_at = self.probs_at

        def sample(key, t, state):
            t = _round(t, key)
            mask = _draw(key, t, n) < probs_at(t, state)
            return mask | _col(t == 0), state

        return sample


class Bernoulli(_ThresholdProcess):
    """i.i.d. Bernoulli activity with per-device rates (Definition 5.2)."""

    def __init__(self, probs, n: int | None = None, seed: int = 0):
        self.n = n if n is not None else len(np.atleast_1d(probs))
        self.seed = seed
        self.probs = _per_device(probs, self.n)

    def init_state(self, device="cpu") -> dict:
        return _tensors({"probs": self.probs}, device)

    def probs_at(self, t, state):
        return state["probs"]

    def stationary_rate(self) -> np.ndarray:
        return self.probs.astype(np.float64)

    def tau_bound(self) -> TauBound:
        if np.all(self.probs >= 1.0):
            return TauBound(True, 0.0, 0.0, "always active")
        return TauBound(False, np.inf,
                        _geometric_expected_tau(self.probs),
                        "geometric off-times: bounded only in probability")


class BernoulliDrift(_ThresholdProcess):
    """Independent but non-stationary: p_i(t) = clip(p0_i + drift_i·t, lo,
    hi). `stationary_rate` reports the limiting rate the clip pins each
    device to."""

    def __init__(self, p0, drift, lo: float = 0.05, hi: float = 1.0,
                 n: int | None = None, seed: int = 0):
        self.n = n if n is not None else len(np.atleast_1d(p0))
        self.seed = seed
        self.p0 = _per_device(p0, self.n)
        self.drift = np.broadcast_to(
            np.asarray(drift, np.float32), (self.n,)).copy()
        self.lo = np.float32(lo)
        self.hi = np.float32(hi)

    def init_state(self, device="cpu") -> dict:
        # lo and hi as (1,), so a fleet's (K, 1) broadcast against (K, n)
        return _tensors({"p0": self.p0, "drift": self.drift,
                         "lo": np.reshape(self.lo, (1,)),
                         "hi": np.reshape(self.hi, (1,))}, device)

    def probs_at(self, t, state):
        drifted = state["drift"] * _col(t).float()
        p = state["p0"] + drifted
        return torch.minimum(torch.maximum(p, state["lo"]), state["hi"])

    def stationary_rate(self) -> np.ndarray:
        limit = np.where(self.drift > 0, self.hi,
                         np.where(self.drift < 0, self.lo, self.p0))
        return limit.astype(np.float64)

    def tau_bound(self) -> TauBound:
        return TauBound(False, np.inf,
                        _geometric_expected_tau(self.stationary_rate()),
                        "limiting-rate geometric tail (non-stationary "
                        "transient ignored)")


class Diurnal(_ThresholdProcess):
    """Day/night duty cycle: p_i(t) = clip(base_i + amp_i·sin(2πt/period +
    phase_i), 0, 1), with per-device phases (rolling time zones).

    `period` is rounded to whole rounds and one period of rates is computed
    at construction in numpy f32, as the reference computes it; both
    surfaces index that table by t mod period.
    """

    def __init__(self, base, amplitude, period: float, phase=0.0,
                 n: int | None = None, seed: int = 0):
        self.n = n if n is not None else len(np.atleast_1d(base))
        self.seed = seed
        self.base = _per_device(base, self.n)
        self.amplitude = _per_device(amplitude, self.n)
        self.period = max(int(round(float(period))), 1)
        self.phase = np.broadcast_to(
            np.asarray(phase, np.float32), (self.n,)).copy()
        ts = np.arange(self.period, dtype=np.float32)[:, None]
        ang = np.float32(2.0 * np.pi / self.period) * ts + self.phase[None]
        self.table = np.clip(self.base[None]
                             + self.amplitude[None] * np.sin(ang),
                             0.0, 1.0).astype(np.float32)   # (P, n)

    def init_state(self, device="cpu") -> dict:
        return _tensors({"table": self.table}, device)

    def probs_at(self, t, state):
        return _row(state["table"], t % state["table"].shape[-2])

    def stationary_rate(self) -> np.ndarray:
        """Exact time-average of p_i(t) over one period."""
        return self.table.mean(0).astype(np.float64)

    def tau_bound(self) -> TauBound:
        return TauBound(False, np.inf, np.nan,
                        "cyclo-stationary Bernoulli: no a.s. bound, no "
                        "closed-form E[τ]; estimate empirically")


class StagedBlackout(_ThresholdProcess):
    """Piecewise-constant rate schedule: stage s covers rounds
    [bounds[s-1], bounds[s]) with rates stage_probs[s] (S, n); the final
    stage persists. Rates in {0, 1} give deterministic staged blackouts."""

    def __init__(self, stage_probs, bounds, n: int | None = None,
                 seed: int = 0):
        probs = np.asarray(stage_probs, np.float32)
        if probs.ndim != 2:
            raise ValueError("stage_probs must be (n_stages, n)")
        self.n = n if n is not None else probs.shape[1]
        self.seed = seed
        self.stage_probs = np.stack(
            [_per_device(row, self.n) for row in probs])
        self.bounds = np.asarray(bounds, np.int64)
        if len(self.bounds) != len(self.stage_probs) - 1:
            raise ValueError("need one bound fewer than stages")
        if not (np.all(np.diff(self.bounds) > 0)
                and np.all(self.bounds > 0)):
            raise ValueError("bounds must be positive and increasing")

    def init_state(self, device="cpu") -> dict:
        return _tensors({"stage_probs": self.stage_probs,
                         "bounds": self.bounds}, device)

    def probs_at(self, t, state):
        idx = torch.searchsorted(state["bounds"], _col(t), right=True)
        return _row(state["stage_probs"], idx.reshape(t.shape))

    def stationary_rate(self) -> np.ndarray:
        """The persistent regime: the final stage's rates."""
        return self.stage_probs[-1].astype(np.float64)

    def tau_bound(self) -> TauBound:
        binary = np.all((self.stage_probs == 0) | (self.stage_probs == 1))
        if binary and np.all(self.stage_probs[-1] == 1):
            # deterministic: longest dark stretch over the finite schedule
            horizon = int(self.bounds[-1]) + 1
            state = self.init_state_host()
            masks = np.stack([
                (self.probs_at(torch.tensor(t), state) >= 1.0).numpy()
                for t in range(horizon)])
            masks[0] = True                      # round-0 convention
            t0 = _longest_dark_run(masks)
            return TauBound(True, float(t0), np.nan,
                            "deterministic schedule, final stage all-on")
        if np.any(self.stage_probs[-1] == 0):
            return TauBound(False, np.inf, np.inf,
                            "final stage darkens some device forever: "
                            "Assumption 4 fails, τ grows linearly")
        return TauBound(False, np.inf,
                        _geometric_expected_tau(self.stage_probs[-1]),
                        "stochastic stages: geometric tail in the final "
                        "regime")


def _longest_dark_run(masks: np.ndarray) -> int:
    """(T, n) bool -> the longest consecutive all-False run in any column."""
    dark = ~masks
    best = run = np.zeros(masks.shape[1], np.int64)
    for row in dark:
        run = np.where(row, run + 1, 0)
        best = np.maximum(best, run)
    return int(best.max(initial=0))


class GilbertElliott(AvailabilityProcess):
    """Per-device two-state Markov chain (Gilbert–Elliott): an active device
    fails with prob `p_fail` per round, an inactive one recovers with prob
    `p_recover`. Off-times are Geometric(p_recover), expected burst length
    1/p_recover.

    Stationary activity rate π_up = p_recover / (p_fail + p_recover);
    stationary E[τ] = p_fail / (p_recover·(p_fail + p_recover)).
    """

    stateless = False

    def __init__(self, p_fail, p_recover, n: int | None = None,
                 seed: int = 0):
        self.n = n if n is not None else len(np.atleast_1d(p_fail))
        self.seed = seed
        self.p_fail = _per_device(p_fail, self.n, lo=0.0, hi=1.0)
        self.p_recover = _per_device(p_recover, self.n, lo=1e-6, hi=1.0)

    @classmethod
    def from_rate_and_burst(cls, rate, burst, n: int, seed: int = 0):
        """Parametrise by stationary activity `rate` and expected off-burst
        length `burst` (rounds): p_recover = 1/burst, p_fail solved from
        rate = p_recover/(p_fail + p_recover). Raises when the pair is
        infeasible (p_fail > 1, i.e. burst < (1−rate)/rate)."""
        rate = _per_device(rate, n, lo=1e-6, hi=1.0)
        burst = np.broadcast_to(
            np.asarray(burst, np.float32), (n,)).astype(np.float64)
        if np.any(burst < 1.0):
            raise ValueError(f"burst must be >= 1 round, got {burst.min()}")
        p_rec = 1.0 / burst
        p_fail = p_rec * (1.0 - rate) / np.maximum(rate, 1e-6)
        if np.any(p_fail > 1.0):
            bad = float(p_fail.max())
            raise ValueError(
                f"(rate, burst) infeasible: implied p_fail={bad:.3f} > 1 — "
                "need burst >= (1-rate)/rate so the on-times stay long "
                "enough to average `rate` activity")
        return cls(p_fail, p_rec, n=n, seed=seed)

    def init_state(self, device="cpu") -> dict:
        return _tensors({"up": np.ones(self.n, bool), "p_fail": self.p_fail,
                         "p_recover": self.p_recover}, device)

    def sample_fn(self) -> Callable:
        n = self.n

        def sample(key, t, state):
            t = _round(t, key)
            u = _draw(key, t, n)
            trans = torch.where(state["up"], u >= state["p_fail"],
                                u < state["p_recover"])
            up = trans | _col(t == 0)
            return up, {**state, "up": up}

        return sample

    def stationary_rate(self) -> np.ndarray:
        pf = self.p_fail.astype(np.float64)
        pr = self.p_recover.astype(np.float64)
        return pr / np.maximum(pf + pr, 1e-12)

    def expected_tau(self) -> float:
        """Closed-form stationary E[τ] averaged over devices:
        E[τ] = π_up·p_f/p_r² = p_f / (p_r·(p_f + p_r))."""
        pf = self.p_fail.astype(np.float64)
        pr = self.p_recover.astype(np.float64)
        return float(np.mean(pf / np.maximum(pr * (pf + pr), 1e-12)))

    def tau_bound(self) -> TauBound:
        if np.all(self.p_fail == 0):
            return TauBound(True, 0.0, 0.0, "never fails")
        return TauBound(False, np.inf, self.expected_tau(),
                        "Geometric(p_recover) off-bursts: unbounded support")


class ClusterCorrelated(AvailabilityProcess):
    """Devices are partitioned into clusters, and a shared two-state outage
    chain gates each cluster: cluster c fails with `q_fail[c]` a round and
    recovers with `q_recover[c]`. A device is active iff its cluster is up
    and its own i.i.d. Bernoulli(p_device) draw succeeds."""

    stateless = False

    def __init__(self, n: int, n_clusters: int, q_fail, q_recover,
                 p_device=1.0, assignment=None, seed: int = 0):
        self.n = n
        self.seed = seed
        self.n_clusters = int(n_clusters)
        self.q_fail = _per_device(q_fail, self.n_clusters)
        self.q_recover = _per_device(q_recover, self.n_clusters, lo=1e-6)
        self.p_device = _per_device(p_device, n)
        self.assignment = (np.arange(n) % self.n_clusters
                           if assignment is None
                           else np.asarray(assignment, np.int64))
        if self.assignment.shape != (n,):
            raise ValueError(f"assignment must be ({n},), got "
                             f"{self.assignment.shape}")
        if self.assignment.max(initial=0) >= self.n_clusters:
            raise ValueError("assignment names a cluster past n_clusters")

    def init_state(self, device="cpu") -> dict:
        return _tensors({"cl_up": np.ones(self.n_clusters, bool),
                         "q_fail": self.q_fail, "q_recover": self.q_recover,
                         "p_device": self.p_device,
                         "assignment": self.assignment.astype(np.int64)},
                        device)

    def sample_fn(self) -> Callable:
        n, m = self.n, self.n_clusters

        def sample(key, t, state):
            t = _round(t, key)
            u = _draw(key, t, m + n)
            u_cl, u_dev = u[..., :m], u[..., m:]
            first = _col(t == 0)
            trans = torch.where(state["cl_up"], u_cl >= state["q_fail"],
                                u_cl < state["q_recover"])
            cl_up = trans | first
            mask = (torch.take_along_dim(cl_up, state["assignment"], dim=-1)
                    & (u_dev < state["p_device"]))
            return mask | first, {**state, "cl_up": cl_up}

        return sample

    def stationary_rate(self) -> np.ndarray:
        qf = self.q_fail.astype(np.float64)
        qr = self.q_recover.astype(np.float64)
        pi_up = qr / np.maximum(qf + qr, 1e-12)
        return pi_up[self.assignment] * self.p_device.astype(np.float64)

    def tau_bound(self) -> TauBound:
        return TauBound(False, np.inf, np.nan,
                        "cluster outage × device Bernoulli: alternating "
                        "renewal, no closed-form E[τ]")


class Adversarial(_ThresholdProcess):
    """Device i is dark for the first `offs[i]` slots of every
    `periods[i]`-round cycle (with per-device `phases`): the masks of
    `core.AdversarialParticipation`. Deterministic; Assumption 4 holds with
    t0 = max(offs)."""

    stateless = True

    def __init__(self, periods, offs, phases=None, n: int | None = None,
                 seed: int = 0):
        self.n = n if n is not None else len(np.atleast_1d(periods))
        self.seed = seed
        self.periods = np.broadcast_to(
            np.asarray(periods, np.int64), (self.n,)).copy()
        self.offs = np.broadcast_to(
            np.asarray(offs, np.int64), (self.n,)).copy()
        self.phases = (np.zeros(self.n, np.int64) if phases is None
                       else np.broadcast_to(
                           np.asarray(phases, np.int64), (self.n,)).copy())
        if not np.all(self.offs < self.periods):
            raise ValueError("every blackout must be shorter than its "
                             "period (offs < periods)")

    def init_state(self, device="cpu") -> dict:
        return _tensors({"periods": self.periods, "offs": self.offs,
                         "phases": self.phases}, device)

    def probs_at(self, t, state):
        # deterministic: the rate is the {0,1} indicator of the pattern
        ph = (_col(t) + state["phases"]) % state["periods"]
        return (ph >= state["offs"]).float()

    def stationary_rate(self) -> np.ndarray:
        return 1.0 - self.offs.astype(np.float64) / self.periods

    def tau_bound(self) -> TauBound:
        offs = self.offs.astype(np.float64)
        exp_tau = float(np.mean(offs * (offs + 1) / (2.0 * self.periods)))
        return TauBound(True, float(self.offs.max(initial=0)), exp_tau,
                        "periodic blackouts: τ <= max(offs) surely")
