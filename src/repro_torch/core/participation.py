"""Device-availability processes A(t) and the paper's τ statistics.

numpy only, array-equal to `repro/core/participation.py`:
`label_correlated_probs`, `BernoulliParticipation`,
`AdversarialParticipation`, `TraceParticipation`, `TauStats` (with its
simulated-seconds timeline) and `tau_matrix`.

All processes return the all-active mask at round 0 (paper Remark 5.2 /
Definition 5.2(1): every device responds in the first round).
τ statistics (Definition 5.1): τ(t,i) = t - max{t' <= t : i in A(t')}.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def label_correlated_probs(client_labels: np.ndarray, p_min: float,
                           n_label_values: int = 10) -> np.ndarray:
    """Paper §7: label-correlated participation probabilities,

        p_i = p_min + (1 − p_min) · min(j,k) / 9

    so min(j,k)=0 ⇒ p_i = p_min (rare stragglers holding the small labels) and
    min(j,k)=9 ⇒ p_i = 1 (the reading of the paper's formula consistent with
    its text; see the reference docstring). client_labels: (N,2) int classes.
    """
    m = np.minimum(client_labels[:, 0], client_labels[:, 1]).astype(np.float64)
    return p_min + (1.0 - p_min) * m / (n_label_values - 1)


class BernoulliParticipation:
    """i.i.d. Bernoulli participation (Definition 5.2)."""

    def __init__(self, probs: np.ndarray, seed: int = 0):
        self.probs = np.asarray(probs, np.float64)
        self.n = len(self.probs)
        self.rng = np.random.default_rng(seed)

    def sample(self, t: int) -> np.ndarray:
        """(N,) bool mask for round t (round 0 is forced all-active)."""
        if t == 0:
            return np.ones(self.n, bool)
        return self.rng.random(self.n) < self.probs


class AdversarialParticipation:
    """Deterministic periodic blackouts: device i is inactive for `off_i`
    consecutive rounds out of every `period_i`, with phase `phase_i`.

    With off_i <= t0 this satisfies Assumption 4 for any b. Non-stationary
    and not independent: the regime the paper claims (and the baselines
    lack).
    """

    def __init__(self, n: int, periods: np.ndarray, offs: np.ndarray,
                 phases: np.ndarray | None = None):
        self.n = n
        self.periods = np.asarray(periods, np.int64)
        self.offs = np.asarray(offs, np.int64)
        self.phases = (np.zeros(n, np.int64) if phases is None
                       else np.asarray(phases, np.int64))
        if not np.all(self.offs < self.periods):
            raise ValueError("every blackout must be shorter than its "
                             "period (offs < periods)")

    def sample(self, t: int) -> np.ndarray:
        """(N,) bool mask for round t (round 0 is forced all-active)."""
        if t == 0:
            return np.ones(self.n, bool)
        ph = (t + self.phases) % self.periods
        return ph >= self.offs   # the first `off` slots of a period are dark


class TraceParticipation:
    """Replay a recorded (T, N) availability matrix; rounds past the end
    repeat the last row. Row 0 is forced all-active, on a copy: the
    caller's array is never written."""

    def __init__(self, trace: np.ndarray):
        self.trace = np.array(trace, bool, copy=True)
        self.trace[0, :] = True
        self.n = self.trace.shape[1]

    def sample(self, t: int) -> np.ndarray:
        """(N,) bool mask for round t (clamped to the trace length)."""
        return self.trace[min(t, len(self.trace) - 1)]


def _check_first_round(active: np.ndarray, strict: bool, what: str) -> None:
    """τ is undefined for a device never active; the paper assumes every
    device responds at round 0. Raise unless `strict=False`, which treats
    devices as active at a virtual round −1 (the memory's zero init)."""
    if strict and not np.all(active):
        missing = np.flatnonzero(~np.asarray(active, bool))[:8].tolist()
        raise ValueError(
            f"{what}: round 0 must be all-active (Definition 5.2(1)); "
            f"devices {missing}... are inactive. Pass strict=False to use "
            "the init convention (τ counts from a virtual round −1).")


@dataclass
class TauStats:
    """Streaming tracker of the paper's inactivity statistics; with
    `keep_history` or simulated-seconds stamps it also keeps the per-round
    τ vectors (`timeline`)."""

    n: int
    strict: bool = True

    def __post_init__(self):
        self.tau = np.zeros(self.n, np.int64)         # current τ(t, i)
        self.tau_max_per_dev = np.zeros(self.n, np.int64)
        self.sum_tau = 0.0                            # Σ_t Σ_i τ(t,i)
        self.sum_tau_sq = 0.0                         # Σ_t Σ_i τ(t,i)^2
        self.rounds = 0
        self.history: list[np.ndarray] = []
        self.times: list[float] = []      # simulated seconds, if stamped

    def update(self, active: np.ndarray, keep_history: bool = False,
               sim_time: float | None = None):
        """Call once per round with the round's availability mask (after
        the mask is applied: τ=0 for active devices). `sim_time` stamps the
        round with simulated seconds (simulated runs)."""
        if self.rounds == 0:
            _check_first_round(np.asarray(active, bool), self.strict,
                               "TauStats.update")
        self.tau = np.where(active, 0, self.tau + 1)
        self.tau_max_per_dev = np.maximum(self.tau_max_per_dev, self.tau)
        self.sum_tau += float(self.tau.sum())
        self.sum_tau_sq += float((self.tau.astype(np.float64) ** 2).sum())
        self.rounds += 1
        if keep_history or sim_time is not None:
            # times stays aligned with history: NaN for unstamped rounds
            self.times.append(np.nan if sim_time is None else float(sim_time))
            self.history.append(self.tau.copy())

    def timeline(self) -> tuple[np.ndarray, np.ndarray]:
        """(times (R,), τ history (R, N)), row-aligned, from the `update`
        calls with `sim_time` or `keep_history`; unstamped rounds carry
        NaN in `times`."""
        return (np.asarray(self.times, np.float64),
                np.stack(self.history) if self.history
                else np.zeros((0, self.n), np.int64))

    def absorb_scan(self, tau: np.ndarray, tau_max_per_dev: np.ndarray,
                    tau_sums: np.ndarray, tau_sq_sums: np.ndarray) -> None:
        """Merge one scan-engine chunk of τ statistics kept on the device:
        `tau` / `tau_max_per_dev` are the (N,) values after the chunk,
        `tau_sums` / `tau_sq_sums` each round's Σ_i τ(t,i) and Σ_i τ(t,i)²
        (exact integers). The running totals stay float64, summed as
        per-round `update` calls sum them."""
        tau_sums = np.asarray(tau_sums)
        if self.rounds == 0 and len(tau_sums) and self.strict \
                and tau_sums[0] != 0:
            raise ValueError(
                "absorb_scan: round 0 must be all-active (Definition "
                "5.2(1)); pass strict=False to use the init convention.")
        self.tau = np.asarray(tau, np.int64)
        self.tau_max_per_dev = np.asarray(tau_max_per_dev, np.int64)
        self.sum_tau += float(np.sum(tau_sums, dtype=np.float64))
        self.sum_tau_sq += float(np.sum(np.asarray(tau_sq_sums),
                                        dtype=np.float64))
        self.rounds += len(tau_sums)

    @property
    def tau_bar(self) -> float:
        """τ̄_T: mean τ(t,i) over all rounds × devices seen so far."""
        return self.sum_tau / max(self.rounds * self.n, 1)

    @property
    def tau_max(self) -> int:
        """τ_max,T: the largest τ(t,i) seen by any device."""
        return int(self.tau_max_per_dev.max(initial=0))

    @property
    def d_bar(self) -> float:
        """\\bar d_T (App. C): mean of τ(t,i)² over rounds × devices."""
        return self.sum_tau_sq / max(self.rounds * self.n, 1)

    @property
    def d_max_bar(self) -> float:
        """\\bar d_max,T (App. B): mean over devices of (max_t τ(t,i))²."""
        return float((self.tau_max_per_dev.astype(np.float64) ** 2).mean())

    @property
    def tau_max_bar(self) -> float:
        """\\bar τ_max,T (App. C): mean over devices of max_t τ(t,i)."""
        return float(self.tau_max_per_dev.astype(np.float64).mean())


def tau_matrix(masks: np.ndarray, *, strict: bool = True) -> np.ndarray:
    """masks (T, N) bool -> the τ(t, i) matrix (T, N) int64.

    Raises if masks[0] is not all-active (Definition 5.2(1), which makes τ
    well defined); strict=False counts τ from a virtual round −1 instead
    (see `_check_first_round`)."""
    masks = np.asarray(masks, bool)
    T, N = masks.shape
    if T:
        _check_first_round(masks[0], strict, "tau_matrix")
    tau = np.zeros((T, N), np.int64)
    cur = np.zeros(N, np.int64)
    for t in range(T):
        cur = np.where(masks[t], 0, cur + 1)
        tau[t] = cur
    return tau
