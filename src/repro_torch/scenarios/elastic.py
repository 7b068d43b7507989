"""Elastic fleets: clients that arrive and depart mid-run. Counterpart of
`repro/scenarios/elastic.py`.

MIFA's state is one memory row per client, and every engine has ONE fixed
client axis (a captured round cannot grow). `ElasticProcess` models
membership churn the way the banks model variable cohorts: size the run
for the peak fleet (`elastic_capacity` rounds up to a power-of-two bucket)
and fold membership into availability:

    active(t, i) = inner_mask(t, i) AND join_i <= t < leave_i

Clients not yet arrived and clients departed are plain inactive devices:
bank rows that stay zero until first participation, τ entries that grow,
carry rows that never change shape. MIFA averages its memory over the
capacity N, so a client that has not arrived contributes its zero row to
mean_G, the paper's treatment of a device unseen since round 0. A departed
device has unbounded τ: Assumption 4 fails, the arbitrary regime.

Round 0 is every *present* client (`round0_all_active = False`), a
documented deviation from Definition 5.2(1) that the runners accommodate
(`TauStats(strict=False)`). The window protocol (`TraceReplay`) is
forwarded to the inner process, so elastic trace replay streams windows
like the bare process.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.scenarios.base import AvailabilityProcess, TauBound
from repro_torch.scenarios.processes import _col, _round
from repro_torch.scenarios.registry import make_process, register

#: `leave` sentinel meaning "never departs" (any round beyond reach).
NEVER = 1 << 30


def elastic_capacity(peak_clients: int) -> int:
    """Power-of-two client capacity for an elastic run whose fleet peaks at
    `peak_clients`, the bucketing the cohort path uses for pad widths."""
    from repro_torch.core.runner import _pow2_bucket
    return _pow2_bucket(peak_clients)


def staged_arrivals(n: int, *, n_initial: int, arrive_every: int = 16,
                    arrive_count: int | None = None) -> np.ndarray:
    """(n,) join rounds: `n_initial` clients at round 0, then batches of
    `arrive_count` (default: the remainder over 4 waves) every
    `arrive_every` rounds until the capacity is full."""
    if not 0 < n_initial <= n:
        raise ValueError(f"n_initial must be in (0, {n}], got {n_initial}")
    extras = n - n_initial
    if arrive_count is None:
        arrive_count = max(-(-extras // 4), 1)
    join = np.zeros(n, np.int64)
    for i in range(extras):
        join[n_initial + i] = arrive_every * (1 + i // arrive_count)
    return join


class ElasticProcess(AvailabilityProcess):
    """Membership churn folded into any inner availability process.

    Device state ``{"inner": <inner state>, "join": (n,) int32, "leave":
    (n,) int32}``: the schedules ride the state, not the closure, so fleet
    trials can carry different ones. `n` is the CAPACITY; `leave` holds
    `NEVER` for clients that stay.
    """

    round0_all_active = False

    def __init__(self, inner: AvailabilityProcess,
                 join: np.ndarray | None = None,
                 leave: np.ndarray | None = None):
        self.inner = inner
        self.n = inner.n
        self.seed = inner.seed
        self.stateless = inner.stateless
        self.join = (np.zeros(self.n, np.int64) if join is None
                     else np.asarray(join, np.int64))
        self.leave = (np.full(self.n, NEVER, np.int64) if leave is None
                      else np.asarray(leave, np.int64))
        if self.join.shape != (self.n,) or self.leave.shape != (self.n,):
            raise ValueError(
                f"join/leave must be ({self.n},) round arrays, got "
                f"{self.join.shape} / {self.leave.shape}")

    # -- window protocol (forwarded to the inner process) ------------------ #
    @property
    def scan_window(self):
        """The inner process's carried-window length (None without one)."""
        return getattr(self.inner, "scan_window", None)

    def load_window(self, state: dict, t0: int) -> dict:
        """Re-point the inner process's carried window at [t0, t0+W)."""
        self.inner.load_window(state["inner"], t0)
        return state

    def load_window_fleet(self, state: dict, procs, t0: int) -> dict:
        """Stacked-trial `load_window` over the trials' inner processes."""
        self.inner.load_window_fleet(state["inner"],
                                     [p.inner for p in procs], t0)
        return state

    # -- device surface ---------------------------------------------------- #
    def init_state(self, device="cpu") -> dict:
        """The inner state plus the (n,) join/leave schedules as int32."""
        return {"inner": self.inner.init_state(device),
                "join": torch.as_tensor(self.join.astype(np.int32),
                                        device=device),
                "leave": torch.as_tensor(self.leave.astype(np.int32),
                                         device=device)}

    def sample_fn(self) -> Callable:
        """The inner mask ANDed with presence; round 0 is every PRESENT
        client."""
        inner_fn = self.inner.sample_fn()

        def sample(key, t, state):
            mask, inner_state = inner_fn(key, t, state["inner"])
            tc = _col(_round(t, key))
            present = (state["join"] <= tc) & (tc < state["leave"])
            return mask & present, {**state, "inner": inner_state}

        return sample

    # -- host surface ------------------------------------------------------ #
    def init_state_host(self) -> dict:
        return {"inner": self.inner.init_state_host(), "join": self.join,
                "leave": self.leave}

    def host_step(self, t: int, state: dict) -> tuple[np.ndarray, dict]:
        """The inner host step ANDed with the same presence."""
        mask, inner_state = self.inner.host_step(t, state["inner"])
        present = (state["join"] <= t) & (t < state["leave"])
        return (np.asarray(mask, bool) & np.asarray(present, bool),
                {**state, "inner": inner_state})

    # -- theory ------------------------------------------------------------ #
    def stationary_rate(self) -> np.ndarray:
        """(n,) long-run rate: the inner rate for clients that eventually
        join and never leave, 0 for everyone else."""
        stays = (self.join < NEVER) & (self.leave >= NEVER)
        return np.where(stays, self.inner.stationary_rate(), 0.0)

    def tau_bound(self) -> TauBound:
        """Departures (or clients that never join) break Assumption 4: τ of
        a departed device grows without bound. A purely growing fleet keeps
        the inner bound shifted by the last arrival."""
        inner_b = self.inner.tau_bound()
        if np.any(self.leave < NEVER) or np.any(self.join >= NEVER):
            return TauBound(
                deterministic=False, t0=np.inf, expected_tau=np.nan,
                note="departed clients never return: τ is unbounded on "
                     "every sample path (arbitrary-unavailability regime)")
        return TauBound(
            deterministic=inner_b.deterministic,
            t0=inner_b.t0 + float(self.join.max()),
            expected_tau=np.nan,
            note=f"growing fleet: inner bound ({inner_b.note or 'see inner'})"
                 " shifted by the last arrival round")


@register("elastic")
def _elastic(*, n: int, seed: int = 0, inner: str = "bernoulli",
             inner_kwargs: dict | None = None, join=None, leave=None,
             n_initial: int | None = None, arrive_every: int = 16,
             arrive_count: int | None = None, depart_frac: float = 0.0,
             depart_at: int | None = None) -> ElasticProcess:
    """Registry factory. `n` is the CAPACITY; the inner process is built at
    that size through the registry (`inner` + `inner_kwargs`). Default
    schedule: half the capacity present at round 0, the rest arriving in
    waves every `arrive_every` rounds (`staged_arrivals`); `depart_frac`
    of the capacity (the lowest ids) leaves for good at `depart_at`
    (default ``2 * arrive_every``). Explicit `join` / `leave` (n,) round
    arrays override."""
    proc = make_process(inner, n=n, seed=seed, **(inner_kwargs or {}))
    if join is None:
        n_init = n_initial if n_initial is not None else max(n // 2, 1)
        join = staged_arrivals(n, n_initial=n_init,
                               arrive_every=arrive_every,
                               arrive_count=arrive_count)
    if leave is None:
        leave = np.full(n, NEVER, np.int64)
        k = int(n * depart_frac)
        if k:
            leave[:k] = depart_at if depart_at is not None \
                else 2 * arrive_every
    return ElasticProcess(proc, join=join, leave=leave)
