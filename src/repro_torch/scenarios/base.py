"""Scenario base layer: availability processes with a host and a device
surface.

Counterpart of `repro/scenarios/base.py`.

* `AvailabilityProcess` — one availability law with two sampling surfaces
  that draw the same masks at a fixed seed:

    - device: `sample_fn()` returns a pure function ``(key, t, state) ->
      (mask, state)`` on tensors of one device. It reads nothing back to
      the host and branches on no tensor, so `run_fl` samples inside the
      round body and the scan engine captures it in the round's CUDA
      graph. `state` is a dict of tensors holding the chain state and
      every numeric parameter, so a fleet stacks the states of trials with
      different parameters along a leading (K,) axis and runs one sample
      over all of them, with (K, 2) keys and (K,) rounds.
    - host: `host_sampler()` returns a stateful object with the
      participation protocol (``.sample(t) -> (N,) bool`` numpy, ``.n``).
      It runs the same function on CPU tensors, so the formula is written
      once.

  Every uniform comes from `_threefry`, which reproduces `jax.random`'s
  ``uniform(fold_in(PRNGKey(seed), t), shape)`` bit for bit: the port's
  masks on either surface are array-equal to the reference's.

* `TauBound` — where the process sits relative to the paper's Assumption 4
  (τ(t,i) <= t0 + t/b), with the witnessing t0 and the stationary E[τ]
  where a closed form exists.

* `Scenario` — a named (process, latency-model) pair; the latency models
  and the simulator are `repro_torch.sim`.

Conventions shared by every process: round 0 is all-active (paper Remark
5.2 / Definition 5.2(1)), and round t's randomness is drawn from
``fold_in(key, t)``, so masks depend on (seed, t) only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.scenarios import _threefry


@dataclass(frozen=True)
class TauBound:
    """Where a process sits relative to the paper's Assumption 4.

    `deterministic`: ``τ(t,i) <= t0 + t/b`` holds on every sample path with
    this `t0`; `t0` is the longest possible inactivity stretch (``np.inf``
    without an almost-sure bound); `expected_tau` the stationary E[τ]
    averaged over devices (``np.nan`` without a closed form); `note` a
    one-line justification.
    """

    deterministic: bool
    t0: float
    expected_tau: float
    note: str = ""

    def holds(self, t0: float, b: float = np.inf) -> bool:
        """True iff Assumption 4 with offset `t0` (and any slope b >= 1)
        holds on every sample path of this process."""
        del b
        return self.deterministic and self.t0 <= t0


class HostSampler:
    """Host surface of an `AvailabilityProcess`: ``sample(t) -> (N,) bool``
    numpy and ``n``, so it plugs in wherever a participation process does.

    A stateful process (a Markov chain) must be sampled at t = 0, 1, 2, ...
    in order; a memoryless one takes any t.
    """

    def __init__(self, process: "AvailabilityProcess"):
        self.process = process
        self.n = process.n
        self._state = process.init_state_host()
        self._t_next = 0

    def sample(self, t: int) -> np.ndarray:
        """Availability mask for round t as a (N,) bool array."""
        if not self.process.stateless:
            if t != self._t_next:
                raise ValueError(
                    f"{type(self.process).__name__} is stateful: host "
                    f"sampling must visit rounds in order (expected "
                    f"t={self._t_next}, got t={t})")
            self._t_next += 1
        mask, self._state = self.process.host_step(t, self._state)
        return np.asarray(mask, bool)

    def sample_block(self, t0: int, length: int) -> np.ndarray:
        """(length, n) bool masks for rounds [t0, t0 + length): `sample`
        round by round."""
        return np.stack([self.sample(t0 + j) for j in range(length)])


class AvailabilityProcess:
    """Base class: one availability law, two sampling surfaces.

    Subclasses set `n`, `seed` and `stateless` and implement
    `init_state(device)` (every parameter and the chain state, as tensors:
    nothing trial-specific in the sample function's closure),
    `sample_fn()` (pure ``(key, t, state) -> (mask, state)``, forcing
    all-active at t == 0), `stationary_rate()` and `tau_bound()`.
    """

    n: int
    seed: int
    stateless: bool = True
    #: round 0 activates every device (Definition 5.2(1)); elastic fleets
    #: activate only the present ones
    round0_all_active: bool = True
    #: a windowed process (trace replay) carries `scan_window` rounds of
    #: masks in its state and implements the window protocol
    #: (`read_window`, `load_window`, `load_window_fleet`), which the
    #: engines call to re-point the window
    scan_window: int | None = None

    @property
    def key(self) -> torch.Tensor:
        """Base key, `jax.random.PRNGKey(seed)`, as a (2,) int64 CPU
        tensor; both surfaces derive round t's from it by fold_in."""
        return _threefry.seed_key(self.seed)

    # -- device surface ---------------------------------------------------- #
    def init_state(self, device: str | torch.device = "cpu") -> dict:
        """Initial state on `device` ({} for a process without one)."""
        return {}

    def sample_fn(self) -> Callable:
        """Pure ``(key, t, state) -> ((n,) bool mask, state)``."""
        raise NotImplementedError

    # -- host surface ------------------------------------------------------ #
    def init_state_host(self) -> dict:
        """The state on the CPU, for `host_step`."""
        return self.init_state("cpu")

    def host_step(self, t: int, state: dict) -> tuple[np.ndarray, dict]:
        """One application of `sample_fn` at round t on CPU tensors; the
        mask as numpy."""
        mask, state = self.sample_fn()(self.key, t, state)
        return mask.numpy(), state

    def host_sampler(self) -> HostSampler:
        """A fresh host-surface sampler."""
        return HostSampler(self)

    # -- theory ------------------------------------------------------------ #
    def stationary_rate(self) -> np.ndarray:
        """(n,) long-run fraction of rounds each device is active."""
        raise NotImplementedError

    def tau_bound(self) -> TauBound:
        """Assumption-4 classification of this process."""
        raise NotImplementedError


@dataclass
class Scenario:
    """One experiment environment: availability process + latency model.

    `latency` is a per-client RTT model for the simulator
    (`repro_torch.sim.latency`); None for round-synchronous runs. `name`
    is the registry tag.
    """

    process: AvailabilityProcess
    latency: Any = None
    name: str = ""

    @property
    def n(self) -> int:
        """Device count of the underlying process."""
        return self.process.n

    def sim_inputs(self) -> tuple[HostSampler, Any]:
        """(participation, latency) pair for the runtime simulator."""
        if self.latency is None:
            raise ValueError(
                f"scenario {self.name!r} has no latency model; pass one at "
                "construction to drive the runtime simulator")
        return self.process.host_sampler(), self.latency


def as_process(scenario_or_process) -> AvailabilityProcess:
    """Accept either a `Scenario` or a bare process; return the process."""
    if isinstance(scenario_or_process, Scenario):
        return scenario_or_process.process
    return scenario_or_process
