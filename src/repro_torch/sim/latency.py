"""Per-client round-trip latency models (compute + communication, seconds).

Counterpart of `repro/sim/latency.py`. Every model carries two sampling
surfaces:

  * device: `sample_fn()` returns a pure ``(key, t, state) -> (..., N)
    f32`` function on tensors of one device, branching on no tensor and
    reading nothing back, so the compiled simulator draws a round's RTTs
    inside a captured round. Every numeric parameter rides `state`
    (`init_state(device)`), none the closure, so a fleet stacks per-trial
    parameters along a leading (K,) axis and draws with (K, 2) keys and a
    (K,) round.
  * host: `sample(t, device=)` materialises the device surface: it runs
    the same ops on `device` (the run's; the model's own by default) and
    copies the (N,) vector to numpy. The heap engine passes the runner's
    device, so its RTTs are the compiled engine's bit for bit: the
    exponential and normal laws apply the device's `log1p` and `erfinv`,
    which differ from the CPU's (and from XLA's) by an ulp or a few.

Draws are keyed by ``fold_in(key, t)`` (`scenarios._threefry`, bit-equal
to `jax.random` up to those functions): RTTs depend only on (seed, t),
never on which clients a policy selects. All values are float32.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.scenarios import _threefry


def _per_client(x, n: int) -> np.ndarray:
    out = np.broadcast_to(np.asarray(x, np.float64), (n,)).copy()
    if not np.all(out >= 0):
        raise ValueError("latency parameters must be non-negative")
    return out


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(device)


class LatencyModel:
    """Base latency law: a device surface and the host surface that
    materialises it.

    Subclasses set `n` (device count), `seed` and `device`, and implement
    `init_state(device)` (the parameters as tensors) and `sample_fn()`.
    """

    n: int
    seed: int = 0
    device: torch.device

    @property
    def key(self) -> torch.Tensor:
        """Base key, `jax.random.PRNGKey(seed)` as a (2,) int64 CPU
        tensor; both surfaces derive round keys by fold_in(key, t)."""
        return _threefry.seed_key(self.seed)

    def init_state(self, device: str | torch.device = "cpu") -> dict:
        """The parameters as tensors on `device` (stackable per trial)."""
        raise NotImplementedError

    def sample_fn(self) -> Callable:
        """Pure ``(key, t, state) -> (..., N) f32 RTT seconds``."""
        raise NotImplementedError

    def sample(self, t: int, device: str | torch.device | None = None
               ) -> np.ndarray:
        """(N,) float32 round-trip seconds for round t: the device surface
        run on `device` (default: the model's) and copied to numpy."""
        dev = self.device if device is None else resolve_device(device)
        cache = self.__dict__.setdefault("_host", {})
        if dev not in cache:
            cache[dev] = (self.sample_fn(), self.key.to(dev),
                          self.init_state(dev))
        fn, key, state = cache[dev]
        t = torch.tensor(int(t), dtype=torch.int64, device=dev)
        return fn(key, t, state).cpu().numpy()


class ShiftedExponentialLatency(LatencyModel):
    """t_i = shift_i + Exp(scale_i): the classic straggler model, a
    deterministic floor (compute at full utilisation + link RTT) plus an
    exponential tail (contention, background load)."""

    def __init__(self, shifts, scales, n: int | None = None, seed: int = 0,
                 device: str | torch.device = DEFAULT_DEVICE):
        n = n if n is not None else len(np.atleast_1d(shifts))
        self.n = n
        self.shifts = _per_client(shifts, n)
        self.scales = _per_client(scales, n)
        self.seed = seed
        self.device = resolve_device(device)

    def init_state(self, device: str | torch.device = "cpu") -> dict:
        """{'shifts', 'scales'}: the (N,) f32 per-device parameters."""
        return {"shifts": _f32(self.shifts, device),
                "scales": _f32(self.scales, device)}

    def sample_fn(self) -> Callable:
        """Pure ``(key, t, state) -> (..., N) f32``: shift + scale·Exp(1)."""
        def rtt_fn(key, t, state):
            e = _threefry.exponential(_threefry.round_key(key, t),
                                      state["shifts"].shape[-1])
            return state["shifts"] + state["scales"] * e
        return rtt_fn


class LognormalLatency(LatencyModel):
    """Compute time exp(N(mu_i, sigma_i)) plus a fixed comm cost comm_i:
    heavy-tailed device speed, as measured in production FL fleets."""

    def __init__(self, mu, sigma, comm=0.0, n: int | None = None,
                 seed: int = 0, device: str | torch.device = DEFAULT_DEVICE):
        n = n if n is not None else len(np.atleast_1d(mu))
        self.n = n
        self.mu = np.broadcast_to(np.asarray(mu, np.float64), (n,)).copy()
        self.sigma = _per_client(sigma, n)
        self.comm = _per_client(comm, n)
        self.seed = seed
        self.device = resolve_device(device)

    def init_state(self, device: str | torch.device = "cpu") -> dict:
        """{'mu', 'sigma', 'comm'}: the (N,) f32 per-device parameters."""
        return {"mu": _f32(self.mu, device),
                "sigma": _f32(self.sigma, device),
                "comm": _f32(self.comm, device)}

    def sample_fn(self) -> Callable:
        """Pure ``(key, t, state) -> (..., N) f32``: exp(mu + sigma·z) +
        comm."""
        def rtt_fn(key, t, state):
            z = _threefry.normal(_threefry.round_key(key, t),
                                 state["mu"].shape[-1])
            return torch.exp(state["mu"] + state["sigma"] * z) + state["comm"]
        return rtt_fn


class TraceLatency(LatencyModel):
    """Replay a recorded (T, N) matrix of round-trip seconds; rounds past the
    trace end replay the last row. Deterministic: the device surface
    ignores its key and gathers the clamped row from the trace in
    `state`."""

    def __init__(self, trace: np.ndarray,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.trace = np.array(trace, np.float64, copy=True)
        if self.trace.ndim != 2 or not np.all(self.trace >= 0):
            raise ValueError("trace must be a (T, N) matrix of seconds >= 0")
        self.n = self.trace.shape[1]
        self.seed = 0
        self.device = resolve_device(device)

    def init_state(self, device: str | torch.device = "cpu") -> dict:
        """{'trace'}: the recorded (T, N) f32 RTT matrix."""
        return {"trace": _f32(self.trace, device)}

    def sample_fn(self) -> Callable:
        """Pure ``(key, t, state) -> (..., N) f32``: clamped trace-row
        replay (t a 0-d or (K,) tensor, the trace (T, N) or (K, T, N))."""
        def rtt_fn(key, t, state):
            tr = state["trace"]
            n_rows, n = tr.shape[-2], tr.shape[-1]
            t = torch.as_tensor(t, dtype=torch.int64, device=tr.device)
            row = t.clamp(max=n_rows - 1).reshape(tuple(t.shape) + (1, 1))
            return torch.take_along_dim(
                tr, row.expand(tuple(t.shape) + (1, n)), dim=-2).squeeze(-2)
        return rtt_fn


def tiered_shifted_exponential(n: int, *, tiers=((2.0, 1.0), (1.0, 0.4),
                                                 (0.4, 0.15)),
                               seed: int = 0,
                               device: str | torch.device = DEFAULT_DEVICE
                               ) -> ShiftedExponentialLatency:
    """Device-tier fleet: equal thirds of (shift, scale) tiers, slowest
    first, the slow/mid/fast split of the adversarial availability
    benchmark."""
    shifts = np.empty(n)
    scales = np.empty(n)
    k = len(tiers)
    for j, (sh, sc) in enumerate(tiers):
        lo = j * n // k
        hi = (j + 1) * n // k if j < k - 1 else n
        shifts[lo:hi], scales[lo:hi] = sh, sc
    return ShiftedExponentialLatency(shifts, scales, seed=seed, device=device)
