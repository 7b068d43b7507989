"""Scenario registry: named (process, latency) environments built by
string, counterpart of `repro/scenarios/registry.py`:

    scen = make_scenario("gilbert_elliott", n=100, seed=3,
                         rate=0.5, burst=8.0)
    run_fl(model=model, algo=algo, scenario=scen, ..., device="cuda")

Third parties register their own with `register` (decorator or call).
`trace_replay` and `elastic` register from their own modules
(`scenarios.trace_replay`, `scenarios.elastic`).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np

from repro_torch.scenarios import processes as P
from repro_torch.scenarios.base import AvailabilityProcess, Scenario

_REGISTRY: dict[str, Callable[..., AvailabilityProcess]] = {}


def register(name: str, factory: Callable | None = None):
    """Register `factory(n=..., seed=..., **kw) -> AvailabilityProcess`
    under `name`. Usable as a decorator (`@register("my_scenario")`) or a
    plain call; returns the factory."""
    def _do(f: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = f
        return f
    return _do(factory) if factory is not None else _do


def scenario_names() -> list[str]:
    """Registered scenario names, sorted."""
    return sorted(_REGISTRY)


def make_process(name: str, *, n: int, seed: int = 0,
                 **kwargs) -> AvailabilityProcess:
    """Build the bare availability process for `name` (see `make_scenario`)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {scenario_names()}")
    return _REGISTRY[name](n=n, seed=seed, **kwargs)


def make_scenario(name: str, *, n: int, seed: int = 0, latency: Any = None,
                  **kwargs) -> Scenario:
    """Build a named `Scenario`: `n` devices, `seed` pinning every mask,
    `latency` an optional simulator latency model, `kwargs` forwarded to
    the factory. Its `name` reads ``name/k1=v1,k2=v2/seed<seed>``, as the
    reference's."""
    proc = make_process(name, n=n, seed=seed, **kwargs)
    tag = ",".join(f"{k}={_short(v)}" for k, v in sorted(kwargs.items()))
    full = name + (f"/{tag}" if tag else "") + f"/seed{seed}"
    return Scenario(process=proc, latency=latency, name=full)


def _short(v) -> str:
    if isinstance(v, (list, tuple, np.ndarray)):
        return f"arr{np.asarray(v).shape}"
    return str(v)


# --------------------------------------------------------------------------- #
# built-ins, with the reference's defaults
# --------------------------------------------------------------------------- #

@register("bernoulli")
def _bernoulli(*, n: int, seed: int = 0, probs=0.5) -> P.Bernoulli:
    return P.Bernoulli(probs, n=n, seed=seed)


@register("bernoulli_drift")
def _bernoulli_drift(*, n: int, seed: int = 0, p0=0.8, drift=-0.004,
                     lo: float = 0.05, hi: float = 1.0) -> P.BernoulliDrift:
    return P.BernoulliDrift(p0, drift, lo=lo, hi=hi, n=n, seed=seed)


@register("gilbert_elliott")
def _gilbert_elliott(*, n: int, seed: int = 0, rate=0.5,
                     burst=4.0) -> P.GilbertElliott:
    return P.GilbertElliott.from_rate_and_burst(rate, burst, n=n, seed=seed)


@register("cluster")
def _cluster(*, n: int, seed: int = 0, n_clusters: int = 4, q_fail=0.05,
             q_recover=0.25, p_device=0.9, assignment=None,
             contiguous: bool = True) -> P.ClusterCorrelated:
    """`contiguous` (default) assigns clients to clusters in blocks, so a
    regional outage silences a contiguous id range."""
    if assignment is None and contiguous:
        assignment = (np.arange(n) * n_clusters) // max(n, 1)
    return P.ClusterCorrelated(n, n_clusters, q_fail, q_recover,
                               p_device=p_device, assignment=assignment,
                               seed=seed)


@register("diurnal")
def _diurnal(*, n: int, seed: int = 0, base=0.55, amplitude=0.45,
             period: float = 24.0, spread_phases: bool = True,
             phase=None) -> P.Diurnal:
    if phase is None:
        phase = (np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
                 if spread_phases else 0.0)
    return P.Diurnal(base, amplitude, period, phase=phase, n=n, seed=seed)


@register("staged_blackout")
def _staged_blackout(*, n: int, seed: int = 0, stage_probs=None,
                     bounds=None, dark_frac: float = 0.5,
                     stage_len: int = 20) -> P.StagedBlackout:
    """Default schedule: full activity, then a growing fraction of the
    fleet (up to `dark_frac`) blacked out in stages that sharpen; the final
    stage restores everyone (so Assumption 4 holds)."""
    if stage_probs is None:
        n_dark = int(n * dark_frac)
        s0 = np.ones(n)
        s1, s2 = np.ones(n), np.ones(n)
        s1[:n_dark // 2] = 0.0          # first wave of the outage
        s2[:n_dark] = 0.0               # sharpened: the full dark set
        s3 = np.ones(n)                 # recovery
        stage_probs = np.stack([s0, s1, s2, s3])
        bounds = np.array([stage_len, 2 * stage_len, 3 * stage_len])
    return P.StagedBlackout(stage_probs, bounds, n=n, seed=seed)


@register("adversarial")
def _adversarial(*, n: int, seed: int = 0, periods=8, offs=3,
                 phases=None) -> P.Adversarial:
    return P.Adversarial(periods, offs, phases=phases, n=n, seed=seed)
