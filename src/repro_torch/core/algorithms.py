"""Algorithm registry: build aggregation algorithms by name, counterpart of
`repro/core/algorithms.py`:

    algo = make_algorithm("fedar", n=100, decay=0.5)
    run_fl(model=model, algo=algo, scenario=scen, ..., device="cuda")

Every factory takes the client count `n` plus the class's own kwargs
(`banked_mifa` forwards its kwargs, `device=` among them, to
`bank.make_bank`). `algorithm_assumes(name)` gives the availability regime
the mechanism needs: 'arbitrary' | 'iid_known_probs' | 'stationary_mixing'
| 'none'. A factory may carry the tag as its `assumes` attribute, so
reading it builds nothing (a bank on the card needs the card).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core.baselines import BiasedFedAvg, CAFed, FedAR, FedAvgIS
from repro_torch.core.mifa import MIFA

_REGISTRY: dict[str, Callable] = {}


def register_algorithm(name: str, factory: Callable | None = None):
    """Register `factory(*, n, **kw) -> algorithm` under `name`. Usable as
    a decorator or a plain call; returns the factory."""
    def _do(f: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"algorithm {name!r} already registered")
        _REGISTRY[name] = f
        return f
    return _do(factory) if factory is not None else _do


def algorithm_names() -> list[str]:
    """Registered algorithm names, sorted."""
    return sorted(_REGISTRY)


def make_algorithm(name: str, *, n: int, **kwargs):
    """Build the algorithm registered under `name` for an `n`-client fleet."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown algorithm {name!r}; registered: {algorithm_names()}")
    return _REGISTRY[name](n=n, **kwargs)


def algorithm_assumes(name: str, *, n: int = 2) -> str:
    """The availability regime `name` needs: 'arbitrary' |
    'iid_known_probs' | 'stationary_mixing' | 'none'."""
    tag = getattr(_REGISTRY.get(name), "assumes", None)
    return tag if tag is not None else make_algorithm(name, n=n).assumes


# --------------------------------------------------------------------------- #
# built-ins
# --------------------------------------------------------------------------- #

@register_algorithm("mifa")
def _mifa(*, n: int, memory: str = "array",
          memory_dtype: str = "float32") -> MIFA:
    del n
    return MIFA(memory=memory, memory_dtype=memory_dtype)


@register_algorithm("banked_mifa")
def _banked_mifa(*, n: int, backend: str = "dense", **bank_kw):
    del n
    # imported here: the bank package imports core's modules
    from repro_torch.bank import BankedMIFA, make_bank
    return BankedMIFA(make_bank(backend, **bank_kw))


_banked_mifa.assumes = "arbitrary"      # BankedMIFA.assumes


@register_algorithm("fedavg")
def _fedavg(*, n: int) -> BiasedFedAvg:
    del n
    return BiasedFedAvg()


@register_algorithm("fedavg_is")
def _fedavg_is(*, n: int, probs=0.5) -> FedAvgIS:
    return FedAvgIS(tuple(np.broadcast_to(
        np.asarray(probs, np.float64), (n,)).tolist()))


@register_algorithm("fedar")
def _fedar(*, n: int, decay: float = 0.5) -> FedAR:
    del n
    return FedAR(decay=decay)


@register_algorithm("ca_fed")
def _ca_fed(*, n: int, rho: float = 0.1, pi_min: float = 0.05,
            d_max: float = 0.85) -> CAFed:
    del n
    return CAFed(rho=rho, pi_min=pi_min, d_max=d_max)
