"""Memory banks: cohort-sized MIFA server state (counterpart of
`repro/bank`)."""
from repro_torch.bank.base import (MemoryBank, broadcast_valid,  # noqa: F401
                                   check_unique_ids)
from repro_torch.bank.dense import DenseBank  # noqa: F401
from repro_torch.bank.mifa_bank import BankedMIFA  # noqa: F401
from repro_torch.bank.paged_device import PagedDeviceBank  # noqa: F401

_BACKENDS = {"dense": DenseBank, "paged_device": PagedDeviceBank}
_NOT_PORTED = {"host": "9", "int8_paged": "10"}


def make_bank(backend: str = "dense", **kwargs) -> MemoryBank:
    """backend: 'dense' | 'paged_device' (kwargs -> backend ctor). 'host'
    and 'int8_paged' are not ported yet and raise naming their ROADMAP
    item."""
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"bank backend {backend!r} is not ported yet (ROADMAP Queue 1 "
            f"item {_NOT_PORTED[backend]})")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown bank backend {backend!r}; choose from "
                         f"{sorted(_BACKENDS)}")
    return _BACKENDS[backend](**kwargs)
