"""Memory banks: cohort-sized MIFA server state (counterpart of
`repro/bank`)."""
from repro_torch.bank.base import (MemoryBank, broadcast_valid,  # noqa: F401
                                   check_unique_ids)
from repro_torch.bank.dense import DenseBank  # noqa: F401
from repro_torch.bank.int8_paged import Int8PagedBank  # noqa: F401
from repro_torch.bank.mifa_bank import BankedMIFA  # noqa: F401
from repro_torch.bank.paged_device import PagedDeviceBank  # noqa: F401

_BACKENDS = {"dense": DenseBank, "paged_device": PagedDeviceBank,
             "int8_paged": Int8PagedBank}
_NOT_PORTED = {"host": "9"}


def make_bank(backend: str = "dense", **kwargs) -> MemoryBank:
    """backend: 'dense' | 'paged_device' | 'int8_paged' (kwargs -> backend
    ctor). 'host' is not ported yet and raises naming its ROADMAP item."""
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"bank backend {backend!r} is not ported yet (ROADMAP Queue 1 "
            f"item {_NOT_PORTED[backend]})")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown bank backend {backend!r}; choose from "
                         f"{sorted(_BACKENDS)}")
    return _BACKENDS[backend](**kwargs)
