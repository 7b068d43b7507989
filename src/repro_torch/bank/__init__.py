"""Memory banks: cohort-sized MIFA server state (counterpart of
`repro/bank`)."""
from repro_torch.bank.base import (MemoryBank, broadcast_valid,  # noqa: F401
                                   check_unique_ids)
from repro_torch.bank.dense import DenseBank  # noqa: F401
from repro_torch.bank.host import HostBank  # noqa: F401
from repro_torch.bank.int8_paged import Int8PagedBank  # noqa: F401
from repro_torch.bank.mifa_bank import BankedMIFA  # noqa: F401
from repro_torch.bank.paged_device import PagedDeviceBank  # noqa: F401

_BACKENDS = {"dense": DenseBank, "host": HostBank,
             "int8_paged": Int8PagedBank, "paged_device": PagedDeviceBank}


def make_bank(backend: str = "dense", **kwargs) -> MemoryBank:
    """backend: 'dense' | 'host' | 'int8_paged' | 'paged_device' (kwargs ->
    backend ctor)."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown bank backend {backend!r}; choose from "
                         f"{sorted(_BACKENDS)}")
    return _BACKENDS[backend](**kwargs)
