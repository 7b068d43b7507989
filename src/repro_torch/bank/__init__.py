from repro_torch.bank.base import (MemoryBank, broadcast_valid,  # noqa: F401
                                   check_unique_ids)
from repro_torch.bank.dense import DenseBank  # noqa: F401
from repro_torch.bank.mifa_bank import BankedMIFA  # noqa: F401
