"""Partition rules, the client axis split over a mesh, and params placed
over a mesh's axes (`sharding.params`) (counterpart of `repro/sharding/`)."""
from repro_torch.sharding.rules import (DATA, MODEL,  # noqa: F401
                                        NamedSharding, PartitionSpec,
                                        batch_specs,
                                        cache_specs, client_state_specs,
                                        param_specs, placements)
