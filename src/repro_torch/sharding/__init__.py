"""Partition rules and the client axis split over a mesh (counterpart of
`repro/sharding/`)."""
from repro_torch.sharding.rules import (DATA, MODEL,  # noqa: F401
                                        NamedSharding, PartitionSpec,
                                        batch_specs,
                                        cache_specs, client_state_specs,
                                        param_specs, placements)
