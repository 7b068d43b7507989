"""Scenario subsystem: correlated, non-stationary availability sampled on
the run's device.

Counterpart of `repro/scenarios`. A `Scenario` pairs an availability
process with a latency model; every process has a host surface (numpy
masks, for cohort algorithms) and a device surface (a pure ``(key, t,
state) -> (mask, state)`` on tensors, sampled inside the round body),
which draw the same masks, array-equal to the reference's.

Trace replay (`TraceReplay`: recorded device traces streamed from disk
in windows carried on the device) and elastic fleets (`ElasticProcess`:
arrivals and departures folded into availability over a fixed capacity)
are the arbitrary-unavailability regime.
"""
from repro_torch.scenarios.base import (AvailabilityProcess,  # noqa: F401
                                        HostSampler, Scenario, TauBound,
                                        as_process)
from repro_torch.scenarios.processes import (  # noqa: F401
    Adversarial, Bernoulli, BernoulliDrift, ClusterCorrelated, Diurnal,
    GilbertElliott, StagedBlackout)
from repro_torch.scenarios.registry import (make_process,  # noqa: F401
                                            make_scenario, register,
                                            scenario_names)
from repro_torch.scenarios.trace_replay import (  # noqa: F401
    TraceFile, TraceReplay, cached_trace, open_trace, synthesize_trace,
    write_trace)
from repro_torch.scenarios.elastic import (ElasticProcess,  # noqa: F401
                                           elastic_capacity, staged_arrivals)
