"""Scenario subsystem: correlated, non-stationary availability sampled on
the run's device.

Counterpart of `repro/scenarios`. A `Scenario` pairs an availability
process with a latency model; every process has a host surface (numpy
masks, for cohort algorithms) and a device surface (a pure ``(key, t,
state) -> (mask, state)`` on tensors, sampled inside the round body),
which draw the same masks, array-equal to the reference's.

Trace replay (`TraceReplay`, `TraceFile`, `open_trace`, `cached_trace`,
`synthesize_trace`, `write_trace`) and elastic fleets (`ElasticProcess`,
`elastic_capacity`, `staged_arrivals`) come with ROADMAP Queue 1 item 17
and raise until then.
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


def _not_ported(name: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP Queue "
                                  "1 item 17: trace replay and elastic "
                                  "fleets)")
    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = f"Not ported yet: {name} (ROADMAP Queue 1 item 17)."
    return stub


TraceFile = _not_ported("TraceFile")
TraceReplay = _not_ported("TraceReplay")
cached_trace = _not_ported("cached_trace")
open_trace = _not_ported("open_trace")
synthesize_trace = _not_ported("synthesize_trace")
write_trace = _not_ported("write_trace")
ElasticProcess = _not_ported("ElasticProcess")
elastic_capacity = _not_ported("elastic_capacity")
staged_arrivals = _not_ported("staged_arrivals")
