"""Discrete-event federated runtime simulator in simulated seconds
(counterpart of `repro/sim`).

Layers:
  * events   — heap-based event queue (arrival / round-close records).
  * latency  — per-client round-trip-time laws (shifted exponential,
               lognormal compute + comm, trace replay), each with a device
               surface `sample_fn` and a host `sample` that materialises
               it on the run's device.
  * policies — server round policies: WaitForAll, WaitForS (paper Eq. 3),
               Deadline, Impatient (MIFA), BufferedKofN (FedBuff-style).
               All lower to one parametric algebra (`policy_params`,
               `unified_select`, `unified_resolve`), so mixed-policy
               fleets run as one program.
  * engine   — FedSimEngine, the heap engine: drives RoundRunner rounds on
               a simulated clock; the reference semantics.
  * compiled — SimScanDriver: the same simulation as device work, each
               round on the card replays of captured CUDA graphs;
               bit-equal to FedSimEngine.
"""
from repro_torch.sim.events import Event, EventQueue  # noqa: F401
from repro_torch.sim.latency import (LatencyModel,  # noqa: F401
                                     LognormalLatency,
                                     ShiftedExponentialLatency, TraceLatency,
                                     tiered_shifted_exponential)
from repro_torch.sim.policies import (BufferedKofN, Deadline,  # noqa: F401
                                      Impatient, WaitForAll, WaitForS,
                                      init_policy_state, policy_params,
                                      unified_resolve, unified_select)
from repro_torch.sim.engine import FedSimEngine, SimConfig  # noqa: F401
from repro_torch.sim.compiled import (SimScanDriver, SimSpec,  # noqa: F401
                                      run_sim_scan, sim_scan_supported)
