"""Fleet executor: K independent FL trials on a leading trial axis, and
simulated-time fleets (`run_sim_fleet`, `SimTrial`)."""
from repro_torch.fleet.executor import (FleetHistory, FleetRunner,  # noqa: F401
                                        FleetScanDriver, fleet_scan_supported,
                                        make_fleet_eval, run_fleet)
from repro_torch.fleet.sim import SimTrial, run_sim_fleet  # noqa: F401
from repro_torch.fleet.spec import (FleetSpec, Trial,  # noqa: F401
                                    expand_grid)
