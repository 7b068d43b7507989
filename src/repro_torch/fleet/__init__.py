"""Fleet executor: K independent FL trials on a leading trial axis.

`run_sim_fleet` and `SimTrial` (simulated-time fleets) are not ported yet
(ROADMAP Queue 1 item 16) and raise."""
from repro_torch.fleet.executor import (FleetHistory, FleetRunner,  # noqa: F401
                                        make_fleet_eval, run_fleet)
from repro_torch.fleet.spec import (FleetSpec, Trial,  # noqa: F401
                                    _not_ported, expand_grid)


def run_sim_fleet(*args, **kwargs):
    """Not ported yet: simulated-time fleets (ROADMAP Queue 1 item 16)."""
    raise _not_ported("run_sim_fleet", "16")


class SimTrial:
    """Not ported yet: simulated-time fleets (ROADMAP Queue 1 item 16)."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("SimTrial", "16")
