"""FleetSpec — declarative sweep grids expanded into batched trial lists.

Counterpart of `repro/fleet/spec.py`. A *trial* is one independent FL run:
(seed, participation process or scenario, label). A *FleetSpec* is a group
of trials that share one algorithm configuration and run together as one
fleet (`fleet.run_fleet`); `expand_grid` builds the cross product seeds ×
availability points per algorithm.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence


@dataclass(frozen=True)
class Trial:
    """One independent FL run inside a fleet group: its `seed` keys model
    init and the round generator. Availability comes from exactly one of
    `participation` (draws its (N,) masks on the host, ``.sample(t) ->
    (N,) bool``) and `scenario` (a `repro_torch.scenarios` Scenario or
    process: a dense fleet samples it inside the round on the device, a
    cohort fleet takes its host surface). The trials of one group share
    the scenario type; their parameters and chain states stack along the
    trial axis."""

    seed: int
    participation: Any = None
    scenario: Any = None
    label: str = ""

    def __post_init__(self):
        if (self.participation is None) == (self.scenario is None):
            raise ValueError(
                "Trial needs exactly one of participation= or scenario=")


@dataclass
class FleetSpec:
    """A group of trials sharing one algorithm configuration.

    `scan_chunk` sets the rounds a chunk of `run_fleet(engine="scan")`
    holds (None: `run_fleet`'s default, 64); the loop engine ignores
    it."""

    algo: Any
    trials: list[Trial] = field(default_factory=list)
    uses_update_clock: bool = False
    cohort_capacity: int | None = None
    scan_chunk: int | None = None
    name: str = ""

    @property
    def n_trials(self) -> int:
        """K — the number of trials in this group."""
        return len(self.trials)

    @property
    def seeds(self) -> tuple:
        """Per-trial seeds, in trial order."""
        return tuple(t.seed for t in self.trials)

    @property
    def participations(self) -> tuple:
        """Per-trial participation processes (None for scenario trials)."""
        return tuple(t.participation for t in self.trials)

    @property
    def labels(self) -> list[str]:
        """Per-trial display labels, in trial order."""
        return [t.label for t in self.trials]


def _avail_tag(kwargs: dict) -> str:
    return ",".join(f"{k}{v}" for k, v in sorted(kwargs.items()))


def expand_grid(*, algos: dict[str, Any], seeds: Sequence[int],
                make_participation: Callable | None = None,
                make_scenario: Callable | None = None,
                avail_grid: Sequence[dict] = ({},),
                clock: Sequence[str] = (),
                cohort_capacity: int | None = None) -> list[FleetSpec]:
    """Expand (algorithm × seed × availability point) into FleetSpecs.

    algos: name -> algorithm instance (one spec with seeds × avail_grid
    trials), or name -> callable taking the availability kwargs and
    returning an instance (one spec per grid point; for algorithms whose
    configuration depends on the point, e.g. FedAvgIS's probabilities).
    make_participation: ``(seed=..., **avail_kwargs) -> host process``;
    make_scenario: ``(seed=..., **avail_kwargs) -> scenario process``
    (trials carry `Trial.scenario`; exactly one of the two). The scenario
    type must not vary across one spec's grid points. clock: algo names
    that use the update clock. cohort_capacity: pinned cohort pad width
    for cohort algorithms. Labels read
    ``name/avail/seed<s>``, as the reference's.
    """
    if (make_participation is None) == (make_scenario is None):
        raise ValueError(
            "pass exactly one of make_participation= or make_scenario=")

    def _trial(s: int, av: dict, name: str) -> Trial:
        label = f"{name}/{_avail_tag(av)}/seed{s}"
        if make_scenario is not None:
            return Trial(seed=s, scenario=make_scenario(seed=s, **av),
                         label=label)
        return Trial(seed=s, participation=make_participation(seed=s, **av),
                     label=label)

    specs: list[FleetSpec] = []
    for name, algo in algos.items():
        common = dict(uses_update_clock=name in clock,
                      cohort_capacity=cohort_capacity)
        if callable(algo) and not hasattr(algo, "init_state"):
            for av in avail_grid:
                specs.append(FleetSpec(
                    algo=algo(**av), trials=[_trial(s, av, name)
                                             for s in seeds],
                    name=f"{name}/{_avail_tag(av)}", **common))
        else:
            specs.append(FleetSpec(
                algo=algo, trials=[_trial(s, av, name) for av in avail_grid
                                   for s in seeds],
                name=name, **common))
    return specs
