"""BankedMIFA — MIFA driven through a MemoryBank: O(|A(t)|·d) rounds.

Mathematically identical to `core.mifa.MIFA(memory="array")`: each round the
cohort's fresh updates replace their stored rows, and the server moves by
η · G_sum / N. `RoundRunner` detects `cohort_based = True` and switches to
the compact round path, and `fleet.FleetRunner` to
`round_step_cohort_fleet`, which applies K trials' cohorts in one batched
scatter. Counterpart of `repro/bank/mifa_bank.py`.

The round takes its cohort staged: the runner pads it on the host, checks
it, pages it in (`prepare_cohort`) and maps it to the bank's row index
(`bank.stage_rows`); the round itself is device work only, so the scan
engine can capture it as a CUDA graph.

Under a mesh of data extent > 1 the bank (`DenseBank(mesh=)`) holds the
rank's block of rows; the round takes the cohort slots whose rows the rank
owns (`round_step_cohort(clients=)`, the bank's `shard`), and the loss and
n_active span the data group.
"""
from __future__ import annotations

import torch

from repro_torch.bank.base import MemoryBank
from repro_torch.sharding.clients import LOCAL


class BankedMIFA:
    """memory-bank MIFA; `bank` picks the storage backend."""

    cohort_based = True
    #: the availability regime it needs: Assumption 4 only, as MIFA
    assumes = "arbitrary"

    def __init__(self, bank: MemoryBank):
        self.bank = bank

    @property
    def round_rng(self) -> str:
        """The round generator `round_step_cohort(rng=)` takes: the bank's
        (the device one for int8 pages, the CPU one otherwise)."""
        return self.bank.round_rng

    def init_state(self, params, n_clients: int) -> dict:
        bank = self.bank.init(params, n_clients)
        t = torch.zeros((), dtype=torch.int32, device=self.bank.device)
        return {"bank": bank, "t": t}

    def prepare_cohort(self, state: dict, ids) -> dict:
        """Residency hook before a round (identity for DenseBank)."""
        return {**state, "bank": self.bank.prepare(state["bank"], ids)}

    def round_step_cohort(self, state: dict, rows: torch.Tensor,
                          valid: torch.Tensor, updates,
                          losses: torch.Tensor, rng=None, clients=None):
        """rows (C,): the padded cohort as `bank.stage_rows` maps it, and
        valid (C,) bool, on the run's device; updates/losses for the padded
        cohort. `rng` is the generator `round_rng` names. With `clients`
        (the bank's `shard`) the slots are those the rank owns. Returns
        (new_state, mean_G, metrics)."""
        ax = clients or LOCAL
        bank_state = self.bank.scatter_staged(state["bank"], rows, valid,
                                              updates, rng=rng)
        mean_g = self.bank.mean_g(bank_state)
        v = valid.float()
        loss = ax.total(losses * v) / ax.total(v).clamp(min=1.0)
        metrics = {"loss": loss, "n_active": ax.total(v)}
        return ({"bank": bank_state, "t": state["t"] + 1}, mean_g, metrics)

    def round_step_cohort_fleet(self, state: dict, rows: torch.Tensor,
                                valid: torch.Tensor, updates,
                                losses: torch.Tensor, rng=None):
        """Stacked-trial cohort round: rows/valid (K, C) staged as for
        `round_step_cohort`, update leaves (K, C, ...), losses (K, C);
        `rng` a list of the trials' generators. Per trial the math of
        `round_step_cohort`; the bank applies all K scatters in one batched
        call. Returns (new_state, mean_G (K, ...), metrics with (K,)
        leaves)."""
        bank_state = self.bank.scatter_fleet_staged(state["bank"], rows,
                                                    valid, updates, rng=rng)
        mean_g = self.bank.mean_g(bank_state)
        v = valid.float()
        loss = (losses * v).sum(1) / v.sum(1).clamp(min=1.0)
        metrics = {"loss": loss, "n_active": v.sum(1)}
        return ({"bank": bank_state, "t": state["t"] + 1}, mean_g, metrics)
