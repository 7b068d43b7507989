"""BankedMIFA — MIFA driven through a MemoryBank: O(|A(t)|·d) rounds.

Mathematically identical to `core.mifa.MIFA(memory="array")`: each round the
cohort's fresh updates replace their stored rows, and the server moves by
η · G_sum / N. `RoundRunner` detects `cohort_based = True` and switches to
the compact round path, and `fleet.FleetRunner` to
`round_step_cohort_fleet`, which applies K trials' cohorts in one batched
scatter. Counterpart of `repro/bank/mifa_bank.py`.
"""
from __future__ import annotations

import torch

from repro_torch.bank.base import MemoryBank


class BankedMIFA:
    """memory-bank MIFA; `bank` picks the storage backend."""

    cohort_based = True

    def __init__(self, bank: MemoryBank):
        self.bank = bank

    def init_state(self, params, n_clients: int) -> dict:
        return {"bank": self.bank.init(params, n_clients), "t": 0}

    def prepare_cohort(self, state: dict, ids) -> dict:
        """Residency hook before a round (identity for DenseBank)."""
        return {**state, "bank": self.bank.prepare(state["bank"], ids)}

    def round_step_cohort(self, state: dict, ids, valid, updates,
                          losses: torch.Tensor):
        """ids (C,) padded row indices and valid (C,) mask, host numpy;
        updates/losses for the padded cohort on the run's device.
        Returns (new_state, mean_G, metrics)."""
        bank_state = self.bank.scatter(state["bank"], ids, updates,
                                       valid=valid)
        mean_g = self.bank.mean_g(bank_state)
        v = torch.as_tensor(valid, dtype=torch.float32, device=losses.device)
        loss = (losses * v).sum() / v.sum().clamp(min=1.0)
        metrics = {"loss": loss, "n_active": v.sum()}
        return ({"bank": bank_state, "t": state["t"] + 1}, mean_g, metrics)

    def round_step_cohort_fleet(self, state: dict, ids, valid, updates,
                                losses: torch.Tensor):
        """Stacked-trial cohort round: ids/valid (K, C) host numpy, update
        leaves (K, C, ...), losses (K, C). Per trial the math of
        `round_step_cohort`; the bank applies all K scatters in one batched
        call. Returns (new_state, mean_G (K, ...), metrics with (K,)
        leaves)."""
        bank_state = self.bank.scatter_fleet(state["bank"], ids, updates,
                                             valid=valid)
        mean_g = self.bank.mean_g(bank_state)
        v = torch.as_tensor(valid, dtype=torch.float32, device=losses.device)
        loss = (losses * v).sum(1) / v.sum(1).clamp(min=1.0)
        metrics = {"loss": loss, "n_active": v.sum(1)}
        return ({"bank": bank_state, "t": state["t"] + 1}, mean_g, metrics)
