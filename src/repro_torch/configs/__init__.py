"""Architecture configs for the ported (tabular) paper models.

Counterpart of `repro/configs/__init__.py`, cut to the fields the tabular
path reads. The model-zoo configs (transformer, MoE, SSM families) are not
ported yet (ROADMAP Queue 1 item 18): `get_config` raises for them.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    """The fields of the JAX package's ArchConfig that the tabular path reads."""

    name: str
    family: str             # "tabular" is the only ported family
    n_layers: int           # hidden layers (0 => logistic regression)
    d_model: int            # feature dim
    d_ff: int               # hidden width
    vocab_size: int         # number of classes
    fl_clients: int = 16
    fl_local_steps: int = 1
    param_dtype: str = "float32"
    source: str = ""

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


PAPER_IDS = ["paper_logistic", "paper_mlp"]


def canonical_id(arch: str) -> str:
    key = arch.strip().replace("-", "_")
    if key in PAPER_IDS:
        return key
    raise NotImplementedError(
        f"config {arch!r} is not ported; the port has {PAPER_IDS} "
        "(model zoo configs: ROADMAP Queue 1 item 18)")


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_id(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical_id(arch)}")
    return mod.smoke()
