"""Public model API for the ported tabular paper models.

Counterpart of `repro/models/model.py` for `family == "tabular"`: batch
format {'x': (B, d) float32, 'y': (B,) int}. Params are nested dicts of
tensors under the JAX package's keys — {"w","b"} for logistic regression,
{"layers": [{"w","b"}, ...], "out": {"w","b"}} for the MLP — so parity
tests compare leaf by leaf. The text/vision/audio families and serving are
not ported yet (ROADMAP Queue 1 item 18).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.backend import DEFAULT_DEVICE, resolve_device
from repro_torch.models.layers import _dense_init, softmax_cross_entropy
from repro_torch.tree import tree_leaves


class Model:
    def __init__(self, cfg: ArchConfig):
        if cfg.family != "tabular":
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported; the port has "
                "the tabular paper models (ROADMAP Queue 1 item 18)")
        self.cfg = cfg

    def init(self, gen: torch.Generator | int = 0, *,
             device: str | torch.device = DEFAULT_DEVICE) -> dict:
        """Fresh params on `device`. `gen` is a torch.Generator or a seed.
        Logistic regression starts at zeros, as in the reference."""
        dev = resolve_device(device)
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator().manual_seed(int(gen))
        cfg = self.cfg
        f32 = torch.float32
        if cfg.n_layers == 0:  # logistic regression
            return {"w": torch.zeros((cfg.d_model, cfg.vocab_size), dtype=f32,
                                     device=dev),
                    "b": torch.zeros((cfg.vocab_size,), dtype=f32, device=dev)}
        layers = []
        d_in = cfg.d_model
        for _ in range(cfg.n_layers):
            layers.append({"w": _dense_init(gen, (d_in, cfg.d_ff), f32, dev),
                           "b": torch.zeros((cfg.d_ff,), dtype=f32,
                                            device=dev)})
            d_in = cfg.d_ff
        return {"layers": layers,
                "out": {"w": _dense_init(gen, (d_in, cfg.vocab_size), f32,
                                         dev),
                        "b": torch.zeros((cfg.vocab_size,), dtype=f32,
                                         device=dev)}}

    def _tabular_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.n_layers == 0:
            return x @ params["w"] + params["b"]
        h = x
        for lp in params["layers"]:
            h = torch.relu(h @ lp["w"] + lp["b"])
        return h @ params["out"]["w"] + params["out"]["b"]

    def loss_fn(self, params: dict, batch: dict):
        """(loss, aux) — the reference's `_loss_tabular` contract."""
        logits = self._tabular_logits(params, batch["x"])
        ce = softmax_cross_entropy(logits, batch["y"])
        return ce, {"loss": ce, "ce": ce, "aux": torch.zeros_like(ce)}

    def accuracy(self, params: dict, batch: dict) -> torch.Tensor:
        logits = self._tabular_logits(params, batch["x"])
        return (logits.argmax(-1) == batch["y"].long()).float().mean()

    def param_count(self, params) -> int:
        return sum(int(np.prod(p.shape)) for p in tree_leaves(params))


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
