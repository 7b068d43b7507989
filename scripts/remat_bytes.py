#!/usr/bin/env python3
"""Bytes the training forward keeps for its backward pass, with
`cfg.remat` off and on, counted on the CPU.

    python3 scripts/remat_bytes.py [--arch hubert-xlarge] [--layers 1 2]
        [--mb 2] [--seq 512] [--clients 2]

Builds `--arch` at full width (random bf16 params from seed 0) at each
depth of `--layers`, runs `Model.loss_fn` once on one client's minibatch
(`--mb` x `--seq`, drawn as `chip_smoke.stub_batch` or `launch.train`
draw them) under `torch.autograd.graph.saved_tensors_hooks`, and sums the
bytes of the distinct storages the backward pass would read, leaving out
the params and the batch (they live anyway). Two depths give the bytes a
layer (their difference) and the rest (the embedding, the head and the
loss). Prints one JSON object: for each depth and remat setting the
bytes kept for one client, and, for `--clients` clients (a vmap round
holds every client's at once), the bytes a layer and the whole depth of
the config. These are counts of tensor sizes, not a device measurement:
the backward pass also holds one layer's recomputed activations at a
time, and the peak of a round adds what the round keeps besides
(params, G, the update sums).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def batch_of(cfg, mb: int, seq: int) -> dict:
    """One client's minibatch of cfg's modality, from numpy seed 0."""
    rng = np.random.default_rng(0)
    if cfg.modality == "audio":
        return {"frames": torch.from_numpy(rng.standard_normal(
                    (mb, seq, cfg.d_model), np.float32)).bfloat16(),
                "labels": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (mb, seq)).astype(np.int32))}
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (mb, seq)).astype(np.int32))}
    if cfg.modality == "vision_text":
        out["patches"] = torch.from_numpy(0.02 * rng.standard_normal(
            (mb, cfg.n_patches, cfg.d_model), np.float32)).bfloat16()
    return out


def kept_bytes(cfg, mb: int, seq: int) -> int:
    """Bytes of the distinct storages saved for the backward pass of one
    loss_fn call, params and batch left out."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = batch_of(cfg, mb, seq)
    live = {t.untyped_storage().data_ptr()
            for t in tree_leaves(params) + list(batch.values())}
    kept: dict[int, int] = {}

    def pack(t: torch.Tensor):
        s = t.untyped_storage()
        if s.data_ptr() not in live:
            kept[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss_fn(params, batch)
    del loss
    return sum(kept.values())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hubert-xlarge")
    ap.add_argument("--layers", type=int, nargs=2, default=(1, 2))
    ap.add_argument("--mb", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--clients", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    torch.set_num_threads(4)
    full = get_config(args.arch)
    lo, hi = args.layers
    out = {"arch": full.name, "mb": args.mb, "seq": args.seq,
           "clients": args.clients, "device": "cpu (sizes only)"}
    for remat in (False, True):
        b = {n: kept_bytes(full.replace(n_layers=n, remat=remat), args.mb,
                           args.seq) for n in (lo, hi)}
        layer = (b[hi] - b[lo]) // (hi - lo)
        rest = b[lo] - lo * layer
        out[f"remat_{str(remat).lower()}"] = {
            "client_bytes_at_depth": b,
            "layer_bytes_one_client": layer,
            "rest_bytes_one_client": rest,
            "round_bytes_at_full_depth": args.clients * (
                rest + full.n_layers * layer),
            "full_depth": full.n_layers}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
