"""FL training entry point: MIFA over any ported architecture (counterpart of
`repro/launch/train.py`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --smoke --rounds 50 --clients 8 --p-min 0.2 --device cpu

Each round: Bernoulli availability (probabilities spread from `--p-min` to
1), one `TokenBatcher` round of synthetic per-client token streams, K local
SGD steps on every client, and the MIFA server step. Architectures with
`sequential_clients` (qwen1.5-110b) run array memory through
`launch.steps.make_train_step`'s sequential mode, one client's update alive
at a time; the others vmap every client's update (`client_updates`) and
step the server with `MIFA.round_step`, whose array memory is the
hand-written `mifa_aggregate` kernel on the card. The training forward is
the differentiable model path (`models.transformer.forward`): it calls no
kernel. On the card (the default device) params are random, drawn there
from `--seed`; `train(params=)` takes others. The stub-frontend models
(llava-next-34b, hubert-xlarge) need patches or frames that no batcher
here draws: `train` raises for them, and they train through
`make_train_step` on batches their caller builds.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.core import MIFA, BernoulliParticipation, TauStats
from repro_torch.core.local_update import client_updates
from repro_torch.data import TokenBatcher
from repro_torch.kernels.backend import (DEFAULT_DEVICE, resolve_device,
                                         set_numerics)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import constant, inv_t


# what a round's batch of each stub-frontend modality holds, leaves (N, K,
# mb, ...)
_MODALITY_BATCH = {"vision_text": "tokens and patches",
                   "audio": "frames and labels"}


def train(arch: str = "granite-3-8b", *, smoke: bool = False,
          rounds: int = 50, clients: int = 8, k_steps: int = 1, mb: int = 2,
          seq: int = 128, p_min: float = 0.3, eta0: float = 0.25,
          lr_schedule: str = "inv_t", memory: str = "array", seed: int = 0,
          checkpoint: str | None = None,
          device: str | torch.device = DEFAULT_DEVICE, params=None,
          log_every: int = 10, cfg: ArchConfig | None = None) -> dict:
    """`rounds` MIFA rounds of `clients` clients on `device`, printing the
    reference's lines. `cfg` overrides `arch`/`smoke` (e.g. a config with
    its depth cut); `params` (a tree of tensors on `device`) replace the
    random init. `checkpoint` saves the final params (`save_pytree`).

    Returns {"cfg", "n_params", "final_loss", "tau_bar", "tau_max",
    "wall_s", "losses" (one a round), "round_s" (host seconds a round,
    each ending in the read of its loss), "params"}.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        set_numerics()
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.modality in _MODALITY_BATCH:
        # the reference's loop feeds these models TokenBatcher's tokens and
        # fails inside loss_fn; their batches go to make_train_step
        raise ValueError(
            f"{cfg.name}: train() draws token batches only and cannot feed "
            f"the {cfg.modality!r} modality; build its batch ("
            f"{_MODALITY_BATCH[cfg.modality]}) and call "
            "launch.steps.make_train_step")
    cfg = cfg.replace(fl_clients=clients, fl_local_steps=k_steps)
    model = build_model(cfg)
    if params is None:
        params = model.init(seed, device=dev)
    n_params = model.param_count(params)
    print(f"arch={cfg.name} params={n_params:,} clients={clients} "
          f"K={k_steps}")

    batcher = TokenBatcher(n_clients=clients, vocab=cfg.vocab_size,
                           seq_len=seq, batch_size=mb, k_steps=k_steps,
                           seed=seed)
    part = BernoulliParticipation(np.linspace(p_min, 1.0, clients),
                                  seed=seed + 1)
    algo = MIFA(memory=memory, memory_dtype="float32")
    state = algo.init_state(params, clients)
    sched = inv_t(eta0) if lr_schedule == "inv_t" else constant(eta0)
    stats = TauStats(clients)
    # int8 memory rounds stochastically from the run's device generator,
    # as run_fl's rounds do
    rng = (torch.Generator(device=dev).manual_seed(seed)
           if algo.round_rng == "device" else None)
    step = (make_train_step(model, cfg, clients, k_steps)
            if cfg.sequential_clients and memory == "array" else None)

    losses, round_s = [], []
    t0 = time.time()
    for t in range(rounds):
        t_round = time.perf_counter()
        active_np = part.sample(t)
        stats.update(active_np)
        active = torch.from_numpy(active_np).to(dev)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in batcher.sample_round(t).items()}
        eta_f = sched(t + 1)
        eta = torch.tensor(eta_f, dtype=torch.float32, device=dev)
        if step is not None:
            params, G, metrics = step(params, state["G"], batch, active, eta)
            state = {"G": G, "t": state["t"] + 1}
        else:
            updates, client_losses = client_updates(
                model.loss_fn, params, batch, eta, K=k_steps)
            state, params, metrics = algo.round_step(
                state, params, updates, client_losses, active, eta, rng=rng)
            del updates
        losses.append(float(metrics["loss"]))
        round_s.append(time.perf_counter() - t_round)
        if t % log_every == 0 or t == rounds - 1:
            print(f"round {t:4d} loss={losses[-1]:.4f} "
                  f"active={int(active_np.sum())}/{clients} "
                  f"eta={eta_f:.4f} "
                  f"({(time.time() - t0) / (t + 1):.2f}s/round)")

    wall_s = time.time() - t0
    out = {"cfg": cfg, "n_params": n_params, "final_loss": losses[-1],
           "tau_bar": stats.tau_bar, "tau_max": stats.tau_max,
           "wall_s": wall_s, "losses": losses, "round_s": round_s,
           "params": params}
    print(json.dumps({"final_loss": out["final_loss"],
                      "tau_bar": out["tau_bar"], "tau_max": out["tau_max"],
                      "wall_s": round(wall_s, 1)}))
    if checkpoint:
        save_pytree(checkpoint, params)
        print(f"saved params -> {checkpoint}")
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU scale)")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--k-steps", type=int, default=1)
    ap.add_argument("--mb", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--p-min", type=float, default=0.3)
    ap.add_argument("--eta0", type=float, default=0.25)
    ap.add_argument("--lr-schedule", default="inv_t",
                    choices=["inv_t", "constant"])
    ap.add_argument("--memory", default="array",
                    choices=["array", "delta", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    return train(args.arch, smoke=args.smoke, rounds=args.rounds,
                 clients=args.clients, k_steps=args.k_steps, mb=args.mb,
                 seq=args.seq, p_min=args.p_min, eta0=args.eta0,
                 lr_schedule=args.lr_schedule, memory=args.memory,
                 seed=args.seed, checkpoint=args.checkpoint,
                 device=args.device, log_every=args.log_every)


if __name__ == "__main__":
    main()
