"""Step builders: the MIFA FL train_step and the serve steps of a model
(counterpart of `repro/launch/steps.py`).

train_step(params, G, batch, active, eta) -> (params, G, metrics)
  * vmap mode (default): every client's K-step local update at once
    (`core.local_update.client_updates`, `torch.func.vmap`), then the
    server step through `kernels.ops.mifa_aggregate_tree`: the hand-written
    `mifa_aggregate` kernel on the card (one launch a leaf table), its
    plain version on the CPU.
  * sequential mode (`cfg.sequential_clients`, qwen1.5-110b and
    llava-next-34b): a loop over clients, one client's update alive at a
    time (each batch leaf sliced per client), each G row selected and
    summed into an f32 accumulator as the reference's `lax.scan` does;
    the weights move by eta · acc / N. Plain PyTorch: the reference has no
    kernel there.
  G's rows are written in place (the vmap mode on the card, the sequential
  mode everywhere), as with the reference's donated buffers: callers must
  not reuse the G they passed in.

serve steps:
  * decode: (params, cache, tokens, pos) -> (logits, cache)
  * prefill: (params, cache, batch) -> (logits, cache)
  * encoder score (hubert-xlarge): (params, batch) -> per-batch CE
Built with a DeviceMesh whose `model` axis has extent > 1, decode,
prefill and the train step run on each rank's blocks
(`sharding.tensor_parallel`: split products, the GQA stack (dense or MoE)).

`batch` holds the model's modality (`models.model`): tokens; tokens and
patches (vision_text); frames and labels (audio). Both train modes run
`Model.loss_fn`, whose training forward rematerializes each layer under
`cfg.remat` (`models.remat`), so remat comes from the config.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.local_update import client_updates, device_update
from repro_torch.kernels.ops import mifa_aggregate_tree
from repro_torch.models import Model
from repro_torch.sharding import tensor_parallel
from repro_torch.sharding.params import (block, block_shape, whole,
                                         whole_shape)
from repro_torch.tree import tree_leaves, tree_map


def _mean_active_loss(losses: torch.Tensor, active: torch.Tensor
                      ) -> torch.Tensor:
    act = active.float()
    return (losses * act).sum() / act.sum().clamp(min=1.0)


def make_train_step(model: Model, cfg: ArchConfig, n_clients: int,
                    k_steps: int, update_spec=None, mesh=None) -> Callable:
    """The MIFA round (array memory) as one function of (params, G, batch,
    active, eta): `batch` leaves (N, K, mb, ...) on the params' device,
    `active` (N,) bool there, `eta` a Python float or a 0-d f32 tensor.

    `update_spec`: a tree of `sharding.rules.NamedSharding` matching the
    params (`launch.specs` builds it from `param_specs` of the fsdp
    config), the placement the reference constrains each client's update
    to in sequential mode. On a `DeviceMesh` the f32 accumulator is held
    as this rank's blocks under it, each client's update is cut to the
    rank's block as it is summed (the whole update lives only while it is
    formed and written into G), and the blocks are gathered once for the
    weights' move (`sharding.params`): the numbers are the unplaced step's,
    and at extent 1 the blocks are the whole tensors. On an `AbstractMesh`
    (the dry run's fake trace) the spec places nothing and the whole step
    runs. The vmap mode takes no update constraint, as the reference's.
    The step takes whole arguments: `launch.specs.run_placed` runs it on
    each rank's blocks of a plan's arguments.

    `mesh`: a DeviceMesh whose `model` axis has extent > 1 makes the step
    split (`_split_train_step`): it takes and returns each rank's blocks of
    the params and G, and of the batch's clients, under the plan's specs
    (`launch.specs`). At model extent 1, and on an abstract mesh, it is
    the step above."""
    split = tensor_parallel.train_split(cfg, mesh, n_clients)
    if split is not None:
        return _split_train_step(model, cfg, n_clients, k_steps, split,
                                 update_spec)
    placed = None
    if update_spec is not None:
        first = tree_leaves(update_spec)[0]
        if hasattr(first.mesh, "get_group"):
            placed = update_spec

    if not cfg.sequential_clients:
        def train_step(params, G, batch, active, eta):
            updates, losses = client_updates(model.loss_fn, params, batch,
                                             eta, K=k_steps)
            G, params = mifa_aggregate_tree(G, updates, active, params, eta)
            return params, G, {"loss": _mean_active_loss(losses, active)}
        return train_step

    def train_step(params, G, batch, active, eta):
        """Sequential clients: one client's update alive at a time."""
        def zeros(p, s=None):
            shape = p.shape if s is None else block_shape(
                tuple(p.shape), s.spec, s.mesh, p.device)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        specs = [] if placed is None else [placed]
        acc = tree_map(zeros, params, *specs)
        losses = []
        for i in range(n_clients):
            u_i, loss_i = device_update(model.loss_fn, params,
                                        {k: v[i] for k, v in batch.items()},
                                        eta)

            def sel(g, u, a, s=None, i=i):
                g[i] = torch.where(active[i], u.to(g.dtype), g[i])
                a += (g[i] if s is None else block(g[i], s.spec,
                                                   s.mesh)).float()
                return g
            G = tree_map(sel, G, u_i, acc, *specs)
            del u_i
            losses.append(loss_i)
        if placed is not None:
            acc = tree_map(lambda a, s: whole(a, s.spec, s.mesh), acc, placed)
        params = tree_map(lambda w, a: (w - eta * a / n_clients).to(w.dtype),
                          params, acc)
        return params, G, {"loss": _mean_active_loss(torch.stack(losses),
                                                     active)}

    return train_step


def _split_train_step(model: Model, cfg: ArchConfig, n_clients: int,
                      k_steps: int, split, update_spec) -> Callable:
    """The MIFA round on this rank's blocks (`make_train_step(mesh=)`):
    params under `split.param_specs`, G under `split.state_specs`, the
    batch and `active` whole where the data extent is 1, and the batch's
    client axis over data in vmap mode beyond (`active` stays whole).

    Vmap mode: every client's local update runs on the rank's param blocks
    and its clients (the loss closes over the split); each update leaf
    moves into G's blocks in G's dtype (`TrainSplit.move_tree`, one leaf
    at a time: the server step stores it in that dtype, so nothing
    changes but the bytes moved), so do the params, and the server step
    is `MIFA.round_step` on them: at data extent 1 `mifa_aggregate_tree`
    (the kernel on the card), beyond it the rank's partial column sums
    all-reduced over data; the new params move back to their blocks. Sequential mode (data extent 1): each
    client's update is formed on the param blocks, cast to G's dtype and
    moved into G's row blocks; the f32 accumulator is held in
    `update_spec`'s blocks (the params' without it), and the weights move
    on the params' blocks."""
    from repro_torch.core.mifa import MIFA
    from repro_torch.sharding.clients import client_shard

    def loss_fn(params, batch):
        return model.loss_fn(params, batch, split)

    if not cfg.sequential_clients:
        def split_step(params, G, batch, active, eta):
            updates, losses = client_updates(loss_fn, params, batch, eta,
                                             K=k_steps)
            updates = split.move_tree(updates, split.update_specs,
                                      split.row_specs, via=G)
            w = split.move_tree(tree_map(lambda x: x, params),
                                split.param_specs, split.step_specs)
            shard = client_shard(split.mesh, n_clients, active.device,
                                 what="the train step's clients")
            act = active if shard is None else shard.block(active)
            t0 = torch.zeros((), dtype=torch.int32, device=active.device)
            state, w, metrics = MIFA(memory="array").round_step(
                {"G": G, "t": t0}, w, updates, losses, act, eta,
                clients=shard)
            del updates
            params = split.move_tree(w, split.step_specs, split.param_specs)
            return params, state["G"], {"loss": metrics["loss"]}
        split_step.split = split
        return split_step

    acc_specs = (split.param_specs if update_spec is None
                 else tree_map(lambda s: s.spec, update_spec))

    def split_step(params, G, batch, active, eta):
        """Sequential clients on the blocks: one client's update alive at
        a time."""
        def zeros(w, ps, s_acc):
            shape = whole_shape(tuple(w.shape), ps, split.mesh)
            return torch.zeros(block_shape(shape, s_acc, split.mesh,
                                           w.device, split=True),
                               dtype=torch.float32, device=w.device)
        acc = tree_map(zeros, params, split.param_specs, acc_specs)
        losses = []
        for i in range(n_clients):
            u_i, loss_i = device_update(loss_fn, params,
                                        {k: v[i] for k, v in batch.items()},
                                        eta)

            def sel(g, u, a, ps, gs, s_acc, i=i):
                u = split.move(u.to(g.dtype), ps, gs)
                g[i] = torch.where(active[i], u, g[i])
                a += split.move(g[i], gs, s_acc).float()
                return g
            G = tree_map(sel, G, u_i, acc, split.param_specs,
                         split.step_specs, acc_specs)
            del u_i
            losses.append(loss_i)
        acc = split.move_tree(acc, acc_specs, split.param_specs)
        params = tree_map(lambda w, a: (w - eta * a / n_clients).to(w.dtype),
                          params, acc)
        return params, G, {"loss": _mean_active_loss(torch.stack(losses),
                                                     active)}
    split_step.split = split
    return split_step


def make_decode_step(model: Model, mesh=None, *, batch: int | None = None,
                     cache_len: int | None = None) -> Callable:
    """(params, cache, tokens, pos) -> (logits, cache). With a `mesh`
    whose `model` axis has extent > 1 (a DeviceMesh), the step takes and
    returns this rank's blocks of the params, cache, tokens and logits
    under the reference's specs for `batch` sequences and a cache of
    `cache_len` positions (`sharding.tensor_parallel`), under
    `torch.inference_mode()`."""
    split = tensor_parallel.serve_split(model.cfg, mesh, batch, cache_len)
    if split is None:
        def serve_step(params, cache, tokens, pos):
            return model.decode_step(params, tokens, pos, cache)
        return serve_step

    def split_step(params, cache, tokens, pos):
        with torch.inference_mode():
            return model.decode_step(params, tokens, pos, cache, split)
    split_step.split = split
    return split_step


def make_prefill_step(model: Model, mesh=None, *, batch: int | None = None,
                      cache_len: int | None = None) -> Callable:
    """(params, cache, batch) -> (last-position logits, cache); `mesh`,
    `batch` and `cache_len` as in `make_decode_step`."""
    split = tensor_parallel.serve_split(model.cfg, mesh, batch, cache_len)
    if split is None:
        def prefill_step(params, cache, batch):
            return model.prefill(params, batch, cache)
        return prefill_step

    def split_step(params, cache, batch):
        with torch.inference_mode():
            return model.prefill(params, batch, cache, split)
    split_step.split = split
    return split_step


def make_encoder_step(model: Model) -> Callable:
    """Encoder-only 'serving' = a scoring forward pass (no cache)."""
    def encode_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss_fn(params, batch)
        return metrics["ce"]
    return encode_step
