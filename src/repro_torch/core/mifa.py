"""MIFA — Memory-augmented Impatient Federated Averaging (paper Algorithm 1).

Server state: the update array {G^i}_{i=1..N}, a tree whose leaves carry a
leading client axis (N, *param_shape). Each round:

    G^i_t = G^i_{t-1}                  if i ∉ A(t)
          = (w_t − w^i_{t,K}) / η_t    if i ∈ A(t)      (fresh K-step update)
    w_{t+1} = w_t − η_t · (1/N) Σ_i G^i_t

Dense memory layouts (counterpart of `repro/core/mifa.py`):
  * "array" — paper-faithful float update array (fp32/bf16). The server
    step is `kernels.ops.mifa_aggregate_tree`: the hand-written CUDA kernel
    on the card, its plain version on the CPU.
  * "delta" — the paper's §4 memory-efficient variant: the server keeps the
    running mean Ḡ and per-client previous updates. Plain PyTorch; the
    reference has no kernel for it.
  * "int8" — G^i stored as int8 with an absmax scale per client and leaf,
    stochastically rounded (`core.quantized_memory`) from the run's device
    generator, which the runner passes as `rng=` (`round_rng = "device"`
    for this layout). Plain PyTorch, as the reference's `jnp`.

`eta` is a 0-d f32 tensor on the params' device (the runner's rounds; a
CUDA graph that captures one must not freeze a Python float) or a Python
float.

Under a mesh (`round_step(clients=)`, a `sharding.clients.ClientShard`)
the state holds the rank's block of the client axis and, where the params
are placed over `model`, of the param dims (`params` and `updates` are
then the same column blocks): each rank writes its active rows and takes
its f32 partial column sum, the sums are all-reduced over the data group,
then w moves (worlds of CPU ranks). At data extent 1 the rows are whole
and the array layout is `mifa_aggregate_tree` on the rank's column
blocks: the kernel on the card, in a world of ranks whose `model` axis
splits (`run_fl(mesh=, cfg=)`, `sharding.params.StepPlacement`). The int8
layout draws its rounding over the whole array and keeps the rank's block
(`quantized_memory.quantize_leaf`), and gathers the int8 rows, scales and
losses for the mean, so a split run is the unsplit run bit for bit.

For O(|A(t)|·d) cohort rounds use `repro_torch.bank.BankedMIFA`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch

from repro_torch.core import quantized_memory as qm
from repro_torch.kernels.ops import mifa_aggregate_tree
from repro_torch.sharding.clients import LOCAL
from repro_torch.tree import tree_leaves, tree_map


def _bcast(active: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """active (N,) -> broadcastable to leaf (N, ...)."""
    return active.reshape((active.shape[0],) + (1,) * (leaf.ndim - 1))


@dataclass(frozen=True)
class MIFA:
    """memory: 'array' | 'delta' | 'int8'; memory_dtype for the stored
    updates of the first two."""

    memory: str = "array"
    memory_dtype: str = "float32"
    #: the availability regime it needs: Assumption 4 only
    assumes: ClassVar[str] = "arbitrary"

    @property
    def round_rng(self) -> str:
        """Which round generator `round_step(rng=)` takes: int8 rounding
        draws on the run's device, the float layouts draw nothing."""
        return "device" if self.memory == "int8" else "cpu"

    def __post_init__(self):
        if self.memory not in ("array", "delta", "int8"):
            raise ValueError(f"unknown memory {self.memory!r}")
        if self.memory_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported memory_dtype {self.memory_dtype!r}")

    def init_state(self, params, n_clients: int) -> dict:
        dt = getattr(torch, self.memory_dtype)

        def zeros_n(p, dtype):
            return torch.zeros((n_clients,) + tuple(p.shape), dtype=dtype,
                               device=p.device)

        t = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
        if self.memory == "array":
            return {"G": tree_map(lambda p: zeros_n(p, dt), params), "t": t}
        if self.memory == "int8":
            return {"G_q": tree_map(lambda p: zeros_n(p, torch.int8), params),
                    "G_scale": tree_map(lambda p: torch.zeros(
                        n_clients, dtype=torch.float32, device=p.device),
                        params),
                    "t": t}
        return {"G_prev": tree_map(lambda p: zeros_n(p, dt), params),
                "G_bar": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params),
                "t": t}

    def round_step(self, state: dict, params, updates, losses: torch.Tensor,
                   active: torch.Tensor, eta: float, rng=None, clients=None):
        """updates: tree (N, ...) f32 — fresh K-step updates for ALL clients
        (the active mask selects which are used). `active` (N,) bool on the
        params' device. `rng` is the run's device generator for int8
        memory and unused otherwise. On the card the array layout updates
        G in place; the state passed in must not be reused. With `clients`
        (a `ClientShard`) the state, updates, losses and mask are the
        rank's block of the client axis, and the reductions span the data
        group.
        """
        ax = clients or LOCAL
        act = active.float()
        n = ax.n(act)
        whole_rows = clients is None or clients.group is None
        if self.memory == "array" and whole_rows:
            G, new_params = mifa_aggregate_tree(state["G"], updates, active,
                                                params, eta)
            new_state = {"G": G, "t": state["t"] + 1}
        elif self.memory == "array":
            # the plain server step on the block, its column sum all-reduced
            G = tree_map(lambda g, u: torch.where(_bcast(active, u),
                                                  u.to(g.dtype), g),
                         state["G"], updates)
            new_params = tree_map(
                lambda w, g: (w.float() - eta * (ax.sum(g.float()) / n)).to(
                    w.dtype), params, G)
            new_state = {"G": G, "t": state["t"] + 1}
        elif self.memory == "int8":
            if rng is None:
                raise ValueError("int8 memory needs the run's device "
                                 "generator (rng=) for its rounding")
            G_f = qm.dequantize_tree(state["G_q"], state["G_scale"])
            G_f = tree_map(lambda g, u: torch.where(_bcast(active, u), u, g),
                           G_f, updates)
            G_q, G_scale = qm.quantize_tree(rng, G_f, clients)
            # dequantize again, so an inactive row counts exactly as
            # stored; the mean over every row, as an unsplit run takes it
            rows = clients.gather if clients is not None else (lambda x: x)
            G_f = qm.dequantize_tree(tree_map(rows, G_q),
                                     tree_map(rows, G_scale))
            new_params = tree_map(lambda w, g: (w - eta * g.mean(0)).to(
                w.dtype), params, G_f)
            new_state = {"G_q": G_q, "G_scale": G_scale, "t": state["t"] + 1}
            if clients is not None:
                losses, act, ax = rows(losses), rows(act), LOCAL
        else:
            # Ḡ_t = Ḡ_{t-1} + (1/N) Σ_{i∈A} (G^i_t − G^i_{t'_i})
            deltas = tree_map(lambda u, gp: (u - gp.float()) * _bcast(act, u),
                              updates, state["G_prev"])
            G_bar = tree_map(lambda gb, d: gb + ax.sum(d) / n,
                             state["G_bar"], deltas)
            G_prev = tree_map(
                lambda gp, u: torch.where(_bcast(active, u), u.to(gp.dtype),
                                          gp),
                state["G_prev"], updates)
            new_params = tree_map(lambda w, g: (w - eta * g).to(w.dtype),
                                  params, G_bar)
            new_state = {"G_prev": G_prev, "G_bar": G_bar,
                         "t": state["t"] + 1}
        loss = ax.total(losses * act) / ax.total(act).clamp(min=1.0)
        return new_state, new_params, {"loss": loss,
                                       "n_active": ax.total(act)}
