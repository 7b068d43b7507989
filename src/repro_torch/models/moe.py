"""Mixture-of-Experts block: top-k router and sort-based capacity dispatch
(counterpart of `repro/models/moe.py`).

The reference sorts the token assignments by expert id, gathers them into
an (E, C, d) buffer, runs every expert's SwiGLU as one batched product over
the expert axis and scatter-adds the gated outputs back. Tokens past an
expert's capacity C = ceil(T·k/E · capacity_factor) are dropped. C is fixed
per call from T = B·S, so a decode step of B tokens has its own, smaller C.

The port computes the same function with gathers only, so it is
deterministic on both devices and runs under `torch.func.vmap` and `grad`
(no in-place write, no `.item()`, no `one_hot`, no `bincount`):

* Routing: the router product in f32 (TF32 off on the card,
  `backend.set_numerics`), softmax, and the top k by a stable descending
  sort, which breaks ties toward the lower expert id as `lax.top_k` does.
* Dispatch: slot c of expert e holds the sorted assignment offsets[e] + c,
  read by gather. The reference writes its (E, C) table with a clamped
  `.at[].set`: every assignment past the capacity writes the pad token and
  gate 0 into slot C-1 after the last kept one did, and on the CPU the last
  write wins. So an overflowing expert keeps C-1 tokens, and slot C-1 is
  empty exactly when the expert's count passes C; the port builds that
  table directly.
* Combine: each token gathers its kept slots and sums them in ascending
  expert id in the experts' output dtype, the order and rounding of the
  reference's scatter-add, where an atomic `index_add_` would not be
  reproducible.

Experts over `model` (the reference's `(MODEL, None, None)` expert leaves;
`moe_apply(split=)` with a segment's `sharding.tensor_parallel.GQASplit`):
the router is whole and the tokens are replicated over the axis, so every
rank routes every token and builds the same (E, C) table. A rank computes
only its experts [lo, hi): rows lo..hi-1 of the table, gathered from the
whole tokens (no all-to-all), through its w1/w3/w2 blocks. Each token's
kept slots on those experts are combined as above, the others masked, and
the partial (T, d) is summed over `model` in f32. The tokens and the
gates enter the partitioned compute through `to_model`, so their
cotangents (and, through the gates, the router's) are summed over the
axis in the backward pass; the load-balance loss is replicated compute.
Where M does not divide E the experts are whole and every rank computes
them all. A shared SwiGLU's 2-D leaves take the dense MLP's rule
(`GQASplit.mlp_in`, `mlp_out`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _device_init, mlp_apply


def moe_init(gen: torch.Generator, d: int, f: int, n_experts: int,
             n_shared: int, dtype: torch.dtype) -> dict:
    """The reference's keys and shapes: an f32 router (d, E) at scale 0.02,
    experts w1, w3 (E, d, f) and w2 (E, f, d), and a shared SwiGLU of
    width f·n_shared when n_shared > 0."""
    p = {"router": _device_init(gen, (d, n_experts), torch.float32,
                                scale=0.02),
         "w1": _device_init(gen, (n_experts, d, f), dtype),
         "w3": _device_init(gen, (n_experts, d, f), dtype),
         "w2": _device_init(gen, (n_experts, f, d), dtype)}
    if n_shared:
        p["shared"] = {"w1": _device_init(gen, (d, f * n_shared), dtype),
                       "w3": _device_init(gen, (d, f * n_shared), dtype),
                       "w2": _device_init(gen, (f * n_shared, d), dtype)}
    return p


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert has for one call: ceil(T·k/E · capacity_factor), in
    the reference's float64 arithmetic."""
    return int(math.ceil(n_tokens * top_k / n_experts * capacity_factor))


class Routing(NamedTuple):
    """One call's routing. probs (T,E) f32; top (T,k+1) the largest k+1
    probabilities, descending (k+1 only while k < E); expert_ids (T,k) in
    the router's order; table (E,C) the token of each slot (T for an
    empty one) and table_gates (E,C) f32 its normalised gate (0 for an
    empty one); row (T,k) each assignment's slot as e·C + c, clamped to
    the expert's last slot: the assignment holds its slot exactly where
    the table names its token there."""
    probs: torch.Tensor
    top: torch.Tensor
    expert_ids: torch.Tensor
    table: torch.Tensor
    table_gates: torch.Tensor
    row: torch.Tensor

    def kept(self) -> torch.Tensor:
        """(T,k) whether each assignment holds a slot."""
        T = self.row.shape[0]
        tokens = torch.arange(T, device=self.row.device)[:, None]
        return self.table.reshape(-1)[self.row] == tokens


def router_probs(router: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """The router's softmax (T,E) over the tokens xt (T,d), in f32."""
    return torch.softmax(xt.float() @ router.float(), dim=-1)


def route(probs: torch.Tensor, top_k: int, capacity_factor: float
          ) -> Routing:
    """Route T tokens over E experts from their router probabilities
    (T,E)."""
    T, E = probs.shape
    A = T * top_k
    C = capacity(T, top_k, E, capacity_factor)
    dev = probs.device

    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = top[:, :top_k], ids[:, :top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    flat_expert = expert_ids.reshape(A)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add(
        0, flat_expert, torch.ones_like(flat_expert))
    offsets = torch.cumsum(counts, 0) - counts
    # each assignment's place in its expert's run, in assignment order
    pos_sorted = torch.arange(A, device=dev) - offsets[sorted_expert]
    pos = pos_sorted[torch.argsort(order)]

    slot = torch.arange(C, device=dev)
    valid = (slot < counts[:, None]) & ~((slot == C - 1)
                                         & (counts[:, None] > C))
    src = (offsets[:, None] + slot).clamp(max=A - 1)               # (E,C)
    sorted_pick = order[src]
    table = torch.where(valid, sorted_pick // top_k,
                        torch.full_like(sorted_pick, T))
    table_gates = torch.where(valid, gate_vals.reshape(A)[sorted_pick],
                              torch.zeros((), device=dev))
    row = flat_expert * C + pos.clamp(max=C - 1)
    return Routing(probs, top[:, :top_k + 1], expert_ids, table, table_gates,
                   row.reshape(T, top_k))


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, aux_coef: float = 0.01,
              split=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux scalar f32), the reference's
    `moe_apply`. Under `split` (a `tensor_parallel.GQASplit` of an MoE
    segment) `params` are this rank's blocks, x is whole, and y is summed
    over `model` (module docstring)."""
    B, S, d = x.shape
    E = params["router"].shape[-1]
    T = B * S
    xt = x.reshape(T, d)
    r = route(router_probs(params["router"], xt), top_k, capacity_factor)

    # Switch-style load-balance loss; the top-1 indicator without one_hot
    top1 = (r.expert_ids[:, :1] == torch.arange(E, device=x.device)).float()
    aux = aux_coef * E * (r.probs.mean(0) * top1.mean(0)).sum()

    # the experts on their (E, C) slots (the rank's rows of them under a
    # split); slot T of xpad is a zero pad row
    lo, hi = (0, E) if split is None else split.expert_block(E)
    xe_in = xt if split is None else split.experts_in(xt)
    xpad = torch.cat([xe_in, xe_in.new_zeros((1, d))], dim=0)
    xe = xpad[r.table[lo:hi]]                                      # (e,C,d)
    h = F.silu(torch.bmm(xe, params["w1"])) * torch.bmm(xe, params["w3"])
    ye = torch.bmm(h, params["w2"])                                # (e,C,d)

    # combine: each token's kept slots, in ascending expert id, summed in
    # ye's dtype as the reference's scatter-add rounds
    perm = torch.sort(r.expert_ids, dim=-1).indices
    rows = torch.gather(r.row, 1, perm)
    kept = torch.gather(r.kept(), 1, perm)
    gates = r.table_gates.reshape(-1)[rows].to(ye.dtype)
    if split is not None and split.experts:
        # the rank's slots: rows lo·C .. hi·C - 1, read at local rows
        C = r.table.shape[1]
        kept = kept & (rows >= lo * C) & (rows < hi * C)
        rows = (rows - lo * C).clamp(0, (hi - lo) * C - 1)
        gates = split.experts_in(gates)
    yflat = ye.reshape(-1, d)
    y = None
    for j in range(top_k):
        c = yflat[rows[:, j]] * gates[:, j, None]
        c = torch.where(kept[:, j, None], c, torch.zeros((), dtype=c.dtype,
                                                         device=c.device))
        y = c if y is None else y + c

    if split is None:
        if "shared" in params:
            y = y + mlp_apply(params["shared"], xt)
        return y.reshape(B, S, d), aux
    if "shared" not in params:
        return split.experts_out(y).reshape(B, S, d), aux
    # the shared SwiGLU on its column and row blocks (the dense MLP's
    # rule); one sum where both outputs are partial
    xs = xe_in if split.mlp == split.experts else split.mlp_in(xt)
    s = mlp_apply(params["shared"], xs)
    if split.mlp and split.experts:
        y = split.experts_out(y + s)
    else:
        y = split.experts_out(y) + split.mlp_out(s)
    return y.reshape(B, S, d), aux
