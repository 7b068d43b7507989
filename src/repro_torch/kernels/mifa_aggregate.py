"""Fused MIFA server step: the CUDA kernel's wrappers and its plain version.

    G <- where(active, U, G);   w_new <- w - eta * mean_N(G)   (mean in f32)

`mifa_aggregate_leaves` takes every leaf of a tree at once and
`mifa_aggregate` one leaf (the counterpart of the JAX function). Both decide
by the tensors' device: CUDA tensors launch the hand-written kernel
`csrc/mifa_aggregate.cu` (which replaces the TPU kernel
`repro/kernels/mifa_aggregate.py`) once per leaf table, i.e. once for a
tree of up to 64 leaves; CPU tensors take `mifa_aggregate_ref` leaf by leaf.
On the card G is updated in place and returned; as with the reference's
donated buffers, callers must not reuse the G they passed in. `eta` is a
Python float or a 0-d f32 tensor on the tensors' device; the kernel reads
it from the card, so a CUDA graph that captures the call reads each
round's rate.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.backend import (FLOAT_STORES, check_tensors,
                                         entry_point, launch, vector_ok)
from repro_torch.kernels.leaf_table import A_BF16, VECTOR, W_BF16, pack


def mifa_aggregate_ref(g_old: torch.Tensor, updates: torch.Tensor,
                       active: torch.Tensor, w: torch.Tensor, eta):
    """Plain version: g_old,u (N,M); active (N,); w (M,).
    Returns (g_new (N,M) [g_old.dtype], w_new (M,) [w.dtype])."""
    act = active.reshape(-1, 1).bool()
    g_new = torch.where(act, updates.to(g_old.dtype), g_old)
    mean_g = g_new.float().mean(0)
    w_new = (w.float() - eta * mean_g).to(w.dtype)
    return g_new, w_new


def _check(g_old, updates, active, w) -> None:
    if g_old.ndim != 2:
        raise ValueError(f"g_old must be (N, M), got {tuple(g_old.shape)}")
    n, m = g_old.shape
    if n == 0 or m == 0:
        raise ValueError(f"empty aggregation {(n, m)}")
    check_tensors(active.device, {
        "g_old": (g_old, FLOAT_STORES, (n, m)),
        "updates": (updates, (torch.float32,), (n, m)),
        "active": (active, (torch.bool,), (n,)),
        "w": (w, FLOAT_STORES, (m,))})


def _eta_on(eta, device: torch.device) -> torch.Tensor:
    """eta as a 0-d f32 tensor on `device` (a fill kernel for a float, so
    a capture of the call stays legal)."""
    if isinstance(eta, torch.Tensor):
        check_tensors(device, {"eta": (eta, (torch.float32,), ())})
        return eta
    return torch.full((), float(eta), dtype=torch.float32, device=device)


def mifa_aggregate_leaves(gs, us, active: torch.Tensor, ws, eta):
    """The server step over the leaves of a tree: gs[j] (N, M_j) f32|bf16,
    us[j] (N, M_j) f32, ws[j] (M_j,) f32|bf16, one active (N,) bool for
    all; eta a Python float or a 0-d f32 tensor on active's device. Leaves
    may mix f32 and bf16.

    Returns (g_news, w_news), lists in leaf order. CPU tensors take the
    plain version leaf by leaf; CUDA tensors launch the kernel once per
    table of up to `leaf_table.MAX_LEAVES` leaves, which writes the active
    rows of each g in place (g_new is g) and each w_new into a fresh
    tensor.
    """
    if not len(gs) == len(us) == len(ws) > 0:
        raise ValueError(f"{len(gs)} G, {len(us)} U and {len(ws)} w leaves:"
                         " expected the same number, at least one")
    for g, u, w in zip(gs, us, ws):
        _check(g, u, active, w)
    if active.device.type == "cpu":
        outs = [mifa_aggregate_ref(g, u, active, w, eta)
                for g, u, w in zip(gs, us, ws)]
        return [o[0] for o in outs], [o[1] for o in outs]
    fn = entry_point("mifa_aggregate", "mifa_aggregate",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p], active.device)
    eta = _eta_on(eta, active.device)
    w_news = [torch.empty_like(w) for w in ws]
    leaves = [((u.data_ptr(), g.data_ptr(), w.data_ptr(), wn.data_ptr()),
               g.shape[1],
               (A_BF16 if g.dtype == torch.bfloat16 else 0)
               | (W_BF16 if w.dtype == torch.bfloat16 else 0)
               | (VECTOR if vector_ok(g.shape[1], g, u) else 0))
              for g, u, w, wn in zip(gs, us, ws, w_news)]
    for table in pack(leaves):
        launch(fn, active.device, ctypes.addressof(table),
               active.data_ptr(), active.shape[0], eta.data_ptr())
        mifa_aggregate.launches += 1
    return list(gs), w_news


def mifa_aggregate(g_old: torch.Tensor, updates: torch.Tensor,
                   active: torch.Tensor, w: torch.Tensor, eta):
    """g_old (N,M) f32|bf16; updates (N,M) f32; active (N,) bool;
    w (M,) f32|bf16; eta a Python float or a 0-d f32 tensor.

    Returns (g_new, w_new): `mifa_aggregate_leaves` on one leaf. CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    writes the active rows of g_old in place (g_new is g_old) and w_new
    into a fresh tensor.
    """
    gs, ws = mifa_aggregate_leaves([g_old], [updates], active, [w], eta)
    return gs[0], ws[0]


mifa_aggregate.launches = 0
