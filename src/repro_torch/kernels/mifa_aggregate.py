"""Fused MIFA server step: the CUDA kernel's wrapper and its plain version.

    G <- where(active, U, G);   w_new <- w - eta * mean_N(G)   (mean in f32)

`mifa_aggregate` decides by the tensors' device: CUDA tensors launch the
hand-written kernel `csrc/mifa_aggregate.cu` (which replaces the TPU kernel
`repro/kernels/mifa_aggregate.py`), CPU tensors take `mifa_aggregate_ref`.
On the card G is updated in place and returned; as with the reference's
donated buffers, callers must not reuse the G they passed in.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.backend import (FLOAT_STORES, check_tensors,
                                         entry_point, launch, vector_ok)


def mifa_aggregate_ref(g_old: torch.Tensor, updates: torch.Tensor,
                       active: torch.Tensor, w: torch.Tensor, eta: float):
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
    check_tensors(g_old.device, {
        "g_old": (g_old, FLOAT_STORES, (n, m)),
        "updates": (updates, (torch.float32,), (n, m)),
        "active": (active, (torch.bool,), (n,)),
        "w": (w, FLOAT_STORES, (m,))})


def mifa_aggregate(g_old: torch.Tensor, updates: torch.Tensor,
                   active: torch.Tensor, w: torch.Tensor, eta: float):
    """g_old (N,M) f32|bf16; updates (N,M) f32; active (N,) bool;
    w (M,) f32|bf16; eta a Python float.

    Returns (g_new, w_new). CPU tensors take the plain version; CUDA
    tensors launch the kernel, which writes the active rows of g_old in
    place (g_new is g_old) and w_new into a fresh tensor.
    """
    _check(g_old, updates, active, w)
    if g_old.device.type == "cpu":
        return mifa_aggregate_ref(g_old, updates, active, w, eta)
    vp = ctypes.c_void_p
    fn = entry_point("mifa_aggregate", "mifa_aggregate",
                     [vp] * 5 + [ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int],
                     g_old.device)
    n, m = g_old.shape
    w_new = torch.empty_like(w)
    launch(fn, g_old.device, updates.data_ptr(), g_old.data_ptr(),
           active.data_ptr(), w.data_ptr(), w_new.data_ptr(), n, m,
           float(eta), int(g_old.dtype == torch.bfloat16),
           int(w.dtype == torch.bfloat16), int(vector_ok(m, g_old, updates)))
    mifa_aggregate.launches += 1
    return g_old, w_new


mifa_aggregate.launches = 0
