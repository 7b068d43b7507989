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

from repro_torch.kernels.backend import (current_stream_handle,
                                         kernel_library, vector_ok)


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
    if updates.shape != (n, m) or active.shape != (n,) or w.shape != (m,):
        raise ValueError(
            f"shape mismatch: g {tuple(g_old.shape)}, updates "
            f"{tuple(updates.shape)}, active {tuple(active.shape)}, "
            f"w {tuple(w.shape)}")
    if g_old.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"G must be float32 or bfloat16, got {g_old.dtype}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if updates.dtype != torch.float32:
        raise TypeError(f"updates must be float32, got {updates.dtype}")
    if active.dtype != torch.bool:
        raise TypeError(f"active must be bool, got {active.dtype}")
    for name, t in (("g_old", g_old), ("updates", updates),
                    ("active", active), ("w", w)):
        if t.device != g_old.device:
            raise ValueError(f"{name} is on {t.device}, G on {g_old.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = kernel_library("mifa_aggregate")
    fn = lib.mifa_aggregate
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


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
    if g_old.device.type != "cuda":
        raise ValueError(f"no mifa_aggregate for device {g_old.device}")
    n, m = g_old.shape
    w_new = torch.empty_like(w)
    fn = _lib()
    with torch.cuda.device(g_old.device):
        rc = fn(updates.data_ptr(), g_old.data_ptr(), active.data_ptr(),
                w.data_ptr(), w_new.data_ptr(), n, m, float(eta),
                int(g_old.dtype == torch.bfloat16),
                int(w.dtype == torch.bfloat16),
                int(vector_ok(m, g_old, updates)),
                current_stream_handle(g_old.device))
    if rc != 0:
        raise RuntimeError(f"mifa_aggregate launch failed: CUDA error {rc}")
    mifa_aggregate.launches += 1
    return g_old, w_new


mifa_aggregate.launches = 0
