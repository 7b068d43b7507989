"""Fused memory-bank row gather / delta / scatter: the CUDA kernels'
wrappers and their plain versions, for one bank and for K stacked banks.

    dsum = Σ_{valid a} (cast(u_a) − bank[ids[a]]);   bank[ids[a]] = cast(u_a)

`bank_scatter` and `bank_scatter_batched` decide by the tensors' device:
CUDA tensors launch the hand-written kernels of `csrc/bank_scatter.cu`
(which replace the TPU kernels `repro/kernels/bank_scatter.py::bank_scatter`
and `bank_scatter_batched`), CPU tensors take the `_ref` versions. On the
card the banks are updated in place and returned; callers must not reuse
the banks they passed in. The batched kernel runs trial k through the same
body as the single-trial one, so per trial it is bit-equal to it. The paged
scatter and gather are in `kernels.paged_bank` (the kernel body is shared,
see `csrc/scatter_rows.cuh`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.backend import (FLOAT_STORES, check_tensors,
                                         entry_point, launch, vector_ok)


def bank_scatter_ref(bank: torch.Tensor, updates: torch.Tensor,
                     ids: torch.Tensor, valid: torch.Tensor):
    """Plain version (the reference's `bank/dense.py::_scatter_jnp` body):
    bank (R, M); updates (C, M) f32; ids (C,) int64; valid (C,) bool.
    Returns (new_bank (R, M) [bank.dtype], dsum (M,) f32)."""
    old = bank[ids]                                   # (C, M) bank dtype
    u_st = updates.to(bank.dtype)
    vb = valid.reshape(-1, 1)
    delta = torch.where(vb, u_st.float() - old.float(), 0.0)
    new_bank = bank.clone()
    new_bank[ids] = torch.where(vb, u_st, old)
    return new_bank, delta.sum(0)


def bank_scatter_batched_ref(banks: torch.Tensor, updates: torch.Tensor,
                             ids: torch.Tensor, valid: torch.Tensor):
    """Plain version: `bank_scatter_ref` on each trial (the reference's
    vmapped `_scatter_jnp`). banks (K, R, M); updates (K, C, M); ids, valid
    (K, C). Returns (new_banks (K, R, M), dsum (K, M) f32)."""
    out = [bank_scatter_ref(b, u, i, v)
           for b, u, i, v in zip(banks, updates, ids, valid)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def _check(bank, updates, ids, valid) -> None:
    if bank.ndim != 2 or updates.ndim != 2:
        raise ValueError(f"bank (R, M) and updates (C, M) expected, got "
                         f"{tuple(bank.shape)}, {tuple(updates.shape)}")
    (r, m), c = bank.shape, updates.shape[0]
    if r == 0 or m == 0 or c == 0:
        raise ValueError(f"empty scatter: bank {(r, m)}, cohort {c}")
    check_tensors(bank.device, {
        "bank": (bank, FLOAT_STORES, (r, m)),
        "updates": (updates, (torch.float32,), (c, m)),
        "ids": (ids, (torch.int64,), (c,)),
        "valid": (valid, (torch.bool,), (c,))})


def bank_scatter(bank: torch.Tensor, updates: torch.Tensor,
                 ids: torch.Tensor, valid: torch.Tensor):
    """bank (R, M) f32|bf16; updates (C, M) f32; ids (C,) int64 rows < R,
    distinct among valid slots (pad slots may all alias a dummy row);
    valid (C,) bool. The caller checks the ids on the host.

    Returns (new_bank, dsum (M,) f32). CPU tensors take the plain version;
    CUDA tensors launch the kernel, which writes the valid rows of `bank`
    in place (new_bank is bank) and dsum into a fresh tensor.
    """
    _check(bank, updates, ids, valid)
    if bank.device.type == "cpu":
        return bank_scatter_ref(bank, updates, ids, valid)
    fn = entry_point("bank_scatter", "bank_scatter",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int64,
                                              ctypes.c_int, ctypes.c_int],
                     bank.device)
    c, m = updates.shape
    dsum = torch.empty(m, dtype=torch.float32, device=bank.device)
    launch(fn, bank.device, bank.data_ptr(), updates.data_ptr(),
           ids.data_ptr(), valid.data_ptr(), dsum.data_ptr(), c, m,
           int(bank.dtype == torch.bfloat16), int(vector_ok(m, bank, updates)))
    bank_scatter.launches += 1
    return bank, dsum


bank_scatter.launches = 0


def bank_scatter_batched(banks: torch.Tensor, updates: torch.Tensor,
                         ids: torch.Tensor, valid: torch.Tensor):
    """banks (K, R, M) f32|bf16; updates (K, C, M) f32; ids (K, C) int64,
    per trial as `bank_scatter` takes them; valid (K, C) bool.

    Returns (new_banks, dsum (K, M) f32). CPU tensors take the plain
    version; CUDA tensors launch the kernel once for all K trials, which
    writes the valid rows of `banks` in place (new_banks is banks).
    """
    if banks.ndim != 3 or updates.ndim != 3:
        raise ValueError(f"banks (K, R, M) and updates (K, C, M) expected, "
                         f"got {tuple(banks.shape)}, {tuple(updates.shape)}")
    (k, r, m), c = banks.shape, updates.shape[1]
    if 0 in (k, r, m, c):
        raise ValueError(f"empty scatter: banks {(k, r, m)}, cohort {c}")
    check_tensors(banks.device, {
        "banks": (banks, FLOAT_STORES, (k, r, m)),
        "updates": (updates, (torch.float32,), (k, c, m)),
        "ids": (ids, (torch.int64,), (k, c)),
        "valid": (valid, (torch.bool,), (k, c))})
    if banks.device.type == "cpu":
        return bank_scatter_batched_ref(banks, updates, ids, valid)
    fn = entry_point("bank_scatter", "bank_scatter_batched",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int64, ctypes.c_int64,
                                              ctypes.c_int, ctypes.c_int],
                     banks.device)
    dsum = torch.empty((k, m), dtype=torch.float32, device=banks.device)
    launch(fn, banks.device, banks.data_ptr(), updates.data_ptr(),
           ids.data_ptr(), valid.data_ptr(), dsum.data_ptr(), k, c, m, r,
           int(banks.dtype == torch.bfloat16),
           int(vector_ok(m, banks, updates)))
    bank_scatter_batched.launches += 1
    return banks, dsum


bank_scatter_batched.launches = 0
