"""Fused memory-bank row gather / delta / scatter: the CUDA kernels'
wrappers and their plain versions, for one bank and for K stacked banks.

    dsum = Σ_{valid a} (cast(u_a) − bank[ids[a]]);   bank[ids[a]] = cast(u_a)

`bank_scatter` and `bank_scatter_batched` decide by the tensors' device:
CUDA tensors launch the hand-written kernels of `csrc/bank_scatter.cu`
(which replace the TPU kernels `repro/kernels/bank_scatter.py::bank_scatter`
and `bank_scatter_batched`), CPU tensors take the `_ref` versions. On the
card the banks are updated in place and returned; callers must not reuse
the banks they passed in. `bank_scatter_batched_leaves` takes every leaf of
a tree at once (one launch a tree for all K trials, on a leaf table), and
`bank_scatter_batched` one leaf. The batched kernel sums trial k's rows in
the single-trial kernel's order, so per trial and leaf it is bit-equal to
it. The paged scatter and gather are in `kernels.paged_bank`; the kernels
share their sums (`csrc/scatter_rows.cuh`, `csrc/scatter_tree.cuh`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.backend import (FLOAT_STORES, check_tensors,
                                         entry_point, launch, vector_ok)
from repro_torch.kernels.leaf_table import A_BF16, VECTOR, pack


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


def check_fleet_leaves(banks, updates, what: str, cohort: dict):
    """The fleet scatters' input rules: banks[j] (K, R, M_j) and
    updates[j] (K, C, M_j), with K, R and C the same in every leaf, and the
    cohort tensors (name -> (tensor, allowed dtypes)) all (K, C). Returns
    (K, R, C)."""
    if not len(banks) == len(updates) > 0:
        raise ValueError(f"{len(banks)} {what} and {len(updates)} update "
                         "leaves: expected the same number, at least one")
    for b, u in zip(banks, updates):
        if b.ndim != 3 or u.ndim != 3:
            raise ValueError(f"{what} (K, R, M) and updates (K, C, M) "
                             f"expected, got {tuple(b.shape)}, "
                             f"{tuple(u.shape)}")
        if 0 in b.shape or 0 in u.shape:
            raise ValueError(f"empty scatter: {what} {tuple(b.shape)}, "
                             f"updates {tuple(u.shape)}")
    (k, r, _), c = banks[0].shape, updates[0].shape[1]
    dev = banks[0].device
    for b, u in zip(banks, updates):
        m = b.shape[2]
        check_tensors(dev, {what: (b, FLOAT_STORES, (k, r, m)),
                            "updates": (u, (torch.float32,), (k, c, m))})
    check_tensors(dev, {name: (t, dtypes, (k, c))
                        for name, (t, dtypes) in cohort.items()})
    return k, r, c


def launch_fleet_scatter(fn, counted, banks, updates, k: int, *args):
    """Launch the fleet scatter `fn` once per table of leaves: each leaf's
    pointers (bank, updates, dsum), width and flags in the table, then
    `args` (the cohort tensors' pointers and sizes). Counts the launches on
    `counted`. Returns the dsums, (K, M_j) f32 views of one buffer, each
    leaf's at an offset that is a multiple of 4 elements."""
    if k > 65535:
        raise ValueError(f"{k} trials exceed one launch's grid")
    dev = banks[0].device
    widths = [b.shape[2] for b in banks]
    offsets = [0]
    for m in widths:
        offsets.append(offsets[-1] + -(-k * m // 4) * 4)
    buf = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    dsums = [buf[o:o + k * m].view(k, m) for o, m in zip(offsets, widths)]
    leaves = [((b.data_ptr(), u.data_ptr(), d.data_ptr()), m,
               (A_BF16 if b.dtype == torch.bfloat16 else 0)
               | (VECTOR if vector_ok(m, b, u) else 0))
              for b, u, d, m in zip(banks, updates, dsums, widths)]
    for table in pack(leaves):
        launch(fn, dev, ctypes.addressof(table), *args)
        counted.launches += 1
    return dsums


def bank_scatter_batched_leaves(banks, updates, ids: torch.Tensor,
                                valid: torch.Tensor):
    """The K-trial scatter over the leaves of a tree: banks[j] (K, R, M_j)
    f32|bf16 (leaves may mix the two, R the same for all), updates[j]
    (K, C, M_j) f32, one ids (K, C) int64 and one valid (K, C) bool for all,
    per trial as `bank_scatter` takes them.

    Returns (new_banks, dsums), lists in leaf order, dsums[j] (K, M_j) f32.
    CPU tensors take the plain version leaf by leaf. CUDA tensors launch
    the kernel once per table of up to `leaf_table.MAX_LEAVES` leaves for
    all K trials, which writes the valid rows of each bank in place
    (new_banks[j] is banks[j]); the dsums are views of one f32 buffer.
    """
    k, r, c = check_fleet_leaves(
        banks, updates, "banks", {"ids": (ids, (torch.int64,)),
                                  "valid": (valid, (torch.bool,))})
    dev = ids.device
    if dev.type == "cpu":
        outs = [bank_scatter_batched_ref(b, u, ids, valid)
                for b, u in zip(banks, updates)]
        return [o[0] for o in outs], [o[1] for o in outs]
    fn = entry_point("bank_scatter", "bank_scatter_batched",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int64], dev)
    return list(banks), launch_fleet_scatter(
        fn, bank_scatter_batched, banks, updates, k, ids.data_ptr(),
        valid.data_ptr(), k, c, r)


def bank_scatter_batched(banks: torch.Tensor, updates: torch.Tensor,
                         ids: torch.Tensor, valid: torch.Tensor):
    """banks (K, R, M) f32|bf16; updates (K, C, M) f32; ids (K, C) int64,
    per trial as `bank_scatter` takes them; valid (K, C) bool.

    Returns (new_banks, dsum (K, M) f32): `bank_scatter_batched_leaves` on
    one leaf. CPU tensors take the plain version; CUDA tensors launch the
    kernel once for all K trials, which writes the valid rows of `banks`
    in place (new_banks is banks).
    """
    new, dsums = bank_scatter_batched_leaves([banks], [updates], ids, valid)
    return new[0], dsums[0]


bank_scatter_batched.launches = 0
