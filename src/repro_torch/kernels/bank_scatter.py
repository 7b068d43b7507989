"""Fused memory-bank row gather / delta / scatter: the CUDA kernels'
wrappers and their plain versions, for one bank and for K stacked banks.

    dsum = Σ_{valid a} (cast(u_a) − bank[ids[a]]);   bank[ids[a]] = cast(u_a)

`bank_scatter` and `bank_scatter_batched` decide by the tensors' device:
CUDA tensors launch the hand-written kernels of `csrc/bank_scatter.cu`
(which replace the TPU kernels `repro/kernels/bank_scatter.py::bank_scatter`
and `bank_scatter_batched`), CPU tensors take the `_ref` versions. On the
card the banks are updated in place and returned; callers must not reuse
the banks they passed in. `bank_scatter_leaves` and
`bank_scatter_batched_leaves` take every leaf of a tree at once (one launch
a tree, for one bank or all K trials, on a leaf table), `bank_scatter` and
`bank_scatter_batched` one leaf. Both kernels sum a trial's rows in the
order of `csrc/scatter_tree.cuh`, so the batched kernel is per trial and
leaf bit-equal to the single-trial one, and both are bit-equal to
`bank_scatter_ordered_ref`, which repeats that order with tensor adds. The
paged scatter and gather are in `kernels.paged_bank`.
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


# row groups of a scatter block (csrc/common.cuh TY): a block sums slot a
# of the cohort in row group a % ROW_GROUPS
ROW_GROUPS = 8


def bank_scatter_ordered_ref(bank: torch.Tensor, updates: torch.Tensor,
                             ids: torch.Tensor, valid: torch.Tensor):
    """`bank_scatter_ref` with dsum summed in the kernels' order
    (`csrc/scatter_tree.cuh`) by elementwise f32 tensor adds: acc_g from
    0 over the valid slots a ≡ g (mod 8) in increasing a, then
    0 + acc_0 + … + acc_7. The CUDA kernels' dsum is bit-equal to it;
    it shares no code with them."""
    new_bank, _ = bank_scatter_ref(bank, updates, ids, valid)
    terms = updates.to(bank.dtype).float() - bank[ids].float()
    m = bank.shape[1]
    acc = [torch.zeros(m, dtype=torch.float32, device=bank.device)
           for _ in range(ROW_GROUPS)]
    for a in torch.nonzero(valid).flatten().tolist():
        acc[a % ROW_GROUPS] = acc[a % ROW_GROUPS] + terms[a]
    dsum = torch.zeros(m, dtype=torch.float32, device=bank.device)
    for g in range(ROW_GROUPS):
        dsum = dsum + acc[g]
    return new_bank, dsum


def check_scatter_leaves(banks, updates, what: str, cohort: dict, *,
                         fleet: bool):
    """The scatters' input rules: banks[j] (R, M_j) and updates[j]
    (C, M_j) for one bank, or with `fleet` (K, R, M_j) and (K, C, M_j) for
    K trials, with K, R and C the same in every leaf, and the cohort
    tensors (name -> (tensor, allowed dtypes)) all (C,) or (K, C). Returns
    (K, R, C), K = 1 for one bank."""
    if not len(banks) == len(updates) > 0:
        raise ValueError(f"{len(banks)} {what} and {len(updates)} update "
                         "leaves: expected the same number, at least one")
    nd, dims = (3, "K, ") if fleet else (2, "")
    for b, u in zip(banks, updates):
        if b.ndim != nd or u.ndim != nd:
            raise ValueError(f"{what} ({dims}R, M) and updates ({dims}C, M) "
                             f"expected, got {tuple(b.shape)}, "
                             f"{tuple(u.shape)}")
        if 0 in b.shape or 0 in u.shape:
            raise ValueError(f"empty scatter: {what} {tuple(b.shape)}, "
                             f"updates {tuple(u.shape)}")
    lead, (r, _), c = banks[0].shape[:-2], banks[0].shape[-2:], \
        updates[0].shape[-2]
    dev = banks[0].device
    for b, u in zip(banks, updates):
        m = b.shape[-1]
        check_tensors(dev, {what: (b, FLOAT_STORES, (*lead, r, m)),
                            "updates": (u, (torch.float32,), (*lead, c, m))})
    check_tensors(dev, {name: (t, dtypes, (*lead, c))
                        for name, (t, dtypes) in cohort.items()})
    return (lead[0] if fleet else 1), r, c


def launch_scatter_leaves(fn, counted, banks, updates, *args):
    """Launch the scatter `fn` once per table of leaves: each leaf's
    pointers (bank, updates, dsum), width and flags in the table, then
    `args` (the cohort tensors' pointers and sizes). Counts the launches on
    `counted`. Returns the dsums, (M_j,) or (K, M_j) f32 views of one
    buffer as the banks are (R, M_j) or (K, R, M_j), each leaf's at an
    offset that is a multiple of 4 elements."""
    lead = tuple(banks[0].shape[:-2])
    k = lead[0] if lead else 1
    if k > 65535:
        raise ValueError(f"{k} trials exceed one launch's grid")
    dev = banks[0].device
    widths = [b.shape[-1] for b in banks]
    offsets = [0]
    for m in widths:
        offsets.append(offsets[-1] + -(-k * m // 4) * 4)
    buf = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    dsums = [buf[o:o + k * m].view(*lead, m) for o, m in zip(offsets, widths)]
    leaves = [((b.data_ptr(), u.data_ptr(), d.data_ptr()), m,
               (A_BF16 if b.dtype == torch.bfloat16 else 0)
               | (VECTOR if vector_ok(m, b, u) else 0))
              for b, u, d, m in zip(banks, updates, dsums, widths)]
    for table in pack(leaves):
        launch(fn, dev, ctypes.addressof(table), *args)
        counted.launches += 1
    return dsums


def bank_scatter_leaves(banks, updates, ids: torch.Tensor,
                        valid: torch.Tensor):
    """The cohort scatter over the leaves of a tree: banks[j] (R, M_j)
    f32|bf16 (leaves may mix the two, R the same for all), updates[j]
    (C, M_j) f32, one ids (C,) int64 of rows < R, distinct among valid
    slots (pad slots may all alias a dummy row), and one valid (C,) bool
    for all. The caller checks the ids on the host.

    Returns (new_banks, dsums), lists in leaf order, dsums[j] (M_j,) f32.
    CPU tensors take the plain version leaf by leaf. CUDA tensors launch
    the kernel once per table of up to `leaf_table.MAX_LEAVES` leaves,
    which writes the valid rows of each bank in place (new_banks[j] is
    banks[j]); the dsums are views of one f32 buffer.
    """
    check_scatter_leaves(banks, updates, "bank",
                         {"ids": (ids, (torch.int64,)),
                          "valid": (valid, (torch.bool,))}, fleet=False)
    dev = ids.device
    if dev.type == "cpu":
        outs = [bank_scatter_ref(b, u, ids, valid)
                for b, u in zip(banks, updates)]
        return [o[0] for o in outs], [o[1] for o in outs]
    fn = entry_point("bank_scatter", "bank_scatter",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int], dev)
    return list(banks), launch_scatter_leaves(
        fn, bank_scatter, banks, updates, ids.data_ptr(), valid.data_ptr(),
        ids.shape[0])


def bank_scatter(bank: torch.Tensor, updates: torch.Tensor,
                 ids: torch.Tensor, valid: torch.Tensor):
    """bank (R, M) f32|bf16; updates (C, M) f32; ids (C,) int64; valid
    (C,) bool, as `bank_scatter_leaves` takes them.

    Returns (new_bank, dsum (M,) f32): `bank_scatter_leaves` on one leaf.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which writes the valid rows of `bank` in place (new_bank is bank).
    """
    new, dsums = bank_scatter_leaves([bank], [updates], ids, valid)
    return new[0], dsums[0]


bank_scatter.launches = 0


def bank_scatter_batched_leaves(banks, updates, ids: torch.Tensor,
                                valid: torch.Tensor):
    """The K-trial scatter over the leaves of a tree: banks[j] (K, R, M_j)
    f32|bf16 (leaves may mix the two, R the same for all), updates[j]
    (K, C, M_j) f32, one ids (K, C) int64 and one valid (K, C) bool for all,
    per trial as `bank_scatter_leaves` takes them.

    Returns (new_banks, dsums), lists in leaf order, dsums[j] (K, M_j) f32.
    CPU tensors take the plain version leaf by leaf. CUDA tensors launch
    the kernel once per table of up to `leaf_table.MAX_LEAVES` leaves for
    all K trials, which writes the valid rows of each bank in place
    (new_banks[j] is banks[j]); the dsums are views of one f32 buffer.
    """
    k, r, c = check_scatter_leaves(
        banks, updates, "banks", {"ids": (ids, (torch.int64,)),
                                  "valid": (valid, (torch.bool,))},
        fleet=True)
    dev = ids.device
    if dev.type == "cpu":
        outs = [bank_scatter_batched_ref(b, u, ids, valid)
                for b, u in zip(banks, updates)]
        return [o[0] for o in outs], [o[1] for o in outs]
    fn = entry_point("bank_scatter", "bank_scatter_batched",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int64], dev)
    return list(banks), launch_scatter_leaves(
        fn, bank_scatter_batched, banks, updates, ids.data_ptr(),
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
