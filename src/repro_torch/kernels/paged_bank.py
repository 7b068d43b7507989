"""Paged memory-bank kernels: the cohort gather / delta / scatter (for one
page pool and for K stacked pools) and the row gather through a page
table, each the CUDA kernel's wrapper beside its plain version.

    phys(lid) = page_table[lid // page_size] * page_size + lid % page_size
    paged_bank_scatter:  dsum = Σ_{valid a} (cast(u_a) − pages[phys(lids[a])])
                         pages[phys(lids[a])] = cast(u_a)   (valid a only),
                         and `paged_bank_scatter_leaves` for every leaf of
                         a tree in one launch
    paged_bank_gather:   rows[a] = f32(pages[phys(lids[a])]), and
                         `paged_bank_gather_leaves` for every leaf of a
                         tree in one launch
    paged_bank_scatter_batched: the scatter for trial k = 0..K-1 through
                         row k of a (K, P) page table, in one launch, and
                         `paged_bank_scatter_batched_leaves` for every leaf
                         of a tree in one launch

The wrappers decide by the tensors' device: CUDA tensors launch the
hand-written kernels of `csrc/paged_bank.cu` (which replace the TPU kernels
`repro/kernels/bank_scatter.py::paged_bank_scatter`,
`paged_bank_scatter_batched` and `paged_bank_gather`), CPU tensors take the
`_ref` versions. On the card the
scatter updates the pages in place and returns them; callers must not reuse
the pages they passed in. `lids` are sanitized logical rows: the caller has
remapped pad slots to the dummy logical page, and a logical page that is not
resident maps to the dummy slot through the page table. The scatters are
`bank_scatter.cu`'s with another row address, so they sum in the same order
(`paged_bank_scatter_ordered_ref`) and a paged bank's G_sum is bit-equal to
a dense bank's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.backend import (FLOAT_STORES, check_tensors,
                                         entry_point, launch, vector_ok)
from repro_torch.kernels.bank_scatter import (bank_scatter_ordered_ref,
                                              bank_scatter_ref,
                                              check_scatter_leaves,
                                              launch_scatter_leaves)
from repro_torch.kernels.leaf_table import A_BF16, VECTOR, pack

# slots a gather block resolves and copies (csrc/paged_bank.cu GATHER_ROWS);
# a launch takes at most 65535 such chunks
GATHER_ROWS = 64


def phys_rows(page_table: torch.Tensor, lids: torch.Tensor,
              page_size: int) -> torch.Tensor:
    """Physical rows (int64) of the logical rows `lids`."""
    return (page_table[lids // page_size].long() * page_size
            + lids % page_size)


def paged_bank_scatter_ref(pages: torch.Tensor, updates: torch.Tensor,
                           page_table: torch.Tensor, lids: torch.Tensor,
                           valid: torch.Tensor, *, page_size: int):
    """Plain version: `bank_scatter_ref` on the physically addressed rows
    (the reference's `_scatter_pure` fp body). Returns (new_pages (R, M)
    [pages.dtype], dsum (M,) f32)."""
    return bank_scatter_ref(pages, updates,
                            phys_rows(page_table, lids, page_size), valid)


def paged_bank_scatter_ordered_ref(pages: torch.Tensor,
                                   updates: torch.Tensor,
                                   page_table: torch.Tensor,
                                   lids: torch.Tensor, valid: torch.Tensor, *,
                                   page_size: int):
    """`bank_scatter_ordered_ref` on the physically addressed rows: dsum in
    the kernels' order, by tensor adds."""
    return bank_scatter_ordered_ref(pages, updates,
                                    phys_rows(page_table, lids, page_size),
                                    valid)


def paged_bank_scatter_batched_ref(pages: torch.Tensor, updates: torch.Tensor,
                                   page_table: torch.Tensor,
                                   lids: torch.Tensor, valid: torch.Tensor, *,
                                   page_size: int):
    """Plain version: `paged_bank_scatter_ref` on each trial. pages
    (K, R, M); updates (K, C, M); page_table (K, P); lids, valid (K, C).
    Returns (new_pages (K, R, M), dsum (K, M) f32)."""
    out = [paged_bank_scatter_ref(p, u, t, i, v, page_size=page_size)
           for p, u, t, i, v in zip(pages, updates, page_table, lids, valid)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def paged_bank_gather_ref(pages: torch.Tensor, page_table: torch.Tensor,
                          lids: torch.Tensor, *, page_size: int):
    """Plain version: (C, M) f32 rows for `lids`."""
    return pages[phys_rows(page_table, lids, page_size)].float()


def _check_gather(pages, page_table, lids, page_size) -> None:
    """The gather's input rules."""
    if page_size <= 0 or page_size & (page_size - 1):
        raise ValueError(f"page_size must be a power of two, got {page_size}")
    if pages.ndim != 2 or pages.shape[0] % page_size or 0 in pages.shape:
        raise ValueError(f"pages must be (R, M) with R a multiple of "
                         f"page_size={page_size}, got {tuple(pages.shape)}")
    c = lids.shape[0] if lids.ndim == 1 else -1
    if c <= 0 or page_table.ndim != 1:
        raise ValueError(f"lids (C,) with C > 0 and page_table (P,) "
                         f"expected, got {tuple(lids.shape)}, "
                         f"{tuple(page_table.shape)}")
    check_tensors(pages.device, {
        "pages": (pages, FLOAT_STORES, pages.shape),
        "page_table": (page_table, (torch.int32,), page_table.shape),
        "lids": (lids, (torch.int32,), (c,))})


def _check_scatter(pages, updates, page_table, lids, valid, page_size, *,
                   fleet: bool):
    """The paged scatters' input rules: `check_scatter_leaves` on the pools
    and the cohort, R a multiple of the power-of-two page_size, and one
    page table (P,), or (K, P) with `fleet`. Returns (K, R, C)."""
    if page_size <= 0 or page_size & (page_size - 1):
        raise ValueError(f"page_size must be a power of two, got {page_size}")
    k, r, c = check_scatter_leaves(
        pages, updates, "pages", {"lids": (lids, (torch.int32,)),
                                  "valid": (valid, (torch.bool,))},
        fleet=fleet)
    if r % page_size:
        raise ValueError(f"pages with R a multiple of page_size={page_size} "
                         f"expected, got R={r}")
    lead, dims = ((k,), "(K, P)") if fleet else ((), "(P,)")
    if page_table.ndim != len(lead) + 1:
        raise ValueError(f"page_table {dims} expected, got "
                         f"{tuple(page_table.shape)}")
    check_tensors(lids.device, {"page_table": (
        page_table, (torch.int32,), (*lead, page_table.shape[-1]))})
    return k, r, c


def paged_bank_scatter_leaves(pages, updates, page_table: torch.Tensor,
                              lids: torch.Tensor, valid: torch.Tensor, *,
                              page_size: int):
    """The cohort scatter through a page table over the leaves of a tree:
    pages[j] (R, M_j) f32|bf16 (leaves may mix the two; R =
    (slots+1)·page_size, the same for all), updates[j] (C, M_j) f32, one
    page_table (P,) int32, one lids (C,) int32 of sanitized logical rows,
    distinct among valid slots, and one valid (C,) bool for all. The caller
    checks on the host that every valid row's page is resident.

    Returns (new_pages, dsums), lists in leaf order, dsums[j] (M_j,) f32.
    CPU tensors take the plain version leaf by leaf. CUDA tensors launch
    the kernel once per table of up to `leaf_table.MAX_LEAVES` leaves,
    which writes the valid rows of each pool in place (new_pages[j] is
    pages[j]); the dsums are views of one f32 buffer.
    """
    _, _, c = _check_scatter(pages, updates, page_table, lids, valid,
                             page_size, fleet=False)
    dev = lids.device
    if dev.type == "cpu":
        outs = [paged_bank_scatter_ref(p, u, page_table, lids, valid,
                                       page_size=page_size)
                for p, u in zip(pages, updates)]
        return [o[0] for o in outs], [o[1] for o in outs]
    fn = entry_point("paged_bank", "paged_bank_scatter",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int],
                     dev)
    return list(pages), launch_scatter_leaves(
        fn, paged_bank_scatter, pages, updates, page_table.data_ptr(),
        lids.data_ptr(), valid.data_ptr(), c, page_size)


def paged_bank_scatter(pages: torch.Tensor, updates: torch.Tensor,
                       page_table: torch.Tensor, lids: torch.Tensor,
                       valid: torch.Tensor, *, page_size: int):
    """pages (R, M) f32|bf16; updates (C, M) f32; page_table (P,) int32;
    lids (C,) int32; valid (C,) bool, as `paged_bank_scatter_leaves` takes
    them.

    Returns (new_pages, dsum (M,) f32): `paged_bank_scatter_leaves` on one
    leaf. CPU tensors take the plain version; CUDA tensors launch the
    kernel, which writes the valid rows of `pages` in place (new_pages is
    pages).
    """
    new, dsums = paged_bank_scatter_leaves([pages], [updates], page_table,
                                           lids, valid, page_size=page_size)
    return new[0], dsums[0]


def paged_bank_gather_leaves(pages_list, page_table: torch.Tensor,
                             lids: torch.Tensor, *, page_size: int) -> list:
    """The row gather over the leaves of a tree: pages_list[j] (R, M_j)
    f32|bf16 (leaves may mix the two), one page_table (P,) int32 and one
    lids (C,) int32 of sanitized logical rows for all. Returns a list of
    (C, M_j) f32 rows in leaf order (rows of pages that are not resident
    read the dummy page's zeros).

    CPU tensors take the plain version leaf by leaf. CUDA tensors launch
    the kernel once per table of up to `leaf_table.MAX_LEAVES` leaves; the
    rows of all leaves land in one f32 buffer, each leaf's at an offset
    that is a multiple of 4 elements, and come back as contiguous views of
    it.
    """
    if not pages_list:
        raise ValueError("no leaves to gather")
    for pages in pages_list:
        _check_gather(pages, page_table, lids, page_size)
    dev = lids.device
    if dev.type == "cpu":
        return [paged_bank_gather_ref(pages, page_table, lids,
                                      page_size=page_size)
                for pages in pages_list]
    fn = entry_point("paged_bank", "paged_bank_gather",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int],
                     dev)
    c = lids.shape[0]
    if -(-c // GATHER_ROWS) > 65535:
        raise ValueError(f"{c} rows exceed one launch's grid")
    widths = [pages.shape[1] for pages in pages_list]
    offsets = [0]
    for m in widths:
        offsets.append(offsets[-1] + -(-c * m // 4) * 4)
    buf = torch.empty(offsets[-1], dtype=torch.float32, device=dev)
    outs = [buf[o:o + c * m].view(c, m) for o, m in zip(offsets, widths)]
    leaves = [((pages.data_ptr(), out.data_ptr()), m,
               (A_BF16 if pages.dtype == torch.bfloat16 else 0)
               | (VECTOR if vector_ok(m, pages, out) else 0))
              for pages, out, m in zip(pages_list, outs, widths)]
    for table in pack(leaves):
        launch(fn, dev, ctypes.addressof(table), page_table.data_ptr(),
               lids.data_ptr(), c, page_size)
        paged_bank_gather.launches += 1
    return outs


def paged_bank_gather(pages: torch.Tensor, page_table: torch.Tensor,
                      lids: torch.Tensor, *, page_size: int) -> torch.Tensor:
    """pages (R, M) f32|bf16; page_table (P,) int32; lids (C,) int32
    sanitized logical rows. Returns (C, M) f32 rows (rows of pages that are
    not resident read the dummy page's zeros): `paged_bank_gather_leaves`
    on one leaf. CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    return paged_bank_gather_leaves([pages], page_table, lids,
                                    page_size=page_size)[0]


def paged_bank_scatter_batched_leaves(pages, updates,
                                      page_table: torch.Tensor,
                                      lids: torch.Tensor, valid: torch.Tensor,
                                      *, page_size: int):
    """The K-trial paged scatter over the leaves of a tree: pages[j]
    (K, R, M_j) f32|bf16 (leaves may mix the two; R = (slots+1)·page_size,
    the same for all), updates[j] (K, C, M_j) f32, one page_table (K, P)
    int32 (a table per trial) and one lids (K, C) int32 and valid (K, C)
    bool for all, per trial as `paged_bank_scatter` takes them.

    Returns (new_pages, dsums), lists in leaf order, dsums[j] (K, M_j) f32.
    CPU tensors take the plain version leaf by leaf. CUDA tensors launch
    the kernel once per table of up to `leaf_table.MAX_LEAVES` leaves for
    all K trials, which writes the valid rows of each pool in place
    (new_pages[j] is pages[j]); the dsums are views of one f32 buffer.
    """
    k, r, c = _check_scatter(pages, updates, page_table, lids, valid,
                             page_size, fleet=True)
    dev = lids.device
    if dev.type == "cpu":
        outs = [paged_bank_scatter_batched_ref(p, u, page_table, lids, valid,
                                               page_size=page_size)
                for p, u in zip(pages, updates)]
        return [o[0] for o in outs], [o[1] for o in outs]
    fn = entry_point("paged_bank", "paged_bank_scatter_batched",
                     [ctypes.c_void_p] * 4
                     + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_int, ctypes.c_int], dev)
    return list(pages), launch_scatter_leaves(
        fn, paged_bank_scatter_batched, pages, updates,
        page_table.data_ptr(), lids.data_ptr(), valid.data_ptr(), k, c, r,
        page_table.shape[1], page_size)


def paged_bank_scatter_batched(pages: torch.Tensor, updates: torch.Tensor,
                               page_table: torch.Tensor, lids: torch.Tensor,
                               valid: torch.Tensor, *, page_size: int):
    """pages (K, R, M) f32|bf16; updates (K, C, M) f32; page_table (K, P)
    int32 (the fleet keeps identical per-trial copies); lids (K, C) int32
    and valid (K, C) bool, per trial as `paged_bank_scatter` takes them.

    Returns (new_pages, dsum (K, M) f32):
    `paged_bank_scatter_batched_leaves` on one leaf. CPU tensors take the
    plain version; CUDA tensors launch the kernel once for all K trials,
    which writes the valid rows of `pages` in place (new_pages is pages).
    """
    new, dsums = paged_bank_scatter_batched_leaves(
        [pages], [updates], page_table, lids, valid, page_size=page_size)
    return new[0], dsums[0]


paged_bank_scatter.launches = 0
paged_bank_scatter_batched.launches = 0
paged_bank_gather.launches = 0
