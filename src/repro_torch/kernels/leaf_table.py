"""The leaf table: one kernel launch over every leaf of a tree.

Mirrors `csrc/leaf_table.cuh`. Each leaf of a launch gets a row: its
pointers, its width M, its element-type flags and vector flag, and its first
128-column tile in the launch's flat grid. The table goes to the kernel by
value as a kernel parameter (no copy to the card, so a launch can be
captured in a CUDA graph). A tree with more than `MAX_LEAVES` leaves packs
into several tables, one launch each.
"""
from __future__ import annotations

import ctypes

COLS_PER_TILE = 128      # repro::COLS_PER_BLOCK: the columns of one block
MAX_LEAVES = 64          # repro::MAX_LEAVES
# Leaf.flags bits, as in leaf_table.cuh
A_BF16, W_BF16, VECTOR = 1, 2, 4


class Leaf(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p * 4), ("m", ctypes.c_int64),
                ("first_tile", ctypes.c_int32), ("flags", ctypes.c_int32)]


class LeafTable(ctypes.Structure):
    _fields_ = [("n_leaves", ctypes.c_int32), ("n_tiles", ctypes.c_int32),
                ("leaf", Leaf * MAX_LEAVES)]


assert ctypes.sizeof(Leaf) == 48 and ctypes.sizeof(LeafTable) == 3080


def n_tiles(m: int) -> int:
    """128-column tiles of a leaf of width m (the last one ragged)."""
    return -(-m // COLS_PER_TILE)


def pack(leaves) -> list[LeafTable]:
    """leaves: a sequence of (pointers, m, flags), pointers at most 4 ints
    in the order the kernel reads them. Returns one table per MAX_LEAVES
    leaves, in leaf order."""
    tables = []
    for start in range(0, len(leaves), MAX_LEAVES):
        table, tile = LeafTable(), 0
        chunk = leaves[start:start + MAX_LEAVES]
        for row, (ptrs, m, flags) in zip(table.leaf, chunk):
            if m <= 0:
                raise ValueError(f"leaf of width {m}: every leaf needs a "
                                 "column")
            row.ptr[:len(ptrs)] = ptrs
            row.m, row.first_tile, row.flags = m, tile, flags
            tile += n_tiles(m)
        if tile >= 2 ** 31:
            raise ValueError(f"{tile} tiles exceed one launch's grid")
        table.n_leaves, table.n_tiles = len(chunk), tile
        tables.append(table)
    return tables


def find_leaf(table: LeafTable, tile: int) -> int:
    """The leaf that holds flat tile `tile`: the kernel's search
    (`repro::find_leaf`), for the tests."""
    lo, hi = 0, table.n_leaves - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if table.leaf[mid].first_tile <= tile:
            lo = mid
        else:
            hi = mid - 1
    return lo
