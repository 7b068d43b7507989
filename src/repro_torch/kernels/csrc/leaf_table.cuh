// The leaf table: one kernel launch over every leaf of a parameter tree.
//
// A tree's leaves have different widths M and may mix f32 and bf16 storage.
// The per-leaf kernels of the first port launched once per leaf, and on
// paper_mlp's narrow leaves (widths down to 10) the launch and its fixed
// cost were most of the time. A leaf table lists the leaves of one launch;
// the launch's flat grid covers every leaf's 128-column tiles back to back,
// and a block finds its leaf by a binary search over the leaves' first
// tiles.
//
// The table is passed BY VALUE as a __grid_constant__ kernel parameter: no
// host-to-device copy, so a launch stays capturable in a CUDA graph, and the
// kernel reads the entries in place from the parameter bank (uniform across
// the block, so the constant cache broadcasts them). MAX_LEAVES keeps the
// table under the classic 4 KB parameter limit with room for a kernel's
// other arguments; the wrapper splits a longer tree over several launches.
//
// `kernels/leaf_table.py` packs the same layout with ctypes.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int MAX_LEAVES = 64;

// Leaf::flags bits
constexpr int LEAF_A_BF16 = 1;  // the leaf's stored rows (G, pages) are bf16
constexpr int LEAF_W_BF16 = 2;  // its weights w (and w_new) are bf16
constexpr int LEAF_VECTOR = 4;  // m % 4 == 0 and rows aligned for 4-wide access

struct Leaf {
  // the kernel's pointers for this leaf, in the order its source names them
  void* ptr[4];
  int64_t m;           // width (columns)
  int32_t first_tile;  // the leaf's first tile in the launch's flat tile index
  int32_t flags;
};

struct LeafTable {
  int32_t n_leaves;  // 1..MAX_LEAVES
  int32_t n_tiles;   // the launch's tiles: the last leaf's first tile + its tiles
  Leaf leaf[MAX_LEAVES];
};

static_assert(sizeof(Leaf) == 48, "Leaf layout differs from leaf_table.py");
static_assert(sizeof(LeafTable) == 3080,
              "LeafTable layout differs from leaf_table.py");

// The leaf that holds flat tile `tile`: the last leaf whose first tile is
// <= tile (every leaf has at least one tile, so first tiles increase).
__device__ __forceinline__ int find_leaf(const LeafTable& t, int tile) {
  int lo = 0, hi = t.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first_tile <= tile)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

}  // namespace repro
