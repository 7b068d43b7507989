// The cohort scatter over a whole parameter tree, shared by
// `bank_scatter.cu` (flat rows) and `paged_bank.cu` (rows behind a page
// table), for one bank and for K stacked banks (a fleet of K trials): one
// launch covers every leaf of a tree (leaf_table.cuh) and all K trials.
// Block (x, k) takes flat tile x of the table's leaves for trial k:
// paper_mlp's tree is 397 blocks at K = 1 and 397 x 3 at K = 3 (2.3 waves
// at four blocks an SM). (Walking a block's trials one after another, in
// one wave, was slower: a narrow tile's chain grew threefold.)
//
//     for every valid slot a of trial k (row group a % 8, each group in
//     increasing a from 0.f):
//         r = row_of(a);  old = bank_k[r];  u_st = cast(U_k[a])  (bank dtype)
//         acc += u_st - old   (f32);   bank_k[r] = u_st   (in place)
//     dsum_k[col] = 0.f + acc of row group 0 + ... + acc of row group 7
//
// This file is the home of that order. Only the row address differs
// between the flat and the paged kernels, and the single-trial kernels are
// the fleet kernels at K = 1, so all four sum a trial's rows in the same
// order: a paged bank's G_sum is bit-equal to a dense bank's, whatever
// slot a page occupies, and every trial of a fleet to the single-trial
// kernel. How a tile's columns are spread over its threads moves no sum.
// `kernels/bank_scatter.py::bank_scatter_ordered_ref` repeats the order
// with tensor adds, apart from this code.
//
// What the design does about the per-leaf kernels' costs:
//   * One launch a tree. paper_mlp's four narrow leaves (widths 128, 128,
//     10, 1280) no longer pay a launch and a block's fixed chain each.
//   * Rows resolved once a block. Row group ty (one warp) stages its own
//     slots ty, ty + 8, ... in shared memory before any row copy, one lane
//     a slot, TX slots a pass: the valid flag, and only for a valid slot
//     its row (for the paged kernel lid -> page table -> physical row).
//     The warp compacts the valid ones with a ballot, in increasing a, so
//     pad slots cost no load and the walk has no branch on them. The lists
//     are the warp's own, so no block barrier stands between staging and
//     the walk.
//   * Bytes in flight without registers. On the 4-wide walk each thread
//     copies its rows' old segment and update segment into its own slots
//     of a shared-memory ring with cp.async, STAGES x STAGE_ROWS rows ahead
//     of the row it adds and stores; a thread reads back only its own
//     slots, so the ring needs no barrier. A row's new values are stored
//     once its loads have landed; valid rows are distinct, so a store never
//     races another row's load. At most 64 registers a thread, so four
//     blocks fit an SM.
//   * Mixed trees. Element types and the vector path are per-leaf flags
//     (a block branches once on them); a ragged or unaligned leaf takes a
//     scalar walk with UNROLL_SCALAR rows of loads in flight and a warp on
//     32 consecutive columns.
//   * Nothing is allocated: the wrapper hands each leaf a (K, M) view of
//     one dsum buffer. The bank itself checks residency on its host mirror
//     before a paged scatter; the kernel does not.
#pragma once

#include "leaf_table.cuh"

namespace repro {

// Rows addressed directly: the row of slot a is ids[a].
struct FlatRows {
  const int64_t* ids;
  __device__ __forceinline__ int64_t operator()(int a) const { return ids[a]; }
};

// Rows addressed through a page table: logical row lid lives at physical
// row pt[lid / ps] * ps + lid % ps.
struct PagedRows {
  const int32_t* pt;
  const int32_t* lids;
  int ps;
  __device__ __forceinline__ int64_t operator()(int a) const {
    const int32_t lid = lids[a];
    return int64_t(pt[lid / ps]) * ps + lid % ps;
  }
};

namespace scatter_tree {

constexpr int ROW_GROUPS = TY;            // row groups (warps) of a block
constexpr int THREADS = TX * ROW_GROUPS;
constexpr int MIN_BLOCKS = 4;             // blocks an SM (64 registers)
constexpr int STAGE_ROWS = 2;             // rows a thread copies a ring stage
constexpr int STAGES = 2;                 // ring stages a thread has in flight
constexpr int RING = STAGES * STAGE_ROWS;
constexpr int UNROLL_SCALAR = 2;          // rows in flight on the scalar walk
constexpr int PASS_SLOTS = TX * ROW_GROUPS;  // slots staged a pass, one a lane

// a block's shared memory
struct Smem {
  uint4 old_ring[RING][THREADS];  // the old row segments (bf16: 8 bytes)
  uint4 u_ring[RING][THREADS];    // the update segments (f32)
  int64_t row[ROW_GROUPS][TX];   // a group's valid rows of a pass, then
  int32_t slot[ROW_GROUPS][TX];  // their slots, increasing
  float partial[ROW_GROUPS][COLS_PER_BLOCK];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a thread's 4 columns of a row into its 16-byte ring slot: 16 bytes of
// f32 (an update, or an f32 bank row) or 8 bytes of a bf16 bank row
__device__ __forceinline__ void cp_async(uint4* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async(uint4* dst,
                                         const __nv_bfloat16* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Row group ty's valid slots among base + ty + 8*lane into its lists, in
// increasing order; returns how many. Every lane of the warp calls it (the
// ballot needs them all).
template <typename RowOf>
__device__ __forceinline__ int stage_group(RowOf row_of,
                                           const uint8_t* __restrict__ valid,
                                           int c, int base, int64_t* rows,
                                           int32_t* slots) {
  const int lane = threadIdx.x;
  const int a = base + threadIdx.y + ROW_GROUPS * lane;
  const bool v = a < c && valid[a] != 0;
  const unsigned mask = __ballot_sync(0xffffffffu, v);
  if (v) {
    const int at = __popc(mask & ((1u << lane) - 1u));
    rows[at] = row_of(a);
    slots[at] = a;
  }
  __syncwarp();
  return __popc(mask);
}

// The 4-wide walk (m % 4 == 0, aligned rows) over the group's n staged
// rows: thread (tx, ty) owns columns col .. col + 3 and copies its rows
// into its own ring slots, STAGE_ROWS a stage, STAGES stages ahead.
template <typename TB>
__device__ __forceinline__ void walk_vector(TB* __restrict__ bank,
                                            const float* __restrict__ u,
                                            const int64_t* rows,
                                            const int32_t* slots, int n,
                                            int64_t m, int64_t col,
                                            Smem& sm, float acc[VEC]) {
  if (col >= m) return;  // m % 4 == 0: a thread's 4 columns are all in or out
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int chunks = (n + STAGE_ROWS - 1) / STAGE_ROWS;
  auto issue = [&](int chunk) {
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k) {
      const int q = chunk * STAGE_ROWS + k;
      if (q < n) {
        const int s = (chunk % STAGES) * STAGE_ROWS + k;
        cp_async(&sm.old_ring[s][tid], bank + rows[q] * m + col);
        cp_async(&sm.u_ring[s][tid], u + int64_t(slots[q]) * m + col);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int c = 0; c < STAGES; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 1>();  // chunk c has landed
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k) {
      const int q = c * STAGE_ROWS + k;
      if (q < n) {
        const int s = (c % STAGES) * STAGE_ROWS + k;
        float old[VEC], v[VEC];
        load4(reinterpret_cast<const TB*>(&sm.old_ring[s][tid]), old);
        load4(reinterpret_cast<const float*>(&sm.u_ring[s][tid]), v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          v[j] = round_to<TB>(v[j]);
          acc[j] += v[j] - old[j];
        }
        store4(bank + rows[q] * m + col, v);
      }
    }
    issue(c + STAGES);  // into the slots just read
  }
  cp_async_wait<0>();
}

// The scalar walk (a ragged or unaligned leaf): thread tx owns columns
// tile_col0 + j*TX + tx, j < VEC, UNROLL_SCALAR rows at a time: first the
// loads, then the adds and the stores.
template <typename TB>
__device__ __forceinline__ void walk_scalar(TB* __restrict__ bank,
                                            const float* __restrict__ u,
                                            const int64_t* rows,
                                            const int32_t* slots, int n,
                                            int64_t m, int64_t tile_col0,
                                            float acc[VEC]) {
  const int tx = threadIdx.x;
  for (int q0 = 0; q0 < n; q0 += UNROLL_SCALAR) {
    float old[UNROLL_SCALAR][VEC], v[UNROLL_SCALAR][VEC];
#pragma unroll
    for (int k = 0; k < UNROLL_SCALAR; ++k) {
      const int q = q0 + k;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int64_t col = tile_col0 + j * TX + tx;
        if (q < n && col < m) {
          old[k][j] = to_f32(bank[rows[q] * m + col]);
          v[k][j] = u[int64_t(slots[q]) * m + col];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL_SCALAR; ++k) {
      const int q = q0 + k;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int64_t col = tile_col0 + j * TX + tx;
        if (q < n && col < m) {
          const TB s = from_f32<TB>(v[k][j]);
          acc[j] += to_f32(s) - old[k][j];
          bank[rows[q] * m + col] = s;
        }
      }
    }
  }
}

template <typename TB>
__device__ __forceinline__ void walk_leaf(const Leaf& leaf, bool vector,
                                          int64_t k, int c, int64_t r,
                                          const int64_t* rows,
                                          const int32_t* slots, int n,
                                          int64_t tile_col0, Smem& sm,
                                          float acc[VEC]) {
  const int64_t m = leaf.m;
  TB* bank = static_cast<TB*>(leaf.ptr[0]) + k * r * m;
  const float* u = static_cast<const float*>(leaf.ptr[1]) + k * c * m;
  if (vector)
    walk_vector<TB>(bank, u, rows, slots, n, m,
                    tile_col0 + threadIdx.x * VEC, sm, acc);
  else
    walk_scalar<TB>(bank, u, rows, slots, n, m, tile_col0, acc);
}

// The whole block: leaf pointers ptr[0] the bank (K, r, M), ptr[1] the
// updates (K, c, M) f32, ptr[2] dsum (K, M) f32; row_of and valid already
// point at trial k = blockIdx.y.
template <typename RowOf>
__device__ __forceinline__ void scatter_tile(const LeafTable& table,
                                             RowOf row_of,
                                             const uint8_t* __restrict__ valid,
                                             int c, int64_t r) {
  __shared__ Smem sm;
  const Leaf& leaf = table.leaf[find_leaf(table, blockIdx.x)];
  const int64_t k = blockIdx.y;
  const int64_t tile_col0 =
      int64_t(blockIdx.x - leaf.first_tile) * COLS_PER_BLOCK;
  const bool vector = (leaf.flags & LEAF_VECTOR) != 0;
  const bool bf16 = (leaf.flags & LEAF_A_BF16) != 0;
  const int ty = threadIdx.y;
  int64_t* rows = sm.row[ty];
  int32_t* slots = sm.slot[ty];

  float acc[VEC] = {0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < c; base += PASS_SLOTS) {
    __syncwarp();  // the group's lanes are done with the previous pass
    const int n = stage_group(row_of, valid, c, base, rows, slots);
    if (bf16)
      walk_leaf<__nv_bfloat16>(leaf, vector, k, c, r, rows, slots, n,
                               tile_col0, sm, acc);
    else
      walk_leaf<float>(leaf, vector, k, c, r, rows, slots, n, tile_col0, sm,
                       acc);
  }

  // partial[y][p] is row group y's sum of column tile_col0 + p
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    sm.partial[ty][vector ? threadIdx.x * VEC + j : j * TX + threadIdx.x] =
        acc[j];
  __syncthreads();
  const int tid = ty * TX + threadIdx.x;
  const int64_t col = tile_col0 + tid;
  if (tid < COLS_PER_BLOCK && col < leaf.m) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < ROW_GROUPS; ++y) s += sm.partial[y][tid];
    static_cast<float*>(leaf.ptr[2])[k * leaf.m + col] = s;
  }
}

// Four blocks an SM need more shared memory than the default carveout
// leaves: ask for the largest once per kernel.
template <typename Kernel>
__host__ cudaError_t max_shared_carveout(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

}  // namespace scatter_tree
}  // namespace repro
