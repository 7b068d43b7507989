// The paged memory bank's two kernels for Hopper (sm_90a): the cohort
// gather / delta / scatter and the row gather, both through a page table.
//
// A paged bank keeps (slots + 1) pages of `ps` rows per leaf on the card;
// the last page is the dummy page, pinned to zeros. Logical row lid lives
// at physical row
//
//     phys(lid) = pt[lid / ps] * ps + lid % ps
//
// and a page that is not resident maps to the dummy slot. Both kernels
// resolve phys inside the kernel from the page table and the logical ids
// (the TPU kernels resolve it in their BlockSpec index maps from
// scalar-prefetched tables).
//
// paged_scatter_kernel is the cohort scatter through a page table, for one
// pool and for K stacked pools (a fleet of K trials), every leaf of a
// parameter tree in one launch (leaf_table.cuh, scatter_tree.cuh). The
// entry `paged_bank_scatter` replaces repro/kernels/bank_scatter.py
// `_paged_kernel` (pallas_call in `_paged_bank_scatter`);
// `paged_bank_scatter_batched` replaces `_paged_kernel_batched`
// (pallas_call in `_paged_bank_scatter_batched`). For every valid slot a,
// old = pages[phys(lids[a])], dsum += cast(U[a]) - old (f32), and the row
// is written in place. Leaf j has its page pools (K, R, M_j), updates
// (K, C, M_j) and dsum (K, M_j); the per-trial page tables (K, P), lids
// and valid (K, C) are shared by the leaves, and the single-trial entry is
// the same kernel at K = 1. The grid is (the table's tiles, K): block
// (x, k) resolves trial k's valid rows once, through row k of the page
// table, into shared memory (the lid -> page table -> row chain paid once
// per slot a block), then walks them with several rows of loads in flight
// a thread. It is `bank_scatter.cu`'s kernel with another row address, so
// the sums run in scatter_tree.cuh's order: a paged bank's pages and G_sum
// are bit-equal to a dense bank's, and each trial to the single-trial
// entry. Bound by bytes: 3 * (valid slots over all trials) * M elements,
// as bank_scatter.
//
// paged_gather_kernel replaces `_paged_gather_kernel` (pallas_call in
// `_paged_bank_gather`): out[a] = f32(pages[phys(lids[a])]) for all C
// slots, for every leaf of a tree in one launch (leaf_table.cuh): the
// leaves share the page table and the lids, and each has its own pages,
// width and output. A pure copy with a cast, bound by bytes: C * M *
// (sizeof(page dtype) + 4) over the tree's M. The grid is (every leaf's
// 128-column tiles, chunks of GATHER_ROWS slots). Each block first resolves
// its chunk's physical rows into shared memory, one thread a slot, so the
// lid -> page-table -> row chain is paid once per block and not before each
// copy; then every thread issues the loads of all its rows (16-/8-byte
// vector loads when M % 4 == 0) before its 16-byte stores.
//
// Neither kernel checks residency: the bank checks on its host mirror that
// every valid row's page is resident before a scatter, so a valid row never
// lands in the dummy page. Neither allocates: the wrapper allocates dsum
// and out with torch.empty.
#include "scatter_tree.cuh"

namespace {

using repro::COLS_PER_BLOCK;
using repro::Leaf;
using repro::LeafTable;
using repro::PagedRows;
using repro::TX;
using repro::TY;
using repro::VEC;
namespace st = repro::scatter_tree;

// Leaf pointers: ptr[0] pages (K, r, M), ptr[1] updates (K, c, M) f32,
// ptr[2] dsum (K, M) f32. Block (x, k): flat tile x of the table's leaves,
// trial k, through row k of the (K, p) page table.
__global__ void __launch_bounds__(st::THREADS, st::MIN_BLOCKS)
paged_scatter_kernel(const __grid_constant__ LeafTable table,
                     const int32_t* __restrict__ pt,
                     const int32_t* __restrict__ lids,
                     const uint8_t* __restrict__ valid, int c, int64_t r,
                     int p, int ps) {
  const int64_t k = blockIdx.y;
  st::scatter_tile(table, PagedRows{pt + k * p, lids + k * c, ps},
                   valid + k * c, c, r);
}

constexpr int UNROLL = 8;                   // rows a thread has in flight
constexpr int GATHER_ROWS = TY * UNROLL;    // slots a block resolves and copies

// The block's `rows` slots of one tile of a leaf, their physical rows in
// phys (shared). Row group ty copies slots ty, ty + TY, ...: first every
// load, then every store. VECTOR: thread tx owns columns tile_col0 + 4*tx
// .. +3; otherwise columns tile_col0 + j*TX + tx, j < VEC.
template <typename TB, bool VECTOR>
__device__ __forceinline__ void gather_rows(const TB* __restrict__ pages,
                                            float* __restrict__ out,
                                            const int64_t* phys, int a0,
                                            int rows, int64_t m,
                                            int64_t tile_col0) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  float v[UNROLL][VEC];
  if (VECTOR) {
    const int64_t col = tile_col0 + tx * VEC;
    if (col >= m) return;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = ty + k * TY;
      if (i < rows) repro::load4(pages + phys[i] * m + col, v[k]);
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = ty + k * TY;
      if (i < rows) repro::store4(out + int64_t(a0 + i) * m + col, v[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = ty + k * TY;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int64_t col = tile_col0 + j * TX + tx;
        if (i < rows && col < m)
          v[k][j] = repro::to_f32(pages[phys[i] * m + col]);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = ty + k * TY;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int64_t col = tile_col0 + j * TX + tx;
        if (i < rows && col < m) out[int64_t(a0 + i) * m + col] = v[k][j];
      }
    }
  }
}

template <typename TB>
__device__ __forceinline__ void gather_leaf(const Leaf& leaf,
                                            const int64_t* phys, int a0,
                                            int rows, int64_t tile_col0) {
  const auto* pages = static_cast<const TB*>(leaf.ptr[0]);
  auto* out = static_cast<float*>(leaf.ptr[1]);
  if (leaf.flags & repro::LEAF_VECTOR)
    gather_rows<TB, true>(pages, out, phys, a0, rows, leaf.m, tile_col0);
  else
    gather_rows<TB, false>(pages, out, phys, a0, rows, leaf.m, tile_col0);
}

// Leaf pointers: ptr[0] pages (R, M), ptr[1] out (C, M) f32. Block
// (x, y): flat tile x of the table's leaves, slots y*GATHER_ROWS onwards.
__global__ void __launch_bounds__(TX * TY)
paged_gather_kernel(const __grid_constant__ LeafTable table,
                    const int32_t* __restrict__ pt,
                    const int32_t* __restrict__ lids, int c, int ps) {
  __shared__ int64_t phys[GATHER_ROWS];
  const int a0 = blockIdx.y * GATHER_ROWS;
  const int rows = min(GATHER_ROWS, c - a0);
  const int tid = threadIdx.y * TX + threadIdx.x;
  if (tid < rows) {
    const int32_t lid = lids[a0 + tid];
    phys[tid] = int64_t(pt[lid / ps]) * ps + lid % ps;
  }
  const Leaf& leaf = table.leaf[repro::find_leaf(table, blockIdx.x)];
  const int64_t tile_col0 =
      int64_t(blockIdx.x - leaf.first_tile) * COLS_PER_BLOCK;
  __syncthreads();
  if (leaf.flags & repro::LEAF_A_BF16)
    gather_leaf<__nv_bfloat16>(leaf, phys, a0, rows, tile_col0);
  else
    gather_leaf<float>(leaf, phys, a0, rows, tile_col0);
}

int launch_scatter(const LeafTable* table, const void* pt, const void* lids,
                   const void* valid, int k, int c, int64_t r, int p, int ps,
                   void* stream) {
  static const cudaError_t carveout =
      st::max_shared_carveout(paged_scatter_kernel);
  if (carveout != cudaSuccess) return int(carveout);
  const dim3 grid(unsigned(table->n_tiles), unsigned(k));
  paged_scatter_kernel<<<grid, dim3(TX, TY), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      *table, static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(lids), static_cast<const uint8_t*>(valid),
      c, r, p, ps);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each table is copied into the
// launch's parameters, and each entry returns cudaGetLastError() after its
// launch.

// The scatter for one pool over every leaf of `table` (ptr[0] pages,
// ptr[1] updates, ptr[2] dsum): pt (P,), lids and valid (c,), shared by
// the leaves.
extern "C" int paged_bank_scatter(const LeafTable* table, const void* pt,
                                  const void* lids, const void* valid, int c,
                                  int ps, void* stream) {
  return launch_scatter(table, pt, lids, valid, 1, c, 0, 0, ps, stream);
}

// The K-trial scatter over every leaf of `table`: page tables pt (k, p),
// lids and valid (k, c), shared by the leaves, and r rows a trial in every
// leaf's pool.
extern "C" int paged_bank_scatter_batched(const LeafTable* table,
                                          const void* pt, const void* lids,
                                          const void* valid, int k, int c,
                                          int64_t r, int p, int ps,
                                          void* stream) {
  return launch_scatter(table, pt, lids, valid, k, c, r, p, ps, stream);
}

// The row gather over every leaf of `table` (ptr[0] pages, ptr[1] out):
// pt (P,) and lids (c,) int32 are shared by the leaves.
extern "C" int paged_bank_gather(const LeafTable* table, const void* pt,
                                 const void* lids, int c, int ps,
                                 void* stream) {
  const dim3 grid(unsigned(table->n_tiles),
                  unsigned((c + GATHER_ROWS - 1) / GATHER_ROWS));
  paged_gather_kernel<<<grid, dim3(TX, TY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      *table, static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(lids), c, ps);
  return int(cudaGetLastError());
}
