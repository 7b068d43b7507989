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
// paged_scatter_kernel replaces repro/kernels/bank_scatter.py
// `_paged_kernel` (pallas_call in `_paged_bank_scatter`): for every valid
// slot a, old = pages[phys(lids[a])], dsum += cast(U[a]) - old (f32), and
// the row is written in place. It is `bank_scatter_kernel` with a different
// row address: the body is `scatter_rows.cuh`, so the two sum the same
// cohort rows in the same order and a paged bank's G_sum is bit-equal to a
// dense bank's. Bound by bytes: 3 * |A_valid| * M elements, as
// bank_scatter.
//
// paged_scatter_batched_kernel replaces `_paged_kernel_batched` (pallas_call
// in `_paged_bank_scatter_batched`): the paged scatter for K trials, every
// leaf of a parameter tree in one launch (leaf_table.cuh,
// scatter_tree.cuh). Leaf j has its page pools (K, R, M_j), updates
// (K, C, M_j) and dsum (K, M_j); the per-trial page tables (K, P), lids and
// valid (K, C) are shared by the leaves. The grid is (the table's tiles,
// K): block (x, k) resolves trial k's valid rows once, through row k of the
// page table, into shared memory, then walks them with several rows of
// loads in flight a thread. The sums are `scatter_rows.cuh`'s, so trial
// k's pages and dsum are bit-equal to `paged_scatter_kernel` on its slice,
// and to the dense batched kernel's. Bound by bytes, as the flat one.
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
#include "leaf_table.cuh"
#include "scatter_rows.cuh"
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

template <typename TB, bool VECTOR>
__global__ void __launch_bounds__(TX * TY)
paged_scatter_kernel(TB* __restrict__ pages, const float* __restrict__ u,
                     const int32_t* __restrict__ pt,
                     const int32_t* __restrict__ lids,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ dsum, int c, int64_t m, int ps) {
  repro::scatter_rows<TB, VECTOR>(pages, u, PagedRows{pt, lids, ps}, valid,
                                  dsum, c, m);
}

// Leaf pointers: ptr[0] pages (K, r, M), ptr[1] updates (K, c, M) f32,
// ptr[2] dsum (K, M) f32. Block (x, k): flat tile x of the table's leaves,
// trial k, through row k of the (K, p) page table.
__global__ void __launch_bounds__(st::THREADS, st::MIN_BLOCKS)
paged_scatter_batched_kernel(const __grid_constant__ LeafTable table,
                             const int32_t* __restrict__ pt,
                             const int32_t* __restrict__ lids,
                             const uint8_t* __restrict__ valid, int c,
                             int64_t r, int p, int ps) {
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

dim3 tiles(int64_t m) {
  return dim3(unsigned((m + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK));
}

template <typename TB>
void launch_scatter(void* pages, const void* u, const void* pt,
                    const void* lids, const void* valid, void* dsum, int c,
                    int64_t m, int ps, bool vector, cudaStream_t stream) {
  auto* pp = static_cast<TB*>(pages);
  auto* uu = static_cast<const float*>(u);
  auto* tt = static_cast<const int32_t*>(pt);
  auto* ll = static_cast<const int32_t*>(lids);
  auto* vv = static_cast<const uint8_t*>(valid);
  auto* ds = static_cast<float*>(dsum);
  if (vector) {
    paged_scatter_kernel<TB, true><<<tiles(m), dim3(TX, TY), 0, stream>>>(
        pp, uu, tt, ll, vv, ds, c, m, ps);
  } else {
    paged_scatter_kernel<TB, false><<<tiles(m), dim3(TX, TY), 0, stream>>>(
        pp, uu, tt, ll, vv, ds, c, m, ps);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. pages_bf16 selects the pages'
// element type (0: f32, 1: bf16); vector selects the 4-wide variant, which
// needs m % 4 == 0 and aligned pointers (the wrapper checks). Each returns
// cudaGetLastError() after its launch.
extern "C" int paged_bank_scatter(void* pages, const void* u, const void* pt,
                                  const void* lids, const void* valid,
                                  void* dsum, int c, int64_t m, int ps,
                                  int pages_bf16, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vector != 0;
  if (pages_bf16)
    launch_scatter<__nv_bfloat16>(pages, u, pt, lids, valid, dsum, c, m, ps,
                                  vec, s);
  else
    launch_scatter<float>(pages, u, pt, lids, valid, dsum, c, m, ps, vec, s);
  return int(cudaGetLastError());
}

// The K-trial scatter over every leaf of `table` (ptr[0] pages, ptr[1]
// updates, ptr[2] dsum): page tables pt (k, p), lids and valid (k, c),
// shared by the leaves, and r rows a trial in every leaf's pool. The table
// is copied into the launch's parameters. Returns cudaGetLastError() after
// the launch.
extern "C" int paged_bank_scatter_batched(const LeafTable* table,
                                          const void* pt, const void* lids,
                                          const void* valid, int k, int c,
                                          int64_t r, int p, int ps,
                                          void* stream) {
  static const cudaError_t carveout =
      st::max_shared_carveout(paged_scatter_batched_kernel);
  if (carveout != cudaSuccess) return int(carveout);
  const dim3 grid(unsigned(table->n_tiles), unsigned(k));
  paged_scatter_batched_kernel<<<grid, dim3(TX, TY), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      *table, static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(lids), static_cast<const uint8_t*>(valid),
      c, r, p, ps);
  return int(cudaGetLastError());
}

// The row gather over every leaf of `table` (ptr[0] pages, ptr[1] out):
// pt (P,) and lids (c,) int32 are shared by the leaves. The table is copied
// into the launch's parameters. Returns cudaGetLastError() after the launch.
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
