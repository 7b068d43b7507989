// Fused memory-bank row gather / delta / scatter for Hopper (sm_90a), for
// one bank and for K stacked banks (a fleet of K trials).
//
// bank_scatter_kernel replaces the TPU kernel repro/kernels/bank_scatter.py
// (_kernel and its pallas_call in _bank_scatter). For a bank (R, M) in the
// bank dtype, the
// cohort's updates U (C, M) f32, row ids (C,) and a valid mask (C,):
//
//     for every valid slot a:
//         old = bank[ids[a]];  u_st = cast(U[a])  (to the bank dtype)
//         dsum += u_st - old   (in f32)
//         bank[ids[a]] = u_st  (in place)
//
// Invalid (pad) slots contribute nothing and leave their row as it was; all
// of them may alias the dummy row N. The delta uses the value as stored, so
// G_sum stays the exact sum of the rows for bf16 banks too. Valid ids must
// be distinct (the caller checks on the host), which makes the row writes
// independent.
//
// What bounds it: bytes. It moves 3 * |A_valid| * M elements (read the old
// row, read the update, write the new row) plus M for dsum, with one
// subtract and one add per element moved in — far below the card's f32
// flops/byte balance — so the least time is that traffic over 3.35 TB/s.
//
// What the design does about it (the body is `scatter_rows.cuh`, shared
// with the paged kernel so both sum in the same order):
//   * A block owns a tile of 128 columns and walks the cohort rows inside
//     the block, standing in for the TPU kernel's sequential inner grid
//     axis. Rows are split over TY row groups (row a goes to group a % TY,
//     each group in increasing a), and the groups' f32 partial sums are
//     added in a fixed order through shared memory: dsum is the same on
//     every run. There are no atomics across cohort rows.
//   * Pad slots are skipped before any load, so the traffic is that of the
//     valid rows only, and the bank is never copied: untouched rows cost
//     nothing whatever N is.
//   * A warp reads 128 consecutive columns of a row with 16-byte (f32) or
//     8-byte (bf16) vector loads. The kernel masks the ragged column edge
//     itself; the caller pads nothing (the TPU wrapper pads wide leaves,
//     which copies the bank).
//   * It allocates nothing: the wrapper allocates dsum with torch.empty.
//
// bank_scatter_batched_kernel replaces `_kernel_batched` (pallas_call in
// `_bank_scatter_batched`): the same work for K trials, every leaf of a
// parameter tree in one launch (leaf_table.cuh, scatter_tree.cuh). Leaf j
// has its banks (K, R, M_j), updates (K, C, M_j) and dsum (K, M_j); ids
// and valid (K, C) are shared by the leaves. The grid is (the table's
// tiles, K): block (x, k) stages trial k's valid rows once in shared
// memory, then keeps several rows of loads in flight a thread through a
// cp.async ring. Trial k sums the same rows in the same order as
// `bank_scatter_kernel` on its slice, so its rows and dsum are bit-equal
// to the single-trial kernel's. Bound by bytes: 3 * (valid slots over all
// trials) * M elements over the tree's M, plus K * M for dsum.
#include "scatter_rows.cuh"
#include "scatter_tree.cuh"

namespace {

using repro::COLS_PER_BLOCK;
using repro::FlatRows;
using repro::LeafTable;
using repro::TX;
using repro::TY;
namespace st = repro::scatter_tree;

template <typename TB, bool VECTOR>
__global__ void __launch_bounds__(TX * TY)
bank_scatter_kernel(TB* __restrict__ bank, const float* __restrict__ u,
                    const int64_t* __restrict__ ids,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ dsum, int c, int64_t m) {
  repro::scatter_rows<TB, VECTOR>(bank, u, FlatRows{ids}, valid, dsum, c, m);
}

// Leaf pointers: ptr[0] banks (K, r, M), ptr[1] updates (K, c, M) f32,
// ptr[2] dsum (K, M) f32. Block (x, k): flat tile x of the table's leaves,
// trial k.
__global__ void __launch_bounds__(st::THREADS, st::MIN_BLOCKS)
bank_scatter_batched_kernel(const __grid_constant__ LeafTable table,
                            const int64_t* __restrict__ ids,
                            const uint8_t* __restrict__ valid, int c,
                            int64_t r) {
  const int64_t k = blockIdx.y;
  st::scatter_tile(table, FlatRows{ids + k * c}, valid + k * c, c, r);
}

template <typename TB>
void launch(void* bank, const void* u, const void* ids, const void* valid,
            void* dsum, int c, int64_t m, bool vector, cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid(unsigned((m + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK));
  auto* bb = static_cast<TB*>(bank);
  auto* uu = static_cast<const float*>(u);
  auto* ii = static_cast<const int64_t*>(ids);
  auto* vv = static_cast<const uint8_t*>(valid);
  auto* ds = static_cast<float*>(dsum);
  if (vector) {
    bank_scatter_kernel<TB, true><<<grid, block, 0, stream>>>(
        bb, uu, ii, vv, ds, c, m);
  } else {
    bank_scatter_kernel<TB, false><<<grid, block, 0, stream>>>(
        bb, uu, ii, vv, ds, c, m);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. bank_bf16 selects the bank's
// element type (0: f32, 1: bf16); vector selects the 4-wide variant, which
// needs m % 4 == 0 and aligned pointers (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int bank_scatter(void* bank, const void* u, const void* ids,
                            const void* valid, void* dsum, int c, int64_t m,
                            int bank_bf16, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vector != 0;
  if (bank_bf16)
    launch<__nv_bfloat16>(bank, u, ids, valid, dsum, c, m, vec, s);
  else
    launch<float>(bank, u, ids, valid, dsum, c, m, vec, s);
  return int(cudaGetLastError());
}

// The K-trial scatter over every leaf of `table` (ptr[0] banks, ptr[1]
// updates, ptr[2] dsum): ids and valid (k, c), shared by the leaves, and r
// rows a trial in every leaf's banks. The table is copied into the
// launch's parameters. Returns cudaGetLastError() after the launch.
extern "C" int bank_scatter_batched(const LeafTable* table, const void* ids,
                                    const void* valid, int k, int c,
                                    int64_t r, void* stream) {
  static const cudaError_t carveout =
      st::max_shared_carveout(bank_scatter_batched_kernel);
  if (carveout != cudaSuccess) return int(carveout);
  const dim3 grid(unsigned(table->n_tiles), unsigned(k));
  bank_scatter_batched_kernel<<<grid, dim3(TX, TY), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      *table, static_cast<const int64_t*>(ids),
      static_cast<const uint8_t*>(valid), c, r);
  return int(cudaGetLastError());
}
