// Fused memory-bank row gather / delta / scatter for Hopper (sm_90a), for
// one bank and for K stacked banks (a fleet of K trials), every leaf of a
// parameter tree in one launch (leaf_table.cuh, scatter_tree.cuh).
//
// The entry `bank_scatter` replaces the TPU kernel
// repro/kernels/bank_scatter.py (_kernel and its pallas_call in
// _bank_scatter); `bank_scatter_batched` replaces `_kernel_batched`
// (pallas_call in `_bank_scatter_batched`). For a bank (R, M) in the bank
// dtype, the cohort's updates U (C, M) f32, row ids (C,) and a valid mask
// (C,):
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
// Leaf j has its bank (K, R, M_j), updates (K, C, M_j) and dsum (K, M_j);
// ids and valid (K, C) are shared by the leaves. The single-trial entry is
// the same kernel at K = 1. The grid is (the table's tiles, K): block
// (x, k) stages trial k's valid rows once in shared memory, then keeps
// several rows of loads in flight a thread through a cp.async ring, and
// sums each column in scatter_tree.cuh's fixed order: no atomics, dsum the
// same on every run, each trial bit-equal to the single-trial entry on its
// slice and to the paged kernels.
//
// What bounds it: bytes. It moves 3 * (valid slots over all trials) * M
// elements (read the old row, read the update, write the new row) over the
// tree's M, plus K * M for dsum, with one subtract and one add per element
// moved in, far below the card's f32 flops/byte balance. Pad slots are
// skipped before any load and the bank is never copied: untouched rows
// cost nothing whatever N is. The kernel masks the ragged column edge
// itself; the caller pads nothing (the TPU wrapper pads wide leaves, which
// copies the bank). It allocates nothing: the wrapper hands each leaf a
// view of one dsum buffer.
#include "scatter_tree.cuh"

namespace {

using repro::FlatRows;
using repro::LeafTable;
using repro::TX;
using repro::TY;
namespace st = repro::scatter_tree;

// Leaf pointers: ptr[0] banks (K, r, M), ptr[1] updates (K, c, M) f32,
// ptr[2] dsum (K, M) f32. Block (x, k): flat tile x of the table's leaves,
// trial k.
__global__ void __launch_bounds__(st::THREADS, st::MIN_BLOCKS)
bank_scatter_kernel(const __grid_constant__ LeafTable table,
                    const int64_t* __restrict__ ids,
                    const uint8_t* __restrict__ valid, int c, int64_t r) {
  const int64_t k = blockIdx.y;
  st::scatter_tile(table, FlatRows{ids + k * c}, valid + k * c, c, r);
}

int launch(const LeafTable* table, const void* ids, const void* valid, int k,
           int c, int64_t r, void* stream) {
  static const cudaError_t carveout =
      st::max_shared_carveout(bank_scatter_kernel);
  if (carveout != cudaSuccess) return int(carveout);
  const dim3 grid(unsigned(table->n_tiles), unsigned(k));
  bank_scatter_kernel<<<grid, dim3(TX, TY), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      *table, static_cast<const int64_t*>(ids),
      static_cast<const uint8_t*>(valid), c, r);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. The table (ptr[0] banks,
// ptr[1] updates, ptr[2] dsum, per-leaf dtype and vector flags) is copied
// into the launch's parameters. Each returns cudaGetLastError() after its
// launch.

// One bank: ids and valid (c,), shared by the leaves.
extern "C" int bank_scatter(const LeafTable* table, const void* ids,
                            const void* valid, int c, void* stream) {
  return launch(table, ids, valid, 1, c, 0, stream);
}

// K trials: ids and valid (k, c), shared by the leaves, and r rows a trial
// in every leaf's banks.
extern "C" int bank_scatter_batched(const LeafTable* table, const void* ids,
                                    const void* valid, int k, int c,
                                    int64_t r, void* stream) {
  return launch(table, ids, valid, k, c, r, stream);
}
