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
// in `_paged_bank_scatter_batched`): the paged scatter for K stacked page
// pools (K, R, M) with per-trial page tables (K, P), lids and valid (K, C)
// and dsum (K, M), in one launch. The grid is (column tiles, K): block
// (x, k) runs the same `scatter_rows` body through a `PagedRows` functor
// over row k of the page table, so trial k's pages and dsum are bit-equal
// to `paged_scatter_kernel` on its slice. Bound by bytes, as the flat one.
//
// paged_gather_kernel replaces `_paged_gather_kernel` (pallas_call in
// `_paged_bank_gather`): out[a] = f32(pages[phys(lids[a])]) for all C
// slots. A pure copy with a cast, bound by bytes: C * M * (sizeof(page
// dtype) + 4). One block per 128-column tile walks the C rows in TY row
// groups, with 16-/8-byte vector loads and 16-byte stores when M % 4 == 0.
//
// Neither kernel checks residency: the bank checks on its host mirror that
// every valid row's page is resident before a scatter, so a valid row never
// lands in the dummy page. Neither allocates: the wrapper allocates dsum
// and out with torch.empty.
#include "scatter_rows.cuh"

namespace {

using repro::COLS_PER_BLOCK;
using repro::PagedRows;
using repro::TX;
using repro::TY;
using repro::VEC;

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

// Trial k = blockIdx.y of K stacked pools of r rows and tables of p pages.
template <typename TB, bool VECTOR>
__global__ void __launch_bounds__(TX * TY)
paged_scatter_batched_kernel(TB* __restrict__ pages,
                             const float* __restrict__ u,
                             const int32_t* __restrict__ pt,
                             const int32_t* __restrict__ lids,
                             const uint8_t* __restrict__ valid,
                             float* __restrict__ dsum, int c, int64_t m,
                             int ps, int64_t r, int p) {
  const int64_t k = blockIdx.y;
  repro::scatter_rows<TB, VECTOR>(pages + k * r * m, u + k * c * m,
                                  PagedRows{pt + k * p, lids + k * c, ps},
                                  valid + k * c, dsum + k * m, c, m);
}

template <typename TB, bool VECTOR>
__global__ void __launch_bounds__(TX * TY)
paged_gather_kernel(const TB* __restrict__ pages,
                    const int32_t* __restrict__ pt,
                    const int32_t* __restrict__ lids,
                    float* __restrict__ out, int c, int64_t m, int ps) {
  const PagedRows row_of{pt, lids, ps};
  const int64_t col0 = (int64_t(blockIdx.x) * TX + threadIdx.x) * VEC;
  if (VECTOR) {
    if (col0 >= m) return;
    for (int a = threadIdx.y; a < c; a += TY) {
      float v[VEC];
      repro::load4(pages + row_of(a) * m + col0, v);
      repro::store4(out + int64_t(a) * m + col0, v);
    }
  } else {
    for (int a = threadIdx.y; a < c; a += TY) {
      const int64_t r = row_of(a);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int64_t col = col0 + k;
        if (col < m) out[int64_t(a) * m + col] = repro::to_f32(pages[r * m + col]);
      }
    }
  }
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

template <typename TB>
void launch_scatter_batched(void* pages, const void* u, const void* pt,
                            const void* lids, const void* valid, void* dsum,
                            int k, int c, int64_t m, int ps, int64_t r, int p,
                            bool vector, cudaStream_t stream) {
  auto* pp = static_cast<TB*>(pages);
  auto* uu = static_cast<const float*>(u);
  auto* tt = static_cast<const int32_t*>(pt);
  auto* ll = static_cast<const int32_t*>(lids);
  auto* vv = static_cast<const uint8_t*>(valid);
  auto* ds = static_cast<float*>(dsum);
  const dim3 grid(tiles(m).x, unsigned(k));
  if (vector) {
    paged_scatter_batched_kernel<TB, true><<<grid, dim3(TX, TY), 0, stream>>>(
        pp, uu, tt, ll, vv, ds, c, m, ps, r, p);
  } else {
    paged_scatter_batched_kernel<TB, false>
        <<<grid, dim3(TX, TY), 0, stream>>>(pp, uu, tt, ll, vv, ds, c, m, ps,
                                            r, p);
  }
}

template <typename TB>
void launch_gather(const void* pages, const void* pt, const void* lids,
                   void* out, int c, int64_t m, int ps, bool vector,
                   cudaStream_t stream) {
  auto* pp = static_cast<const TB*>(pages);
  auto* tt = static_cast<const int32_t*>(pt);
  auto* ll = static_cast<const int32_t*>(lids);
  auto* oo = static_cast<float*>(out);
  if (vector) {
    paged_gather_kernel<TB, true><<<tiles(m), dim3(TX, TY), 0, stream>>>(
        pp, tt, ll, oo, c, m, ps);
  } else {
    paged_gather_kernel<TB, false><<<tiles(m), dim3(TX, TY), 0, stream>>>(
        pp, tt, ll, oo, c, m, ps);
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

// The K-trial scatter: pages (K, R, M), u (K, C, M), pt (K, P), lids and
// valid (K, C), dsum (K, M); the other arguments as paged_bank_scatter's.
extern "C" int paged_bank_scatter_batched(void* pages, const void* u,
                                          const void* pt, const void* lids,
                                          const void* valid, void* dsum,
                                          int k, int c, int64_t m, int ps,
                                          int64_t r, int p, int pages_bf16,
                                          int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vector != 0;
  if (pages_bf16)
    launch_scatter_batched<__nv_bfloat16>(pages, u, pt, lids, valid, dsum, k,
                                          c, m, ps, r, p, vec, s);
  else
    launch_scatter_batched<float>(pages, u, pt, lids, valid, dsum, k, c, m,
                                  ps, r, p, vec, s);
  return int(cudaGetLastError());
}

extern "C" int paged_bank_gather(const void* pages, const void* pt,
                                 const void* lids, void* out, int c,
                                 int64_t m, int ps, int pages_bf16,
                                 int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vector != 0;
  if (pages_bf16)
    launch_gather<__nv_bfloat16>(pages, pt, lids, out, c, m, ps, vec, s);
  else
    launch_gather<float>(pages, pt, lids, out, c, m, ps, vec, s);
  return int(cudaGetLastError());
}
