// The cohort row gather / delta / scatter body shared by `bank_scatter.cu`
// (flat rows) and `paged_bank.cu` (rows behind a page table). Only the row
// address differs between the two, so both kernels sum the same cohort rows
// in the same order and give bit-equal delta sums: a paged bank's G_sum is
// the dense bank's, whatever slot a page occupies.
//
// For a block of TX x TY threads owning COLS_PER_BLOCK columns:
//
//     for every valid slot a (row group a % TY, each group in increasing a):
//         r = row_of(a);  old = bank[r];  u_st = cast(U[a])  (bank dtype)
//         acc += u_st - old   (f32);   bank[r] = u_st   (in place)
//     dsum[col] = sum over row groups 0..TY-1 of acc   (fixed order)
//
// `row_of` is only called for valid slots, so pad slots cost no load.
#pragma once

#include "common.cuh"

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

// The body of a scatter kernel launched as grid ceil(m / COLS_PER_BLOCK),
// block (TX, TY). VECTOR: m % VEC == 0 and 16-/8-byte aligned rows.
template <typename TB, bool VECTOR, typename RowOf>
__device__ __forceinline__ void scatter_rows(TB* __restrict__ bank,
                                             const float* __restrict__ u,
                                             RowOf row_of,
                                             const uint8_t* __restrict__ valid,
                                             float* __restrict__ dsum, int c,
                                             int64_t m) {
  __shared__ float partial[TY][COLS_PER_BLOCK];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t col0 = (int64_t(blockIdx.x) * TX + tx) * VEC;

  float acc[VEC] = {0.f, 0.f, 0.f, 0.f};
  if (VECTOR) {
    // m % VEC == 0 here, so a thread's columns are all in range or all out
    if (col0 < m) {
      for (int a = ty; a < c; a += TY) {
        if (!valid[a]) continue;
        TB* row = bank + row_of(a) * m + col0;
        float old[VEC], v[VEC];
        load4(row, old);
        load4(u + int64_t(a) * m + col0, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          v[k] = round_to<TB>(v[k]);
          acc[k] += v[k] - old[k];
        }
        store4(row, v);
      }
    }
  } else {
    for (int a = ty; a < c; a += TY) {
      if (!valid[a]) continue;
      const int64_t r = row_of(a);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int64_t col = col0 + k;
        if (col < m) {
          const int64_t off = r * m + col;
          const float old = to_f32(bank[off]);
          const TB s = from_f32<TB>(u[int64_t(a) * m + col]);
          acc[k] += to_f32(s) - old;
          bank[off] = s;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < VEC; ++k) partial[ty][tx * VEC + k] = acc[k];
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int64_t col = col0 + k;
      if (col < m) {
        float s = 0.f;
#pragma unroll
        for (int y = 0; y < TY; ++y) s += partial[y][tx * VEC + k];
        dsum[col] = s;
      }
    }
  }
}

}  // namespace repro
