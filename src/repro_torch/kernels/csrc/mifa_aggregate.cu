// Fused MIFA server step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mifa_aggregate.py (_kernel and its
// pallas_call in _mifa_aggregate). For G (N, M) in the memory dtype, fresh
// updates U (N, M) f32, an active mask (N,) and weights w (M,):
//
//     G <- where(active, U, G)            (U cast to G's dtype)
//     w_new <- w - eta * mean_N(G)        (mean taken in f32)
//
// What bounds it: bytes. Per column it does N adds against at least N
// element reads, far below the card's ~20 flops/byte f32 balance, so the
// least time is the traffic over 3.35 TB/s: every row is read once (U for
// active rows, G for inactive ones), active rows of G are written once, and
// w is read and w_new written once.
//
// What the design does about it:
//   * G is updated IN PLACE and only where it changes: an inactive row is
//     read from G and never written, and its U row is never read. The TPU
//     kernel streams both G and U for every row; this moves N*M + |A|*M
//     elements instead of 3*N*M.
//   * The column axis is spread over threads, 4 adjacent columns each, so a
//     warp reads 128 consecutive columns of a row with 16-byte (f32) or
//     8-byte (bf16) vector loads. The row axis is split over TY row groups
//     inside the block for memory-level parallelism; their f32 partial sums
//     meet in shared memory and are added in a fixed order, so w_new is the
//     same on every run (no atomics).
//   * The kernel masks the ragged column edge itself; the caller pads
//     nothing. Leaves whose width is not a multiple of 4 (or whose pointers
//     are not aligned for vector access) take the scalar variant.
//   * It allocates nothing: the wrapper allocates w_new with torch.empty.
#include "common.cuh"

namespace {

using repro::COLS_PER_BLOCK;
using repro::TX;
using repro::TY;
using repro::VEC;

template <typename TG, typename TW, bool VECTOR>
__global__ void __launch_bounds__(TX * TY)
mifa_aggregate_kernel(const float* __restrict__ u, TG* __restrict__ g,
                      const uint8_t* __restrict__ active,
                      const TW* __restrict__ w, TW* __restrict__ w_new,
                      int n, int64_t m, float eta) {
  __shared__ float partial[TY][COLS_PER_BLOCK];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t col0 = (int64_t(blockIdx.x) * TX + tx) * VEC;

  float acc[VEC] = {0.f, 0.f, 0.f, 0.f};
  if (VECTOR) {
    // m % VEC == 0 here, so a thread's columns are all in range or all out
    if (col0 < m) {
      for (int r = ty; r < n; r += TY) {
        const int64_t off = int64_t(r) * m + col0;
        float v[VEC];
        if (active[r]) {
          repro::load4(u + off, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] = repro::round_to<TG>(v[k]);
          repro::store4(g + off, v);
        } else {
          repro::load4(g + off, v);
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[k];
      }
    }
  } else {
    for (int r = ty; r < n; r += TY) {
      const bool a = active[r] != 0;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int64_t c = col0 + k;
        if (c < m) {
          const int64_t off = int64_t(r) * m + c;
          float v;
          if (a) {
            const TG s = repro::from_f32<TG>(u[off]);
            g[off] = s;
            v = repro::to_f32(s);
          } else {
            v = repro::to_f32(g[off]);
          }
          acc[k] += v;
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
      const int64_t c = col0 + k;
      if (c < m) {
        float s = 0.f;
#pragma unroll
        for (int y = 0; y < TY; ++y) s += partial[y][tx * VEC + k];
        const float mean = s / float(n);
        // unfused multiply and subtract, rounded as the plain version rounds
        w_new[c] = repro::from_f32<TW>(
            __fsub_rn(repro::to_f32(w[c]), __fmul_rn(eta, mean)));
      }
    }
  }
}

template <typename TG, typename TW>
void launch(const void* u, void* g, const void* active, const void* w,
            void* w_new, int n, int64_t m, float eta, bool vector,
            cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid(unsigned((m + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK));
  auto* uu = static_cast<const float*>(u);
  auto* gg = static_cast<TG*>(g);
  auto* aa = static_cast<const uint8_t*>(active);
  auto* ww = static_cast<const TW*>(w);
  auto* wn = static_cast<TW*>(w_new);
  if (vector) {
    mifa_aggregate_kernel<TG, TW, true><<<grid, block, 0, stream>>>(
        uu, gg, aa, ww, wn, n, m, eta);
  } else {
    mifa_aggregate_kernel<TG, TW, false><<<grid, block, 0, stream>>>(
        uu, gg, aa, ww, wn, n, m, eta);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. g_bf16 / w_bf16 select the
// element type (0: f32, 1: bf16); vector selects the 4-wide variant, which
// needs m % 4 == 0 and aligned pointers (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int mifa_aggregate(const void* u, void* g, const void* active,
                              const void* w, void* w_new, int n, int64_t m,
                              float eta, int g_bf16, int w_bf16, int vector,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vector != 0;
  if (g_bf16) {
    if (w_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(u, g, active, w, w_new, n, m, eta,
                                           vec, s);
    else
      launch<__nv_bfloat16, float>(u, g, active, w, w_new, n, m, eta, vec, s);
  } else {
    if (w_bf16)
      launch<float, __nv_bfloat16>(u, g, active, w, w_new, n, m, eta, vec, s);
    else
      launch<float, float>(u, g, active, w, w_new, n, m, eta, vec, s);
  }
  return int(cudaGetLastError());
}
