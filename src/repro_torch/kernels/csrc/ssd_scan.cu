// Mamba2 SSD chunked scan (one group) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py (_kernel and its
// pallas_call in _ssd_scan). For x (b,S,h,p), dA (b,S,h) f32, B, C (b,S,n)
// and chunks of Q rows, with cum the within-chunk cumsum of dA and h the
// (p, n) f32 state carried across chunks from zero:
//
//     y[i] = sum_{j<=i} (C_i·B_j) exp(cum_i - cum_j) x[j] + exp(cum_i) h·C_i
//     h   <- h·exp(cum[Q-1]) + sum_j x[j] ⊗ B_j·exp(cum[Q-1] - cum_j)
//
// y is written in x's dtype and the final h (b,h,p,n) in f32.
//
// What bounds it: operations, in f32 on the CUDA cores. At zamba2-7b's
// prefill (b=4, S=2048, h=112, p=64, n=64, Q=256) the scan needs 30 GFLOP
// (C·Bᵀ once per batch row and chunk, lower triangle; the masked product
// with x, C·hᵀ and the state update per head) against 248 MB of x, dA, B,
// C, y and h: about 120 flops a byte, above the ~20 of f32 on this card,
// so the least time is the flops over 67 TFLOP/s.
//
// What the design does about it:
//   * One block per (head, batch row) walks the chunks in order, carrying h
//     in shared memory: this loop replaces the TPU grid's sequential chunk
//     axis. 256 threads; 448 blocks at zamba2's shape.
//   * The TPU kernel holds a whole chunk and the (Q,Q) decay matrix L in
//     VMEM; at Q=256 the f32 L alone is 256 KB, more than a block's 227 KB.
//     Here the chunk is walked in 64-row tiles: for each query tile and
//     each key tile at or below it, C_i·B_jᵀ is formed in a 64 x 64 shared
//     tile with exp(cum_i - cum_j) recomputed on the fly and the upper
//     triangle masked, then applied to x_j; tiles above the diagonal are
//     skipped. Shared memory holds h, cum, one tile each of C, B, x and the
//     64 x 64 product: 85 KB at n=64 (two blocks an SM), 134 KB at n=128.
//   * cum stays f32 and <= 0 (dA < 0), so every exponential is <= 1; the
//     state update keeps the reference's order h·exp(cum[-1]) + x ⊗ (B·
//     decay), adding one key tile at a time.
//   * C·Bᵀ does not depend on the head: counted once per batch row and
//     chunk it is under 1% of the flops the scan needs, but each head's
//     block forms it again, as the TPU kernel did, about a third of what
//     this kernel computes.
//   * Tiles are stored with one padding column so that the threads of a
//     warp read distinct banks. Nothing is allocated here.
//
// This first version runs the products as f32 FMAs from shared memory
// (no tensor cores, no pipelining).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;           // rows of a query or key tile
constexpr int ASTR = TILE + 1;     // row stride of the product tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows r0..r0+TILE of a (rows, width) slab starting at `src` with row
// stride `stride`, into dst[TILE][width + 1] as f32 (times scale[r] when
// given); rows at or past `rows` read zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int r0, int rows,
                                          int width, const float* scale) {
  for (int e = threadIdx.x; e < TILE * width; e += THREADS) {
    const int r = e / width, c = e % width;
    float val = 0.f;
    if (r0 + r < rows) {
      val = to_f32(src[int64_t(r0 + r) * stride + c]);
      if (scale != nullptr) val *= scale[r0 + r];
    }
    dst[r * (width + 1) + c] = val;
  }
}

// PC = column slices of the head dim per thread (p <= 16*PC)
template <typename T, int PC>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                T* __restrict__ y, float* __restrict__ h_out, int S, int H,
                int P, int N, int Q) {
  extern __shared__ __align__(16) float sm[];
  const int NS = N + 1, PS = P + 1;
  float* h_s = sm;                     // [P][NS]  the carried state
  float* cum = h_s + P * NS;           // [Q]
  float* dec = cum + Q;                // [Q]      exp(cum[Q-1] - cum)
  float* c_s = dec + Q;                // [TILE][NS]
  float* b_s = c_s + TILE * NS;        // [TILE][NS]
  float* x_s = b_s + TILE * NS;        // [TILE][PS]
  float* a_s = x_s + TILE * PS;        // [TILE][ASTR]

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ti = (tid / 16) * 4;       // rows ti..ti+3 of a tile
  const int tj = tid % 16;             // columns tj + 16*c
  const int64_t xstride = int64_t(H) * P;
  for (int e = tid; e < P * NS; e += THREADS) h_s[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int64_t row0 = int64_t(b) * S + s0;   // first (b, s) row of chunk
    const T* xc = x + row0 * xstride + int64_t(h) * P;
    const T* bc = Bm + row0 * N;
    const T* cc = Cm + row0 * N;
    __syncthreads();  // the previous chunk's state update is complete
    if (tid < 32) {   // inclusive cumsum of dA over the chunk, one warp
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        float val = i < Q ? dA[(row0 + i) * H + h] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(FULL, val, off);
          if (tid >= off) val += up;
        }
        val += carry;
        if (i < Q) cum[i] = val;
        carry = __shfl_sync(FULL, val, 31);
      }
    }
    __syncthreads();
    for (int i = tid; i < Q; i += THREADS) dec[i] = expf(cum[Q - 1] - cum[i]);

    // y for each query tile
    for (int i0 = 0; i0 < Q; i0 += TILE) {
      __syncthreads();  // c_s, b_s, x_s, a_s free; dec written
      load_tile(c_s, cc, N, i0, Q, N, nullptr);
      float yacc[4][PC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < PC; ++c) yacc[a][c] = 0.f;
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        if (j0 > 0) __syncthreads();   // a_s, b_s, x_s consumed
        load_tile(b_s, bc, N, j0, Q, N, nullptr);
        load_tile(x_s, xc, xstride, j0, Q, P, nullptr);
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = c_s[(ti + a) * NS + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = b_s[(tj + 16 * c) * NS + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] += cv[a] * bv[c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int ii = i0 + ti + a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jj = j0 + tj + 16 * c;
            const float L =
                (jj <= ii && ii < Q) ? expf(cum[ii] - cum[jj]) : 0.f;
            a_s[(ti + a) * ASTR + tj + 16 * c] = acc[a][c] * L;
          }
        }
        __syncthreads();
        for (int j = 0; j < TILE; ++j) {
          float av[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) av[a] = a_s[(ti + a) * ASTR + j];
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int pc = tj + 16 * c;
            if (pc < P) {
              const float xv = x_s[j * PS + pc];
#pragma unroll
              for (int a = 0; a < 4; ++a) yacc[a][c] += av[a] * xv;
            }
          }
        }
      }
      // the carried state's share: exp(cum_i) · (h · C_i)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ii = i0 + ti + a;
        if (ii >= Q) continue;
        const float e = expf(cum[ii]);
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int pc = tj + 16 * c;
          if (pc < P) {
            float t = 0.f;
            for (int n = 0; n < N; ++n)
              t += c_s[(ti + a) * NS + n] * h_s[pc * NS + n];
            yacc[a][c] += t * e;
            y[(row0 + ii) * xstride + int64_t(h) * P + pc] =
                from_f32<T>(yacc[a][c]);
          }
        }
      }
    }

    // state update, one key tile at a time: h <- h·exp(cum[Q-1]) first,
    // then + x_j ⊗ (B_j · dec_j) for each tile
    const float e_last = expf(cum[Q - 1]);
    for (int j0 = 0; j0 < Q; j0 += TILE) {
      __syncthreads();  // every y tile has read h_s; b_s, x_s free
      load_tile(b_s, bc, N, j0, Q, N, dec);
      load_tile(x_s, xc, xstride, j0, Q, P, nullptr);
      __syncthreads();
      for (int e = tid; e < P * N; e += THREADS) {
        const int p = e / N, n = e % N;
        float acc = 0.f;
        for (int j = 0; j < TILE; ++j) acc += x_s[j * PS + p] * b_s[j * NS + n];
        float hv = h_s[p * NS + n];
        if (j0 == 0) hv *= e_last;
        h_s[p * NS + n] = hv + acc;
      }
    }
  }
  __syncthreads();
  float* ho = h_out + (int64_t(b) * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e % N;
    ho[e] = h_s[p * NS + n];
  }
}

template <typename T, int PC>
int launch(int nb, cudaStream_t stream, const void* x, const void* dA,
           const void* B, const void* C, void* y, void* h_out, int S, int H,
           int P, int N, int Q) {
  const size_t smem =
      sizeof(float) * (size_t(P) * (N + 1) + 2 * size_t(Q) +
                       2 * size_t(TILE) * (N + 1) + size_t(TILE) * (P + 1) +
                       size_t(TILE) * ASTR);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  ssd_scan_kernel<T, PC><<<dim3(H, nb), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dA),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<T*>(y), static_cast<float*>(h_out), S, H, P, N, Q);
  return int(cudaGetLastError());
}

template <typename T>
int launch_p(int nb, cudaStream_t stream, const void* x, const void* dA,
             const void* B, const void* C, void* y, void* h_out, int S,
             int H, int P, int N, int Q) {
  if (P <= 16) return launch<T, 1>(nb, stream, x, dA, B, C, y, h_out, S, H, P, N, Q);
  if (P <= 32) return launch<T, 2>(nb, stream, x, dA, B, C, y, h_out, S, H, P, N, Q);
  if (P <= 64) return launch<T, 4>(nb, stream, x, dA, B, C, y, h_out, S, H, P, N, Q);
  if (P <= 128) return launch<T, 8>(nb, stream, x, dA, B, C, y, h_out, S, H, P, N, Q);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes. bf16 selects the dtype of x, B,
// C and y (else f32); dA is f32 and h_out f32. The wrapper guarantees
// contiguous tensors, S % Q == 0, Q <= 1024 and P, N <= 128. Returns the
// CUDA error of the launch (0 on success).
extern "C" int ssd_scan(const void* x, const void* dA, const void* B,
                        const void* C, void* y, void* h_out, int nb, int S,
                        int H, int P, int N, int Q, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_p<__nv_bfloat16>(nb, s, x, dA, B, C, y, h_out, S, H, P, N, Q);
  return launch_p<float>(nb, s, x, dA, B, C, y, h_out, S, H, P, N, Q);
}
