// Forward online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_kernel and its
// pallas_call in _flash_attention). For q (B,S,H,hd) and k, v (B,T,KV,hd),
// g = H / KV:
//
//     out[b,s,h] = softmax_t(q[b,s,h]·k[b,t,h/g] * scale, mask) · v[b,t,h/g]
//
// with scale = 1/sqrt(hd) and, when causal, the top-left mask t <= s (the
// wrapper allows a causal call only for S == T). Scores, the running max m,
// the normaliser l and the accumulator are f32; the output is q's dtype.
//
// What bounds it: operations. A causal call at zamba2-7b's prefill (B=4,
// S=T=2048, H=32, hd=112, bf16) needs 4·B·H·hd·S(S+1)/2 = 1.2e11 flops for
// 235 MB of q, k, v and out: about 510 flops a byte, above the card's ~295
// bf16 balance, so the least time is the flops over the 989 TFLOP/s bf16
// tensor-core peak.
//
// What the design does about it:
//   * bf16 runs on the tensor cores: each warp owns 16 query rows and
//     runs mma.sync m16n8k16 (bf16 in, f32 accumulate) for Q·Kᵀ and P·V.
//     The score tile never leaves registers: the f32 accumulator layout of
//     Q·Kᵀ is rearranged in registers into the bf16 A operand of P·V.
//   * One block per (64-query tile, head, batch) walks the key tiles in
//     order, as the TPU grid's sequential kv axis did; a causal block stops
//     at its last query, so the masked upper triangle costs nothing beyond
//     the diagonal tiles. Blocks start heaviest (last query tile)
//     first.
//   * K and V are read through h / g, so grouped-query heads are never
//     repeated in memory. Rows are read in the reference's (B,S,H,hd)
//     layout, 16 bytes at a time, and the ragged edges (S or T not a
//     multiple of 64, hd not a multiple of 16) are masked in the kernel.
//   * f32 inputs take a CUDA-core path with the same blocking of the
//     softmax (32 queries by 32 keys, FMA in f32), so f32 stays f32.
//   * Probabilities are rounded to bf16 before P·V and l sums the f32
//     probabilities, as in the TPU kernel. Nothing is allocated here.
//
// This first version keeps each tile in shared memory with plain loads and
// one buffer (no TMA, no wgmma, no pipelining).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------
constexpr int BQ = 64;     // query rows per block: 4 warps x 16
constexpr int BK = 64;     // keys per tile
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// KT = number of 16-wide slices of the head dim (hd <= 16*KT).
template <int KT>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int S, int T, int H,
                  int KV, int hd, int causal, float scale) {
  constexpr int HDP = KT * 16;     // padded head dim
  constexpr int KSTR = HDP + 8;    // row stride of Q and K tiles (bf16)
  constexpr int VSTR = BK + 8;     // row stride of the transposed V tile
  constexpr int CH = HDP / 8;      // 16-byte chunks in a padded row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][KSTR]
  __nv_bfloat16* Ks = Qs + BQ * KSTR;                          // [BK][KSTR]
  __nv_bfloat16* Vt = Ks + BK * KSTR;                          // [HDP][VSTR]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t qrow = int64_t(H) * hd, krow = int64_t(KV) * hd;
  const __nv_bfloat16* qb = q + int64_t(b) * S * qrow + int64_t(h) * hd;
  const __nv_bfloat16* kb = k + int64_t(b) * T * krow + int64_t(hk) * hd;
  const __nv_bfloat16* vb = v + int64_t(b) * T * krow + int64_t(hk) * hd;

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, d = (c % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S && d < hd)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * qrow + d);
    *reinterpret_cast<uint4*>(Qs + r * KSTR + d) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as mma A fragments
  const int wr = warp * 16;
  uint32_t qf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const __nv_bfloat16* p = Qs + (wr + gid) * KSTR + kt * 16 + tig * 2;
    qf[kt][0] = ld32(p);
    qf[kt][1] = ld32(p + 8 * KSTR);
    qf[kt][2] = ld32(p + 8);
    qf[kt][3] = ld32(p + 8 * KSTR + 8);
  }

  float m_r[2] = {NEG_INF, NEG_INF};  // rows gid and gid + 8
  float l_r[2] = {0.f, 0.f};          // this thread's share of l
  float oacc[2 * KT][4];
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  const int row0 = q0 + wr + gid;     // absolute query row of c0, c1
  const int kend = causal ? min(T, q0 + BQ) : T;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, d = (c % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < T && d < hd)
        val = *reinterpret_cast<const uint4*>(kb + (k0 + r) * krow + d);
      *reinterpret_cast<uint4*>(Ks + r * KSTR + d) = val;
    }
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c % BK, d = (c / BK) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < T && d < hd)
        val = *reinterpret_cast<const uint4*>(vb + (k0 + r) * krow + d);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(d + j) * VSTR + r] = e[j];
    }
    __syncthreads();

    // scores for 16 rows x 64 keys: 8 accumulator tiles of 16 x 8
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const __nv_bfloat16* p = Ks + (n * 8 + gid) * KSTR + kt * 16 + tig * 2;
        mma_bf16(s[n], qf[kt], ld32(p), ld32(p + 8));
      }
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + n * 8 + tig * 2 + (i & 1);
        const int row = row0 + (i >> 1) * 8;
        float sv = s[n][i] * scale;
        if (key >= T || (causal && key > row)) sv = NEG_INF;
        s[n][i] = sv;
        mx[i >> 1] = fmaxf(mx[i >> 1], sv);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], 2));
    }
    const float corr[2] = {expf(m_r[0] - mx[0]), expf(m_r[1] - mx[1])};
    m_r[0] = mx[0];
    m_r[1] = mx[1];
    l_r[0] *= corr[0];
    l_r[1] *= corr[1];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[n][i] - mx[i >> 1]);
        s[n][i] = p;
        l_r[i >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n) {
      oacc[n][0] *= corr[0];
      oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1];
      oacc[n][3] *= corr[1];
    }
    // P (bf16) · V: the accumulator tiles 2j and 2j+1 of the scores are the
    // A fragment of keys 16j..16j+15
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) {
        const __nv_bfloat16* p = Vt + (n * 8 + gid) * VSTR + j * 16 + tig * 2;
        mma_bf16(oacc[n], pa, ld32(p), ld32(p + 8));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l_r[j] += __shfl_xor_sync(FULL, l_r[j], 1);
    l_r[j] += __shfl_xor_sync(FULL, l_r[j], 2);
  }
  const float den[2] = {fmaxf(l_r[0], 1e-30f), fmaxf(l_r[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n) {
    const int col = n * 8 + tig * 2;
    if (col >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + half * 8;
      if (row < S) {
        __nv_bfloat162 val = __floats2bfloat162_rn(
            oacc[n][2 * half] / den[half], oacc[n][2 * half + 1] / den[half]);
        *reinterpret_cast<__nv_bfloat162*>(
            o + (int64_t(b) * S + row) * qrow + int64_t(h) * hd + col) = val;
      }
    }
  }
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------
constexpr int FQ = 32;     // query rows per block
constexpr int FK = 32;     // keys per tile
constexpr int FSTR = 129;  // row stride of the Q and K tiles (f32)

// NC = output columns per thread (hd <= 4*NC): thread t owns query row
// t / 4 and columns t % 4 + 4*i.
template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int T, int H, int KV, int hd, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [FQ][FSTR]
  float* Ks = Qs + FQ * FSTR;                  // [FK][FSTR]
  float* Vs = Ks + FK * FSTR;                  // [FK][128]
  float* Ps = Vs + FK * 128;                   // [FQ][FK + 1]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, r = tid / 4, qc = tid % 4;
  const int64_t qrow = int64_t(H) * hd, krow = int64_t(KV) * hd;
  const float* qb = q + int64_t(b) * S * qrow + int64_t(h) * hd;
  const float* kb = k + int64_t(b) * T * krow + int64_t(hk) * hd;
  const float* vb = v + int64_t(b) * T * krow + int64_t(hk) * hd;

  for (int e = tid; e < FQ * hd; e += THREADS) {
    const int rr = e / hd, d = e % hd;
    Qs[rr * FSTR + d] = q0 + rr < S ? qb[(q0 + rr) * qrow + d] : 0.f;
  }

  const int row = q0 + r;
  float m = NEG_INF, l = 0.f;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  const int kend = causal ? min(T, q0 + FQ) : T;

  for (int k0 = 0; k0 < kend; k0 += FK) {
    __syncthreads();
    for (int e = tid; e < FK * hd; e += THREADS) {
      const int rr = e / hd, d = e % hd;
      const bool in = k0 + rr < T;
      Ks[rr * FSTR + d] = in ? kb[(k0 + rr) * krow + d] : 0.f;
      Vs[rr * 128 + d] = in ? vb[(k0 + rr) * krow + d] : 0.f;
    }
    __syncthreads();
    // this thread's 8 keys: qc*8 .. qc*8+7
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qv = Qs[r * FSTR + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] += qv * Ks[(qc * 8 + j) * FSTR + d];
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + qc * 8 + j;
      float sv = s[j] * scale;
      if (key >= T || (causal && key > row)) sv = NEG_INF;
      s[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = expf(s[j] - mx);
      l += p;
      Ps[r * (FK + 1) + qc * 8 + j] = p;
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= corr;
    __syncwarp();  // a row's 4 threads share a warp
    for (int j = 0; j < FK; ++j) {
      const float p = Ps[r * (FK + 1) + j];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int d = qc + 4 * i;
        if (d < hd) acc[i] += p * Vs[j * 128 + d];
      }
    }
  }
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  const float den = fmaxf(l, 1e-30f);
  if (row < S) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = qc + 4 * i;
      if (d < hd)
        o[(int64_t(b) * S + row) * qrow + int64_t(h) * hd + d] = acc[i] / den;
    }
  }
}

template <int KT>
int launch_bf16(dim3 grid, cudaStream_t stream, const void* q,
                const void* k, const void* v, void* o, int S, int T, int H,
                int KV, int hd, int causal, float scale) {
  constexpr int HDP = KT * 16;
  const size_t smem = sizeof(__nv_bfloat16) *
                      (size_t(BQ + BK) * (HDP + 8) + size_t(HDP) * (BK + 8));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  flash_bf16_kernel<KT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, T, H, KV, hd, causal, scale);
  return int(cudaGetLastError());
}

template <int NC>
int launch_f32(dim3 grid, cudaStream_t stream, const void* q, const void* k,
               const void* v, void* o, int S, int T, int H, int KV, int hd,
               int causal, float scale) {
  const size_t smem =
      sizeof(float) * (size_t(FQ + FK) * FSTR + FK * 128 + FQ * (FK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  flash_f32_kernel<NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T, H, KV, hd,
      causal, scale);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. flags: bit 0 causal, bit 1 bf16
// (else f32). The wrapper guarantees hd % 8 == 0, hd <= 128, H % KV == 0,
// contiguous 16-byte-aligned tensors and S == T when causal. Returns the
// CUDA error of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int T, int H, int KV,
                               int hd, int flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int causal = flags & 1;
  const float scale = 1.0f / sqrtf(float(hd));
  if (flags & 2) {
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    switch ((hd + 15) / 16) {
      case 1: return launch_bf16<1>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
      case 2: return launch_bf16<2>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
      case 3: return launch_bf16<3>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
      case 4: return launch_bf16<4>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
      case 5: return launch_bf16<5>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
      case 6: return launch_bf16<6>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
      case 7: return launch_bf16<7>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
      case 8: return launch_bf16<8>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
      default: return int(cudaErrorInvalidValue);
    }
  }
  const dim3 grid((S + FQ - 1) / FQ, H, B);
  if (hd <= 32) return launch_f32<8>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
  if (hd <= 64) return launch_f32<16>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
  if (hd <= 128) return launch_f32<32>(grid, s, q, k, v, o, S, T, H, KV, hd, causal, scale);
  return int(cudaErrorInvalidValue);
}
