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
// What bounds it: bytes, once the products run on the tensor cores. At
// zamba2-7b's prefill (b=4, S=2048, h=112, p=64, n=64, Q=256) the scan
// needs 30 GFLOP (C·Bᵀ once per batch row and chunk, lower triangle; the
// masked product with x, C·hᵀ and the state update per head) against 248
// MB of x, dA, B, C, y and h: about 120 flops a byte, below the card's ~295
// bf16 balance, so the least time is the bytes over 3.35 TB/s (74 µs). In
// f32 on the CUDA cores the same flops would take 452 µs.
//
// The bf16 path (mma.sync on the tensor cores, cp.async ring):
//   * Grid: one block of 8 warps per (head, batch row), walking the chunks
//     in order with the state carried on chip: this loop replaces the TPU
//     grid's sequential chunk axis. One head a block keeps every block's
//     work equal and its registers within two blocks an SM at zamba2's
//     shape (448 blocks); sharing C·Bᵀ among the heads of a batch row
//     would save about a third of the MMAs but hold several heads' y and
//     h at once.
//   * A chunk is walked as query tiles of 128 rows (16 a warp) against key
//     tiles of 64 rows at or below them; tiles above the diagonal are
//     skipped, and a warp skips key tiles wholly above its rows. Each key
//     tile (B_j and x_j) and, with the first key tile of a query tile, the
//     query tile's C rows come in by 16-byte cp.async copies into a ring of
//     two stages, issued one tile ahead, so the next tile is in flight
//     while this one is computed; the chunk's dA comes with its first tile.
//     Tiles are stored with 16 bytes of padding a row, so ldmatrix reads of
//     8 rows hit distinct banks; rows past the chunk and columns past p or
//     n are zeros, so any Q <= 1024 that divides S and any p, n <= 128 run.
//   * S = C_i·B_jᵀ by mma.sync m16n8k16 (bf16 in, f32 out), 16 keys at a
//     time; S∘L in f32, L = ex2.approx(log2e·cum_i − log2e·cum_j), masked
//     above the diagonal; the f32 accumulator repacked as the bf16 A
//     fragment of y += (S∘L)·x_j, x_j read through ldmatrix.trans. cum
//     stays f32 (|cum| reaches 10²–10³ within a chunk at zamba2's A).
//   * The carried state's share: a query tile's y starts as C_i·ĥᵀ by MMA,
//     ĥᵀ being a bf16 copy of hᵀ written to shared memory once a chunk,
//     with each row scaled by exp(cum_i).
//   * State update: hᵀ <- hᵀ·exp(cum[Q-1]) + (B∘dec)ᵀ·x by MMA (M = n,
//     N = p, K = the chunk's rows), into f32 accumulators that stay in
//     registers across the chunks, during the last query tile's walk, which
//     visits every key tile. The A fragment (B∘dec)ᵀ is formed in registers
//     from B read through ldmatrix.trans and rounded to bf16 twice, hi =
//     bf16(v) and lo = bf16(v − hi); both products are accumulated. x is
//     bf16 exactly, so the update errs by about 2^-17 a term where one
//     rounding would err by 2^-9 and break h_final's 5e-4 check.
//   * The within-chunk cumsum: 32-row segments scanned by the warps in
//     parallel, then the segments' prefixes added; exp(cum[Q-1] − cum_j)
//     takes cum[Q-1] in the same order as cum_j, so the last row's decay is
//     exactly 1.
//   * Instances: p and n padded to 32, 64 or 128 (PT, NT = 2, 4, 8 slices
//     of 16). Where y, the warp's C fragments and h come to at most 64
//     floats a thread (p, n <= 64, or p <= 32 and n = 128), two blocks share
//     an SM under a cap of 128 registers, and the C fragments are read again
//     from shared memory for each 16 keys instead of held through the query
//     tile: held, they spilled (44 bytes at p = n = 64) and the kernel ran 9%
//     slower. The larger instances run one block an SM and hold them.
//     Nothing is allocated here.
//   * Tried on an H100 at zamba2's shape and slower, so left out: a
//     three-stage ring (+3%); y written 16 bytes a thread after a transpose
//     within each quad (+8%); wgmma for C·Bᵀ (SS), (S∘L)·x and the state
//     update (RS) with 128-byte swizzled tiles (+15%: it spilled under the
//     128-register cap, and each warpgroup waits on its own products).
//
// f32 inputs take a CUDA-core path (f32 FMAs from shared memory, 64-row
// tiles, h in shared memory), so f32 stays f32; it serves the f32 checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QT = 16 * WARPS;  // query rows a tile: 16 a warp
constexpr int KT = 64;          // key rows a tile
constexpr int NST = 2;          // stages of the key-tile ring: slot, slot ^ 1
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory; zeros where !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16) · b (16 x 8, bf16). A thread holds
// d[0], d[1] at row gid, columns 2 tig, 2 tig + 1 and d[2], d[3] at row
// gid + 8 (gid = lane / 4, tig = lane % 4).
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (B∘dec) of one B fragment register (two rows of one column) as the hi
// and lo bf16 halves of its f32 value
__device__ __forceinline__ void split_scaled(uint32_t b, float d0, float d1,
                                             uint32_t& hi, uint32_t& lo) {
  const float2 v = unpack_bf16(b);
  const float v0 = v.x * d0, v1 = v.y * d1;
  hi = pack_bf16(v0, v1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

// registers a thread holds across a chunk: y (16 x 16 PT), the C fragments
// (16 x 16 NT) and h (16 NT x 16 PT over 8 warps); up to about 64 floats
// of them fit two blocks an SM (128 registers a thread)
template <int PT, int NT>
__host__ __device__ constexpr int min_blocks() {
  return 8 * PT + 4 * NT + PT * NT <= 64 ? 2 : 1;
}

// Shared memory, in order: the C tiles of two query tiles [2][QT][SN], the
// ring [NST] of key tiles (B_j [KT][SN], x_j [KT][SP]), ĥᵀ [NP][SP] (bf16);
// then log2e·cum, dec = exp(cum[Q-1] − cum) and the chunk's dA, QR floats
// each, and 33 floats of scan scratch.
template <int PT, int NT>
struct Layout {
  static constexpr int PP = 16 * PT, NP = 16 * NT;
  static constexpr int SP = PP + 8, SN = NP + 8;  // padded row strides
  static constexpr int STAGE = KT * (SN + SP);
  static constexpr int BF16S = 2 * QT * SN + NST * STAGE + NP * SP;
  static size_t bytes(int QR) {
    return sizeof(bf16) * size_t(BF16S) + sizeof(float) * (3 * size_t(QR) + 33);
  }
};

template <int PT, int NT>
__global__ void __launch_bounds__(THREADS, min_blocks<PT, NT>())
ssd_scan_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dA,
                     const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                     bf16* __restrict__ y, float* __restrict__ h_out, int S,
                     int H, int P, int N, int Q, int vec) {
  using L = Layout<PT, NT>;
  constexpr int SP = L::SP, SN = L::SN;
  constexpr int WR = WARPS / NT;      // warps a 16-row block of hᵀ
  constexpr int HP = 2 * PT / WR;     // 8-column tiles of hᵀ a warp
  constexpr int CB = 2 * QT * SN * 2, STB = L::STAGE * 2;  // bytes
  // the warp's C fragments stay in registers through a query tile, unless
  // registers are short: then they are read again for each 16 keys
  constexpr bool CREG = min_blocks<PT, NT>() == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  // shared addresses (bytes) of the C tiles, the ring and ĥᵀ
  const uint32_t cbuf = smem_addr(smem);
  const uint32_t ring = cbuf + CB;
  const uint32_t hh = ring + NST * STB;
  const int QR = (Q + KT - 1) / KT * KT;   // rows of the chunk's key tiles
  float* cum2 = reinterpret_cast<float*>(smem + L::BF16S * 2);
  float* dec = cum2 + QR;
  float* dab = dec + QR;
  float* tot = dab + QR;                   // [32] segment sums, [32] last row

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t xrow = int64_t(H) * P;     // elements between rows of x
  const int nq = (Q + QT - 1) / QT;        // query tiles a chunk
  // the row and column (elements) whose address a lane gives ldmatrix:
  // _a for fragments ordered (rows 0-7, 8-15) x (cols 0-7, 8-15), _b for
  // (rows 0-7; cols 0-7, 8-15), then rows 8-15
  const int lr_a = ((lane >> 3) & 1) * 8 + (lane & 7), lc_a = (lane >> 4) * 8;
  const int lr_b = (lane >> 4) * 8 + (lane & 7), lc_b = ((lane >> 3) & 1) * 8;

  // every tile's padding stays zero: copies never write it
  for (int e = tid; e < L::BF16S / 8; e += THREADS)
    reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto key_tiles = [&](int t) { return (min(Q, QT * (t + 1)) + KT - 1) / KT; };
  // copies rows r0.. (chunk-relative) of a (rows, w) slab with row stride
  // `stride` into the tile at shared address dst, row stride ld; rows at or
  // past Q read zeros
  auto copy_rows = [&](uint32_t dst, const bf16* src, int64_t stride, int r0,
                       int rows, int w, int ld, int cpr_log2) {
    if (vec) {
      const int cpr = 1 << cpr_log2;
      for (int e = tid; e < rows << cpr_log2; e += THREADS) {
        const int r = e >> cpr_log2, c = e & (cpr - 1);
        if (c * 8 < w) {
          const bool in = r0 + r < Q;
          cp_async16(dst + (r * ld + c * 8) * 2,
                     src + (in ? r0 + r : 0) * stride + c * 8, in);
        }
      }
    } else {  // widths or addresses that 16-byte copies cannot take
      bf16* d = reinterpret_cast<bf16*>(smem + (dst - cbuf));
      for (int r = warp; r < rows; r += WARPS)
        for (int c = lane; c < w; c += 32)
          d[r * ld + c] =
              r0 + r < Q ? src[(r0 + r) * stride + c] : __float2bfloat16(0.f);
    }
  };
  constexpr int NLOG = NT == 2 ? 2 : NT == 4 ? 3 : 4;  // log2 16-byte chunks
  constexpr int PLOG = PT == 2 ? 2 : PT == 4 ? 3 : 4;  // of a padded row
  // issues the copies of one item, key tile pk of query tile pt of the
  // chunk at ps0 (with the query tile's C rows into C buffer cq when pk is
  // 0, and the chunk's dA when pt is 0 too), into ring slot `slot`, as one
  // cp.async group
  auto issue = [&](int ps0, int pt, int pk, int cq, int slot) {
    if (ps0 < S) {
      const int64_t row0 = int64_t(b) * S + ps0;
      const uint32_t bs = ring + slot * STB;
      copy_rows(bs, Bm + row0 * N, N, pk * KT, KT, N, SN, NLOG);
      copy_rows(bs + KT * SN * 2, x + row0 * xrow + int64_t(h) * P, xrow,
                pk * KT, KT, P, SP, PLOG);
      if (pk == 0)
        copy_rows(cbuf + cq * QT * SN * 2, Cm + row0 * N, N, pt * QT, QT, N,
                  SN, NLOG);
      if (pk == 0 && pt == 0)
        for (int i = tid; i < Q; i += THREADS)
          cp_async4(dab + i, dA + (row0 + i) * H + h);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  issue(0, 0, 0, 0, 0);

  // hᵀ: rows n = hn0 + gid (+ 8), columns p = hp0 + 8 i + 2 tig (+ 1) of
  // tile i
  const int hn0 = (warp / WR) * 16, hp0 = (warp % WR) * HP * 8;
  float hacc[HP][4];
#pragma unroll
  for (int i = 0; i < HP; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) hacc[i][c] = 0.f;

  int slot = 0, qcount = 0;
  for (int s0 = 0; s0 < S; s0 += Q) {
    const int64_t row0 = int64_t(b) * S + s0;
    for (int t = 0; t < nq; ++t, ++qcount) {
      const int nk = key_tiles(t);
      const int i0 = t * QT + warp * 16;   // the warp's first query row
      const bool rows_in = i0 < Q;
      uint32_t cfr[CREG ? NT : 1][4];      // C_i as A fragments
      uint32_t cs = 0;                     // where the warp's C rows are
      float yacc[2 * PT][4];
      float rc[2];                         // log2e·cum of rows gid, gid + 8
      for (int k = 0; k < nk; ++k) {
        cp_async_wait_all();
        __syncthreads();  // tile k is in; the slot refilled below is free
        if (t == 0 && k == 0) {
          // the chunk's cumsum: segments of 32 rows, then their prefixes
          const int nseg = QR / 32;
          for (int sg = warp; sg < nseg; sg += WARPS) {
            const int i = sg * 32 + lane;
            float v = i < Q ? dab[i] : 0.f;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const float up = __shfl_up_sync(FULL, v, off);
              if (lane >= off) v += up;
            }
            cum2[i] = v;
            if (lane == 31) tot[sg] = v;
            if (i == Q - 1) tot[32] = v;
          }
          __syncthreads();
          float ts = lane < nseg ? tot[lane] : 0.f;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float up = __shfl_up_sync(FULL, ts, off);
            if (lane >= off) ts += up;
          }
          const int lseg = (Q - 1) / 32;
          const float lpre = __shfl_sync(FULL, ts, max(lseg - 1, 0));
          const float clast = tot[32] + (lseg > 0 ? lpre : 0.f);
          for (int sg = warp; sg < nseg; sg += WARPS) {
            const int i = sg * 32 + lane;
            const float pre = __shfl_sync(FULL, ts, max(sg - 1, 0));
            const float c = cum2[i] + (sg > 0 ? pre : 0.f);
            cum2[i] = i < Q ? c * LOG2E : 0.f;
            dec[i] = i < Q ? exp2_approx((clast - c) * LOG2E) : 0.f;
          }
          const float elast = expf(clast);
#pragma unroll
          for (int i = 0; i < HP; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) hacc[i][c] *= elast;
          __syncthreads();
        }
        {  // the next item goes into the other slot
          int ns0 = s0, nt = t, nkk = k + 1;
          if (nkk == nk) {
            nkk = 0;
            if (++nt == nq) {
              nt = 0;
              ns0 += Q;
            }
          }
          issue(ns0, nt, nkk, (qcount + (nkk == 0)) & 1, slot ^ 1);
        }
        const uint32_t bs = ring + slot * STB, xs = bs + KT * SN * 2;
        slot ^= 1;

        if (k == 0 && rows_in) {
          // the warp's C rows, and y = exp(cum_i) · (C_i·ĥᵀ)
          cs = cbuf + (qcount & 1) * QT * SN * 2 +
               ((warp * 16 + lr_a) * SN + lc_a) * 2;
          if constexpr (CREG) {
#pragma unroll
            for (int kn = 0; kn < NT; ++kn) ldsm_x4(cfr[kn], cs + kn * 32);
          }
#pragma unroll
          for (int i = 0; i < 2 * PT; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) yacc[i][c] = 0.f;
#pragma unroll
          for (int kn = 0; kn < NT; ++kn) {
            uint32_t* a = cfr[CREG ? kn : 0];
            if constexpr (!CREG) ldsm_x4(a, cs + kn * 32);
#pragma unroll
            for (int pp = 0; pp < PT; ++pp) {
              uint32_t hb[4];
              ldsm_x4_t(hb, hh + ((kn * 16 + lr_a) * SP + pp * 16 + lc_a) * 2);
              mma16816(yacc[2 * pp], a, hb[0], hb[1]);
              mma16816(yacc[2 * pp + 1], a, hb[2], hb[3]);
            }
          }
          rc[0] = cum2[i0 + gid];
          rc[1] = cum2[i0 + gid + 8];
          const float e0 = exp2_approx(rc[0]), e1 = exp2_approx(rc[1]);
#pragma unroll
          for (int i = 0; i < 2 * PT; ++i) {
            yacc[i][0] *= e0;
            yacc[i][1] *= e0;
            yacc[i][2] *= e1;
            yacc[i][3] *= e1;
          }
        }

        // y_i += (C_i·B_jᵀ ∘ L) · x_j, 16 keys at a time
        const int j0 = k * KT;
        if (rows_in && j0 <= i0 + 15) {
          const bool row_edge = i0 + 15 >= Q;
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk) {
            const int jb = j0 + 16 * kk;
            if (jb > i0 + 15 || jb >= Q) break;
            float s[2][4] = {};
            const uint32_t brow = bs + ((16 * kk + lr_b) * SN + lc_b) * 2;
#pragma unroll
            for (int kn = 0; kn < NT; ++kn) {
              uint32_t* a = cfr[CREG ? kn : 0];
              if constexpr (!CREG) ldsm_x4(a, cs + kn * 32);
              uint32_t bb[4];
              ldsm_x4(bb, brow + kn * 32);
              mma16816(s[0], a, bb[0], bb[1]);
              mma16816(s[1], a, bb[2], bb[3]);
            }
            const bool edge = row_edge || jb + 15 > i0;
            uint32_t pa[4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int key = jb + 8 * nt + 2 * tig;
              const float2 kc = *reinterpret_cast<const float2*>(cum2 + key);
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int row = i0 + gid + 8 * r;
                float l0 = exp2_approx(rc[r] - kc.x);
                float l1 = exp2_approx(rc[r] - kc.y);
                if (edge) {
                  if (key > row || row >= Q) l0 = 0.f;
                  if (key + 1 > row || row >= Q) l1 = 0.f;
                }
                pa[2 * nt + r] = pack_bf16(s[nt][2 * r] * l0,
                                           s[nt][2 * r + 1] * l1);
              }
            }
            const uint32_t xrow_s = xs + ((16 * kk + lr_a) * SP + lc_a) * 2;
#pragma unroll
            for (int pp = 0; pp < PT; ++pp) {
              uint32_t xb[4];
              ldsm_x4_t(xb, xrow_s + pp * 32);
              mma16816(yacc[2 * pp], pa, xb[0], xb[1]);
              mma16816(yacc[2 * pp + 1], pa, xb[2], xb[3]);
            }
          }
        }

        // the state update, in the walk of the last query tile, which
        // visits every key tile: hᵀ += (B_j ∘ dec_j)ᵀ · x_j, the A fragment
        // (16 n x 16 rows) scaled and split in registers
        if (t == nq - 1) {
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk) {
            const int qb = j0 + 16 * kk;
            if (qb >= Q) break;
            uint32_t ba[4], hi[4], lo[4];
            ldsm_x4_t(ba, bs + ((16 * kk + lr_b) * SN + hn0 + lc_b) * 2);
            const float2 d0 = *reinterpret_cast<const float2*>(dec + qb +
                                                               2 * tig);
            const float2 d1 = *reinterpret_cast<const float2*>(dec + qb + 8 +
                                                               2 * tig);
            split_scaled(ba[0], d0.x, d0.y, hi[0], lo[0]);
            split_scaled(ba[1], d0.x, d0.y, hi[1], lo[1]);
            split_scaled(ba[2], d1.x, d1.y, hi[2], lo[2]);
            split_scaled(ba[3], d1.x, d1.y, hi[3], lo[3]);
            const uint32_t xrow_s =
                xs + ((16 * kk + lr_a) * SP + hp0 + lc_a) * 2;
            if constexpr (HP == 1) {
              uint32_t xb[2];
              ldsm_x2_t(xb, xrow_s);
              mma16816(hacc[0], hi, xb[0], xb[1]);
              mma16816(hacc[0], lo, xb[0], xb[1]);
            } else {
#pragma unroll
              for (int np = 0; np < HP / 2; ++np) {
                uint32_t xb[4];
                ldsm_x4_t(xb, xrow_s + np * 32);
                mma16816(hacc[2 * np], hi, xb[0], xb[1]);
                mma16816(hacc[2 * np], lo, xb[0], xb[1]);
                mma16816(hacc[2 * np + 1], hi, xb[2], xb[3]);
                mma16816(hacc[2 * np + 1], lo, xb[2], xb[3]);
              }
            }
          }
        }
      }

      // the warp's 16 rows of y
      if (rows_in) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = i0 + gid + 8 * r;
          if (row >= Q) continue;
          bf16* yr = y + (row0 + row) * xrow + int64_t(h) * P;
#pragma unroll
          for (int i = 0; i < 2 * PT; ++i) {
            const int col = 8 * i + 2 * tig;
            if (vec) {
              if (col < P)
                *reinterpret_cast<__nv_bfloat162*>(yr + col) =
                    __floats2bfloat162_rn(yacc[i][2 * r], yacc[i][2 * r + 1]);
            } else {
              if (col < P) yr[col] = __float2bfloat16(yacc[i][2 * r]);
              if (col + 1 < P) yr[col + 1] = __float2bfloat16(yacc[i][2 * r + 1]);
            }
          }
        }
      }
    }
    // every warp is done reading ĥᵀ: write the new one for the next chunk
    __syncthreads();
    bf16* hw = reinterpret_cast<bf16*>(smem + (hh - cbuf));
#pragma unroll
    for (int i = 0; i < HP; ++i) {
      const int col = hp0 + 8 * i + 2 * tig;
      *reinterpret_cast<uint32_t*>(hw + (hn0 + gid) * SP + col) =
          pack_bf16(hacc[i][0], hacc[i][1]);
      *reinterpret_cast<uint32_t*>(hw + (hn0 + gid + 8) * SP + col) =
          pack_bf16(hacc[i][2], hacc[i][3]);
    }
  }
  cp_async_wait_all();  // the empty groups past the end

  float* ho = h_out + (int64_t(b) * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < HP; ++i) {
    const int p = hp0 + 8 * i + 2 * tig;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = hn0 + gid + 8 * r;
      if (n >= N) continue;
      if (p < P) ho[p * N + n] = hacc[i][2 * r];
      if (p + 1 < P) ho[(p + 1) * N + n] = hacc[i][2 * r + 1];
    }
  }
}

template <int PT, int NT>
int launch_bf16(int nb, cudaStream_t stream, const void* x, const void* dA,
                const void* B, const void* C, void* y, void* h_out, int S,
                int H, int P, int N, int Q, int vec) {
  const int QR = (Q + KT - 1) / KT * KT;
  const size_t smem = Layout<PT, NT>::bytes(QR);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bf16_kernel<PT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  ssd_scan_bf16_kernel<PT, NT><<<dim3(H, nb), THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dA),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C),
      static_cast<bf16*>(y), static_cast<float*>(h_out), S, H, P, N, Q, vec);
  return int(cudaGetLastError());
}

template <int PT>
int launch_bf16_n(int nb, cudaStream_t stream, const void* x, const void* dA,
                  const void* B, const void* C, void* y, void* h_out, int S,
                  int H, int P, int N, int Q, int vec) {
  if (N <= 32) return launch_bf16<PT, 2>(nb, stream, x, dA, B, C, y, h_out, S, H, P, N, Q, vec);
  if (N <= 64) return launch_bf16<PT, 4>(nb, stream, x, dA, B, C, y, h_out, S, H, P, N, Q, vec);
  if (N <= 128) return launch_bf16<PT, 8>(nb, stream, x, dA, B, C, y, h_out, S, H, P, N, Q, vec);
  return int(cudaErrorInvalidValue);
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------
constexpr int FTHREADS = 256;
constexpr int TILE = 64;           // rows of a query or key tile
constexpr int ASTR = TILE + 1;     // row stride of the product tile

// rows r0..r0+TILE of a (rows, width) slab starting at `src` with row
// stride `stride`, into dst[TILE][width + 1] (times scale[r] when given);
// rows at or past `rows` read zero
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int r0, int rows,
                                          int width, const float* scale) {
  for (int e = threadIdx.x; e < TILE * width; e += FTHREADS) {
    const int r = e / width, c = e % width;
    float val = 0.f;
    if (r0 + r < rows) {
      val = src[int64_t(r0 + r) * stride + c];
      if (scale != nullptr) val *= scale[r0 + r];
    }
    dst[r * (width + 1) + c] = val;
  }
}

// One block per (head, batch row) walks the chunks carrying h in shared
// memory; each chunk in 64-row tiles, C_i·B_jᵀ formed in a 64 x 64 shared
// tile with exp(cum_i − cum_j) recomputed on the fly and the upper
// triangle masked, then applied to x_j. PC = column slices of the head dim
// per thread (p <= 16*PC).
template <int PC>
__global__ void __launch_bounds__(FTHREADS, 1)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    float* __restrict__ y, float* __restrict__ h_out, int S,
                    int H, int P, int N, int Q) {
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
  for (int e = tid; e < P * NS; e += FTHREADS) h_s[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int64_t row0 = int64_t(b) * S + s0;   // first (b, s) row of chunk
    const float* xc = x + row0 * xstride + int64_t(h) * P;
    const float* bc = Bm + row0 * N;
    const float* cc = Cm + row0 * N;
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
    for (int i = tid; i < Q; i += FTHREADS) dec[i] = expf(cum[Q - 1] - cum[i]);

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
            y[(row0 + ii) * xstride + int64_t(h) * P + pc] = yacc[a][c];
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
      for (int e = tid; e < P * N; e += FTHREADS) {
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
  for (int e = tid; e < P * N; e += FTHREADS) {
    const int p = e / N, n = e % N;
    ho[e] = h_s[p * NS + n];
  }
}

template <int PC>
int launch_f32(int nb, cudaStream_t stream, const void* x, const void* dA,
               const void* B, const void* C, void* y, void* h_out, int S,
               int H, int P, int N, int Q) {
  const size_t smem =
      sizeof(float) * (size_t(P) * (N + 1) + 2 * size_t(Q) +
                       2 * size_t(TILE) * (N + 1) + size_t(TILE) * (P + 1) +
                       size_t(TILE) * ASTR);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32_kernel<PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  ssd_scan_f32_kernel<PC><<<dim3(H, nb), FTHREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dA),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(h_out), S, H, P, N, Q);
  return int(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  if (bf16) {
    // 16-byte copies need rows of whole 16-byte chunks at aligned addresses
    const int vec = P % 8 == 0 && N % 8 == 0 && aligned16(x) &&
                    aligned16(B) && aligned16(C) && aligned16(y) &&
                    aligned16(h_out);
    if (P <= 32) return launch_bf16_n<2>(nb, s, x, dA, B, C, y, h_out, S, H, P, N, Q, vec);
    if (P <= 64) return launch_bf16_n<4>(nb, s, x, dA, B, C, y, h_out, S, H, P, N, Q, vec);
    if (P <= 128) return launch_bf16_n<8>(nb, s, x, dA, B, C, y, h_out, S, H, P, N, Q, vec);
    return int(cudaErrorInvalidValue);
  }
  if (P <= 16) return launch_f32<1>(nb, s, x, dA, B, C, y, h_out, S, H, P, N, Q);
  if (P <= 32) return launch_f32<2>(nb, s, x, dA, B, C, y, h_out, S, H, P, N, Q);
  if (P <= 64) return launch_f32<4>(nb, s, x, dA, B, C, y, h_out, S, H, P, N, Q);
  if (P <= 128) return launch_f32<8>(nb, s, x, dA, B, C, y, h_out, S, H, P, N, Q);
  return int(cudaErrorInvalidValue);
}
