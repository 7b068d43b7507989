// Forward online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_kernel and its
// pallas_call in _flash_attention). For q (B,S,H,hd), k (B,T,KV,hd) and
// v (B,T,KV,dv), g = H / KV:
//
//     out[b,s,h] = softmax_t(q[b,s,h]·k[b,t,h/g] * scale, mask) · v[b,t,h/g]
//
// into out (B,S,H,dv), with scale = 1/sqrt(hd) and, when causal, the
// top-left mask t <= s (the wrapper allows a causal call only for S == T).
// A causal call may take a sliding window w > 0 (gemma3's local layers):
// then key t is valid for query s iff s - w < t <= s, the mask of the
// reference's blockwise_attention (repro/models/attention.py). Scores, the
// running max m, the normaliser l and the accumulator are f32; the output
// is q's dtype.
//
// What bounds it: operations. A causal call at zamba2-7b's prefill (B=4,
// S=T=2048, H=32, hd=112, bf16) needs 4·B·H·hd·S(S+1)/2 = 1.2e11 flops for
// 235 MB of q, k, v and out: about 510 flops a byte, above the card's ~295
// bf16 balance, so the least time is the flops over the 989 TFLOP/s bf16
// tensor-core peak. Only wgmma reaches that rate; beside it, the softmax's
// one ex2 per score (16 a clock per SM) costs about half the MMA time at
// hd = 112, so the MMAs of one warpgroup have to overlap the softmax of
// another.
//
// The bf16 path (wgmma and TMA):
//   * One block of 2 warpgroups per (128-query tile, head, batch); each
//     warpgroup owns 64 query rows. Blocks of one (head, batch) run
//     heaviest (last query tile) first; a causal block stops at its last
//     query and a warpgroup skips key tiles wholly above its rows. With a
//     window the block starts at the tile of its first row's lowest key,
//     and a warpgroup skips tiles wholly below its top row's window.
//   * Q (once) and 64-key tiles of K and V come in by TMA: 4-d tensor maps
//     over the reference's (B, rows, heads, hd) layout, boxes of 64 head
//     columns, so GQA reads head h / g in place and nothing is repeated.
//     Rows past S or T and columns past hd arrive as zeros. The K/V ring
//     has 2 stages, each completed by an mbarrier's transaction count; the
//     second warpgroup done with a stage refills it (a named barrier per
//     warpgroup and a shared count), so the two warpgroups run decoupled.
//     Each warpgroup waits for every tile, also one it skips: the count
//     names the second arrival only while no warpgroup arrives for tile
//     j + 2 before both have arrived for tile j. A warpgroup that skipped
//     the wait could run ahead (the first warpgroup skips a causal block's
//     last tile), take the other's arrival for tile j - 2 as its own second
//     one, and leave tile j unloaded: the other warpgroup then waited for
//     it forever, an intermittent hang. `scripts/flash_ring_probe.py`
//     builds the kernel with FLASH_RING_PROBE, which delays the second
//     warpgroup and bounds every wait, to show that no wait goes unmet.
//   * Shared tiles are stored as 64-column atoms of 128-byte rows with the
//     128-byte swizzle the TMA writes and wgmma reads, free of bank
//     conflicts.
//   * Q·Kᵀ: wgmma m64n64k16, Q and K from shared memory (K-major), one
//     instruction per 16 head columns. P·V: wgmma m64nNk16 (N <= 64 a
//     64-column atom of the head dim), P from registers (the score
//     accumulator repacked as bf16 A fragments, so the score tile never
//     leaves registers), V from shared memory in its natural (key, hd)
//     layout, read MN-major through the transpose bit: V is never
//     transposed in memory. f32 accumulators throughout.
//   * Softmax in base 2: m is the max of the raw scores and
//     p = ex2.approx(s·scale·log2 e − m·scale·log2 e), one FMA and one ex2
//     per score; the correction factor is one ex2 as well, and the
//     accumulator is rescaled only when a row of the warp has a new max
//     (otherwise every factor is exactly 1). A masked score is −1e30 (the
//     TPU kernel's value) before the fold. With a window a row can see a
//     whole tile masked before its first valid key, its max still −1e30;
//     ex2(s·c − m·c) as one FMA would then leave the rounding residual of
//     m·c (about 1e22) and give 0 or inf, so such a row folds against 0
//     instead of m: p = ex2(−1e30·c) = 0 and the correction stays 1 until
//     a valid key arrives. The per-element mask runs only on tiles that
//     cross the diagonal, the window's lower edge or the end of T.
//   * Probabilities are rounded to bf16 before P·V and l sums the f32
//     probabilities, as in the TPU kernel. The output is staged through
//     shared memory and written 16 bytes at a time. Nothing is allocated
//     here.
//   * Resources (nvcc -Xptxas -v, sm_90a): 128 registers a thread at KT = 8
//     and 125 at KT = 7 under __launch_bounds__(256, 2), no spills;
//     99,360 bytes of dynamic shared memory for hd > 64 (50,208 up to 64),
//     so two blocks (4 warpgroups) share an SM. One block an SM, with no
//     register cap, ran slower when tried; overlapping a tile's softmax
//     with the next tile's Q·Kᵀ inside a warpgroup needs a second score
//     tile and spilled under the cap.
//   * Head dims above 128 (gemma3's 256) take KT = 12 or 16: the P·V
//     accumulator alone is 4·KT f32 registers a thread (128 at hd 256)
//     beside the 32 of the score tile, and Q with the two-stage K/V ring
//     needs 197,664 bytes of shared memory at hd 256, so these instances
//     run one block an SM under __launch_bounds__(256, 1): 206 registers
//     at KT = 16 and 167 at KT = 12, no spills.
//   * v's head dim has a width of its own (VT 16-wide slices beside Q and
//     K's KT): V's tensor map, ring tiles, transaction count, the P·V
//     accumulator and the output row follow dv. Every instance but one
//     has VT = KT (dv == hd); MLA's prefill (hd 192 = 128 + 64 roped, dv
//     128) takes KT = 12, VT = 8: 48 KB of Q, 48 KB of K and 32 KB of V
//     tiles, so still one block an SM, with 32 accumulator registers fewer
//     than KT = VT = 12.
//   * The window's logic is compiled only into the instances that take
//     it (KT = 4, 8, 12, 16, the head dim padded to whole 64-column
//     atoms): compiled into every instance, it made ptxas spill 32 and 64
//     bytes at KT = 7 and 8 under the 128-register cap.
//
// f32 inputs take a CUDA-core path with the same blocking of the softmax
// (32 queries by 32 keys, FMA in f32), so f32 stays f32; it serves the f32
// checks only.
#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value
constexpr unsigned FULL = 0xffffffffu;

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------
constexpr int BQ = 128;     // query rows per block: 2 warpgroups x 64
constexpr int BK = 64;      // keys per tile
constexpr int NSTAGE = 2;   // depth of the K/V ring
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;  // blocks an SM holds: caps registers at 128
constexpr int WIDE_KT = 8;     // above it, one block an SM (hd > 128)
constexpr int ROWB = 128;   // bytes of a row of a 64-column atom
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// the barrier inits become visible to the TMA unit
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of TMA transfers
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
#ifdef FLASH_RING_PROBE
// the probe build (scripts/flash_ring_probe.py): a wait gives up after
// 2^20 tries and counts itself here, where the production kernel would
// wait on
__device__ unsigned flash_probe_unmet;
#endif

// wait for the completion of phase `parity` (0, 1, 0, ...) of the barrier
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#ifdef FLASH_RING_PROBE
  for (long long i = 0;; ++i) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (i == (1ll << 20)) {
      atomicAdd(&flash_probe_unmet, 1u);
      return;
    }
  }
#else
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
#endif
}
// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory; elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Tiles are stored as 64-column atoms, [atom][row][64 bf16], with the
// 128-byte swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8) of
// its row), as the TMA writes them. A wgmma shared-memory descriptor of
// such a tile: K-major operands (Q, K) step 8-row groups by sbo = 1024; the
// MN-major operand (V) steps 8-key groups by sbo = 1024 and 64-column atoms
// by lbo.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(lbo >> 4) << 16 |
         uint64_t(sbo >> 4) << 32 | uint64_t(1) << 62;
}

// x, which the compiler may not hoist or fold across this point: keeps a
// loop from holding one 64-bit descriptor per head-dim slice in registers
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the compiler must not move reads or writes of these registers across an
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x N, f32) += A · B on one warpgroup. ss: A (64 x 16) and B (16 x
// N) from shared memory, both K-major; rs: A from registers (the mma.sync
// A fragment of each warp's 16 rows), B MN-major. d[4n + i] of a thread
// holds row gid + 8(i / 2), column 8n + 2 tig + i % 2 of its warp's rows.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t a[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t a[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  if constexpr (N == 48) wgmma_rs_n48(d, a, db);
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
}

// oacc (64 x VDP) += P (the A fragment of 16 keys) · V's rows `vrow`: one
// instruction per 64-column atom of V, the last one as wide as what is left
template <int VDP, int A = 0>
__device__ __forceinline__ void pv_atoms(float* oacc, const uint32_t a[4],
                                         uint32_t vrow) {
  constexpr int N = VDP - 64 * A < 64 ? VDP - 64 * A : 64;
  wgmma_rs<N>(oacc + 32 * A, a,
              wgmma_desc(vrow + A * BK * ROWB, BK * ROWB, 1024));
  if constexpr (VDP > 64 * (A + 1)) pv_atoms<VDP, A + 1>(oacc, a, vrow);
}

// KT, VT = number of 16-wide slices of q/k's and v's head dims (hd <=
// 16*KT, dv <= 16*VT); WIN: the call has a sliding window (its logic
// compiled only into these instances, so that the others keep their
// register budget).
template <int KT, int VT, bool WIN>
__global__ void __launch_bounds__(THREADS, KT > WIDE_KT ? 1 : MIN_BLOCKS)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int S, int T, int H,
                  int KV, int hd, int dv_arg, int causal, int window,
                  float scale_log2) {
  constexpr int HDP = KT * 16;     // padded head dims
  constexpr int VDP = VT * 16;
  constexpr int CHV = VDP / 8;     // 16-byte chunks of a padded output row
  constexpr int NA = (HDP + 63) / 64;   // 64-column atoms of a Q or K row
  constexpr int NAV = (VDP + 63) / 64;  // and of a V row
  constexpr uint32_t QBYTES = NA * BQ * ROWB, KBYTES = NA * BK * ROWB,
                     VBYTES = NAV * BK * ROWB;
  constexpr int STR = VDP + 8;     // row stride of the output staging
  // an instance with VT == KT serves only dv == hd: taking dv from hd
  // leaves its code as it was before v had a width of its own
  const int dv = VT == KT ? hd : dv_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t Qs = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (Qs - raw);
  const uint32_t Ks = Qs + QBYTES;                 // [NSTAGE] tiles
  const uint32_t Vs = Ks + NSTAGE * KBYTES;        // [NSTAGE] tiles

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t orow = int64_t(H) * dv;
  const int kend = causal ? min(T, q0 + BQ) : T;
  // with a window, tiles start at the one holding the first row's lowest
  // key; local tile i is key tile j0 + i
  const int j0 = WIN ? max(0, q0 - window + 1) / BK : 0;
  const int ntiles = (kend + BK - 1) / BK - j0;

  // one barrier a stage, completed by the TMA bytes of its K and V tiles,
  // and one for Q; then a count a stage of the warpgroups done with it
  const uint32_t bars = Vs + NSTAGE * VBYTES, qbar = bars + 8 * NSTAGE;
  int* done = reinterpret_cast<int*>(smem + (bars - Qs) + 8 * (NSTAGE + 1));
  if (tid == 0) {
    for (int st = 0; st <= NSTAGE; ++st) mbar_init(bars + 8 * st, 1);
    for (int st = 0; st < NSTAGE; ++st) done[st] = 0;
    fence_mbar_init();
  }
  __syncthreads();
  // one thread of the block issues the copies of local tile j
  auto load_tile = [&](int j) {
    const int st = j % NSTAGE;
    mbar_expect_tx(bars + 8 * st, KBYTES + VBYTES);
#pragma unroll
    for (int a = 0; a < (NA > NAV ? NA : NAV); ++a) {
      if (a < NA)
        tma_load_4d(Ks + st * KBYTES + a * BK * ROWB, &tk, bars + 8 * st,
                    64 * a, hk, (j0 + j) * BK, b);
      if (a < NAV)
        tma_load_4d(Vs + st * VBYTES + a * BK * ROWB, &tv, bars + 8 * st,
                    64 * a, hk, (j0 + j) * BK, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, QBYTES);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      tma_load_4d(Qs + a * BQ * ROWB, &tq, qbar, 64 * a, h, q0, b);
#pragma unroll
    for (int j = 0; j < NSTAGE; ++j)
      if (j < ntiles) load_tile(j);
  }

  const int wg = warp / 4;             // warpgroup: query rows 64wg..
  const int wq0 = q0 + wg * 64;        // first query row of the warpgroup
  const int wrow = wq0 + (warp % 4) * 16;  // first query row of the warp
  const int row0 = wrow + gid;         // query row of c0, c1
  const uint32_t qa = Qs + wg * 64 * ROWB;
  float m_r[2] = {NEG_INF, NEG_INF};  // raw-score max of rows gid, gid + 8
  float l_r[2] = {0.f, 0.f};          // this thread's share of l
  float oacc[VDP / 2];
#pragma unroll
  for (int i = 0; i < VDP / 2; ++i) oacc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = (j0 + j) * BK;
    // tile j is in; waited for also where skipped, so that no warpgroup
    // arrives for tile j + 2 before both have for tile j (the header)
    mbar_wait(bars + 8 * (j % NSTAGE), (j / NSTAGE) & 1);
    // else wholly above the warpgroup's rows or below its top row's window
    if ((!causal || k0 <= wq0 + 63) &&
        (!WIN || k0 + BK > wq0 - window + 1)) {
      const uint32_t kst = Ks + (j % NSTAGE) * KBYTES;
      const uint32_t vst = Vs + (j % NSTAGE) * VBYTES;

      // raw scores for 64 rows x 64 keys; s[4n + i]: key 8n + 2 tig + i % 2
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      // slice kt of the head dim: atom kt / 4, 32 bytes a slice into it
      // (descriptors count in 16-byte units)
      const uint64_t dq = opaque(wgmma_desc(qa, 16, 1024));
      const uint64_t dk = wgmma_desc(kst, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t col = (kt % 4) * 2;
        wgmma_ss_n64(s, dq + (kt / 4) * BQ * ROWB / 16 + col,
                     dk + (kt / 4) * BK * ROWB / 16 + col, kt > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(s);

      if (k0 + BK > T || (causal && k0 + BK - 1 > wrow) ||
          (WIN && k0 < wrow + 16 - window)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + (i / 4) * 8 + tig * 2 + (i & 1);
          const int row = row0 + ((i >> 1) & 1) * 8;
          if (key >= T || (causal && key > row) ||
              (WIN && key <= row - window))
            s[i] = NEG_INF;
        }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      float corr[2], ms[2];
      bool grew = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        grew |= mx[r] > m_r[r];
        corr[r] = exp2_approx((m_r[r] - mx[r]) * scale_log2);
        ms[r] = mx[r] * scale_log2;
        // a row with no valid key yet folds against 0 (see the header)
        if constexpr (WIN) ms[r] = mx[r] == NEG_INF ? 0.f : ms[r];
        m_r[r] = mx[r];
        l_r[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = exp2_approx(fmaf(s[i], scale_log2, -ms[(i >> 1) & 1]));
        s[i] = p;
        l_r[(i >> 1) & 1] += p;
      }
      // where no row of the warp has a new max, every correction is exactly 1
      if (__any_sync(FULL, grew)) {
#pragma unroll
        for (int i = 0; i < VDP / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
      }
      // P (bf16) · V: score tiles 2jj and 2jj+1 are the A fragment of keys
      // 16jj..16jj+15; V's rows are keys, so B is read MN-major
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[jj][i] = pack_bf16(s[8 * jj + 2 * i], s[8 * jj + 2 * i + 1]);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj)
        pv_atoms<VDP>(oacc, pa[jj], vst + jj * 16 * ROWB);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<VDP / 2>(oacc);
    }
    // the second warpgroup done with tile j refills its stage
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + warp / 4) : "memory");
#ifdef FLASH_RING_PROBE
    // the second warpgroup arrives late: the first runs as far ahead as
    // the waits let it
    if (tid == 128) __nanosleep(20000);
#endif
    if (tid % 128 == 0) {
      __threadfence_block();
      if ((atomicAdd(done + j % NSTAGE, 1) & 1) && j + NSTAGE < ntiles)
        load_tile(j + NSTAGE);
    }
  }
  // normalise, stage each warp's 16 rows in the (now idle) K/V ring, then
  // write 16-byte chunks
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
    inv[r] = 1.f / fmaxf(l_r[r], 1e-30f);
  }
  __syncthreads();  // every warpgroup is done with the ring
  __nv_bfloat16* Os =
      reinterpret_cast<__nv_bfloat16*>(smem + QBYTES) + warp * 16 * STR;
#pragma unroll
  for (int n = 0; n < VDP / 8; ++n) {
    const int col = n * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(Os + gid * STR + col) =
        __floats2bfloat162_rn(oacc[4 * n] * inv[0], oacc[4 * n + 1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Os + (gid + 8) * STR + col) =
        __floats2bfloat162_rn(oacc[4 * n + 2] * inv[1],
                              oacc[4 * n + 3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + int64_t(b) * S * orow + int64_t(h) * dv;
#pragma unroll
  for (int i = 0; i < 16 * CHV / 32; ++i) {
    const int c = lane + i * 32, r = c / CHV, d = (c % CHV) * 8;
    if (d < dv && wrow + r < S)
      *reinterpret_cast<uint4*>(ob + (wrow + r) * orow + d) =
          *reinterpret_cast<const uint4*>(Os + r * STR + d);
  }
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------
constexpr int FTHREADS = 128;
constexpr int FQ = 32;     // query rows per block
constexpr int FK = 32;     // keys per tile

// shared floats of the f32 path for NC columns a thread: Q and K tiles at
// an odd row stride, the V tile and the probabilities
constexpr size_t f32_smem_floats(int nc) {
  return size_t(FQ + FK) * (4 * nc + 1) + size_t(FK) * 4 * nc +
         FQ * (FK + 1);
}

// NC = output columns per thread (hd, dv <= 4*NC): thread t owns query
// row t / 4 and columns t % 4 + 4*i.
template <int NC>
__global__ void __launch_bounds__(FTHREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int T, int H, int KV, int hd, int dv, int causal,
                 int window, float scale) {
  constexpr int VSTR = 4 * NC;      // row stride of the V tile
  constexpr int FSTR = VSTR + 1;    // of the Q and K tiles: odd, no conflicts
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [FQ][FSTR]
  float* Ks = Qs + FQ * FSTR;                  // [FK][FSTR]
  float* Vs = Ks + FK * FSTR;                  // [FK][VSTR]
  float* Ps = Vs + FK * VSTR;                  // [FQ][FK + 1]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x, r = tid / 4, qc = tid % 4;
  const int64_t qrow = int64_t(H) * hd, krow = int64_t(KV) * hd;
  const int64_t vrow = int64_t(KV) * dv, orow = int64_t(H) * dv;
  const float* qb = q + int64_t(b) * S * qrow + int64_t(h) * hd;
  const float* kb = k + int64_t(b) * T * krow + int64_t(hk) * hd;
  const float* vb = v + int64_t(b) * T * vrow + int64_t(hk) * dv;

  for (int e = tid; e < FQ * hd; e += FTHREADS) {
    const int rr = e / hd, d = e % hd;
    Qs[rr * FSTR + d] = q0 + rr < S ? qb[(q0 + rr) * qrow + d] : 0.f;
  }

  const int row = q0 + r;
  float m = NEG_INF, l = 0.f;
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  const int kend = causal ? min(T, q0 + FQ) : T;
  // with a window, from the tile holding the first row's lowest key
  const int kstart = window ? max(0, q0 - window + 1) / FK * FK : 0;

  for (int k0 = kstart; k0 < kend; k0 += FK) {
    __syncthreads();
    for (int e = tid; e < FK * hd; e += FTHREADS) {
      const int rr = e / hd, d = e % hd;
      Ks[rr * FSTR + d] = k0 + rr < T ? kb[(k0 + rr) * krow + d] : 0.f;
    }
    for (int e = tid; e < FK * dv; e += FTHREADS) {
      const int rr = e / dv, d = e % dv;
      Vs[rr * VSTR + d] = k0 + rr < T ? vb[(k0 + rr) * vrow + d] : 0.f;
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
      if (key >= T || (causal && key > row) ||
          (window && key <= row - window))
        sv = NEG_INF;
      s[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
    // a row with no valid key yet folds against 0, so its masked p are 0
    const float mref = mx == NEG_INF ? 0.f : mx;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = expf(s[j] - mref);
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
        if (d < dv) acc[i] += p * Vs[j * VSTR + d];
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
      if (d < dv)
        o[(int64_t(b) * S + row) * orow + int64_t(h) * dv + d] = acc[i] / den;
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// (B, rows, heads, hd) bf16 in boxes of 64 head columns x box_rows rows of
// one head, 128-byte swizzled as the wgmma descriptors expect
bool tensor_map(CUtensorMap* map, const void* base, int B, int rows,
                int heads, int hd, int box_rows) {
  const auto encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads),
                              cuuint64_t(rows), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(hd) * 2,
                                 cuuint64_t(heads) * hd * 2,
                                 cuuint64_t(rows) * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KT, int VT, bool WIN>
int launch_bf16(dim3 grid, cudaStream_t stream, const void* q,
                const void* k, const void* v, void* o, int S, int T, int H,
                int KV, int hd, int dv, int causal, int window,
                float scale_log2) {
  constexpr int NA = (KT * 16 + 63) / 64, NAV = (VT * 16 + 63) / 64;
  CUtensorMap tq, tk, tv;
  const int B = int(grid.z);
  if (!tensor_map(&tq, q, B, S, H, hd, BQ) ||
      !tensor_map(&tk, k, B, T, KV, hd, BK) ||
      !tensor_map(&tv, v, B, T, KV, dv, BK))
    return int(cudaErrorInvalidValue);
  // the tiles, room to align them to 1024 bytes, and the barriers
  const size_t smem = 1024 +
                      size_t(ROWB) * (NA * BQ + NSTAGE * BK * (NA + NAV)) +
                      8 * (NSTAGE + 1) + 4 * NSTAGE;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<KT, VT, WIN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  flash_bf16_kernel<KT, VT, WIN><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, T, H, KV, hd, dv,
      causal, window, scale_log2);
  return int(cudaGetLastError());
}

template <int NC>
int launch_f32(dim3 grid, cudaStream_t stream, const void* q, const void* k,
               const void* v, void* o, int S, int T, int H, int KV, int hd,
               int dv, int causal, int window, float scale) {
  const size_t smem = sizeof(float) * f32_smem_floats(NC);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  flash_f32_kernel<NC><<<grid, FTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, T, H, KV, hd,
      dv, causal, window, scale);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. flags: bit 0 causal, bit 1 bf16
// (else f32); window: 0 for none, else the sliding window of a causal call.
// The wrapper guarantees hd, dv % 8 == 0, hd, dv <= 256, H % KV == 0,
// contiguous 16-byte-aligned tensors, S == T when causal and a window only
// when causal; in bf16, dv == hd or the (hd, dv) of the one instance that
// takes a narrower v. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int T, int H, int KV,
                               int hd, int dv, int flags, int window,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int causal = flags & 1;
  if (window < 0 || (window && !causal)) return int(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(float(hd));
  if (flags & 2) {
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    const float sl2 = scale * LOG2E;
#define BF16(KT, VT, WIN)                                                \
  launch_bf16<KT, VT, WIN>(grid, s, q, k, v, o, S, T, H, KV, hd, dv, causal, \
                           window, sl2)
    // a narrower v: MLA's prefill (hd 192, dv 128), in the instance of
    // three Q/K atoms and two V atoms, zero columns padding both
    if (dv != hd) {
      const int kt = (hd + 15) / 16;
      if (!window && kt > 8 && kt <= 12 && (dv + 15) / 16 == 8)
        return BF16(12, 8, false);
      return int(cudaErrorInvalidValue);
    }
    // windowed calls take four instances, their head dim padded with zero
    // columns (the TMA fills them) to 64, 128, 192 or 256
    if (window) switch ((hd + 63) / 64) {
      case 1: return BF16(4, 4, true);
      case 2: return BF16(8, 8, true);
      case 3: return BF16(12, 12, true);
      case 4: return BF16(16, 16, true);
      default: return int(cudaErrorInvalidValue);
    }
    switch ((hd + 15) / 16) {
      case 1: return BF16(1, 1, false);
      case 2: return BF16(2, 2, false);
      case 3: return BF16(3, 3, false);
      case 4: return BF16(4, 4, false);
      case 5: return BF16(5, 5, false);
      case 6: return BF16(6, 6, false);
      case 7: return BF16(7, 7, false);
      case 8: return BF16(8, 8, false);
      // wider heads in whole 64-column atoms
      case 9: case 10: case 11: case 12: return BF16(12, 12, false);
      case 13: case 14: case 15: case 16: return BF16(16, 16, false);
      default: return int(cudaErrorInvalidValue);
    }
#undef BF16
  }
  const dim3 grid((S + FQ - 1) / FQ, H, B);
#define F32(NC)                                                          \
  launch_f32<NC>(grid, s, q, k, v, o, S, T, H, KV, hd, dv, causal, window, \
                 scale)
  const int wide = hd > dv ? hd : dv;  // a thread's columns cover both
  if (wide <= 32) return F32(8);
  if (wide <= 64) return F32(16);
  if (wide <= 128) return F32(32);
  if (wide <= 256) return F32(64);
#undef F32
  return int(cudaErrorInvalidValue);
}

#ifdef FLASH_RING_PROBE
// the probe build's count of waits that gave up: read, then set to 0
extern "C" int flash_probe_unmet_take(unsigned* out) {
  const unsigned zero = 0;
  cudaError_t e = cudaMemcpyFromSymbol(out, flash_probe_unmet,
                                       sizeof(unsigned));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(flash_probe_unmet, &zero, sizeof(unsigned));
  return int(e);
}
#endif
