// Fused MIFA server step for Hopper (sm_90a), one launch over a whole tree.
//
// Replaces the TPU kernel repro/kernels/mifa_aggregate.py (_kernel and its
// pallas_call in _mifa_aggregate). For every leaf of a parameter tree, with
// G (N, M) in the memory dtype, fresh updates U (N, M) f32, the round's
// active mask (N,) shared by all leaves, and weights w (M,):
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
//   * One launch per tree (leaf_table.cuh). The grid is every leaf's
//     128-column tiles back to back; a block finds its leaf in the table,
//     which rides in the kernel's parameters. Per-leaf launches cost about
//     4 us each on paper_mlp's narrow leaves, which move almost no bytes.
//   * G is updated IN PLACE and only where it changes: an inactive row is
//     read from G and never written, and its U row is never read. The TPU
//     kernel streams both G and U for every row; this moves N*M + |A|*M
//     elements instead of 3*N*M.
//   * Bytes in flight without registers: the active mask is staged once
//     per block in shared memory, and each thread copies its rows'
//     16-byte segments (8 bytes for a bf16 G row) into its own slots of a
//     shared-memory ring with cp.async, STAGES x STAGE_ROWS rows ahead of
//     the rows it adds. A row's source (U if active, else G) is picked
//     from the staged flag when the copy is issued. The copies hold no
//     registers, so 64 registers a thread suffice and four blocks fit an
//     SM: paper_mlp's 397 tiles run in one wave. A thread reads back only
//     its own slots, so the ring needs no barrier.
//   * The column axis is spread over threads, 4 adjacent columns each, so a
//     warp reads 128 consecutive columns of a row with 16-byte (f32) or
//     8-byte (bf16) copies. The row axis is split over 8 row groups inside
//     the block; each group adds its rows in increasing order and
//     the groups' f32 partial sums meet in shared memory in a fixed order,
//     so w_new repeats bit for bit on one card (no atomics).
//   * The kernel masks the ragged column edge itself; the caller pads
//     nothing and copies no leaf. A leaf whose width is not a multiple of 4
//     (or whose pointers are not aligned for vector access) takes the
//     scalar walk, with a warp on 32 consecutive columns.
//   * Element types are per leaf (table flags), so a tree may mix f32 and
//     bf16 leaves. It allocates nothing: the wrapper allocates w_new.
#include "leaf_table.cuh"

namespace {

using repro::COLS_PER_BLOCK;
using repro::Leaf;
using repro::LeafTable;
using repro::TX;
using repro::VEC;

constexpr int ROW_GROUPS = repro::TY;     // row groups (warps) of a block
constexpr int THREADS = TX * ROW_GROUPS;
constexpr int MIN_BLOCKS = 4;             // blocks an SM: the 397 blocks of
                                          // paper_mlp's tree in one wave
constexpr int STAGE_ROWS = 4;             // rows a thread copies a ring stage
constexpr int STAGES = 2;                 // ring stages a thread has in flight
constexpr int UNROLL_SCALAR = 4;          // rows in flight on the scalar walk
constexpr int MASK_ROWS = 4096;           // active flags staged per pass

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// A thread's 4 columns of a row into its 16-byte ring slot: 16 bytes of f32
// (U, or f32 G) or 8 bytes of bf16 G.
__device__ __forceinline__ void cp_async(uint4* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async(uint4* dst,
                                         const __nv_bfloat16* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A row's values from its slot: U's f32 if the row is active, else G's.
template <typename TG>
__device__ __forceinline__ void read_slot(const uint4* slot, bool a,
                                          float v[VEC]) {
  if (a || sizeof(TG) == 4)
    repro::load4(reinterpret_cast<const float*>(slot), v);
  else
    repro::load4(reinterpret_cast<const __nv_bfloat16*>(slot), v);
}

// The 4-wide walk (m % 4 == 0, aligned rows) over rows [base, base + rows)
// of one tile, flags in act (shared). Thread (tx, ty) owns columns col ..
// col + 3 and rows ty + q*ROW_GROUPS, q = 0, 1, ...; it copies them into
// its own slots of a STAGES-deep ring, STAGE_ROWS rows a stage, with
// cp.async: the copies need no registers while in flight, so a thread has
// STAGES * STAGE_ROWS rows in flight under the 64-register cap that puts
// four blocks on an SM. Each thread reads back only its own slots, so the
// ring needs no barrier. Rows are added in increasing order into acc.
template <typename TG>
__device__ __forceinline__ void walk_vector(const float* __restrict__ u,
                                            TG* __restrict__ g,
                                            const uint8_t* act, uint4* ring,
                                            int base, int rows, int64_t m,
                                            int64_t col, float acc[VEC]) {
  if (col >= m) return;  // m % 4 == 0: a thread's 4 columns are all in or out
  const int ty = threadIdx.y;
  uint4* mine = ring + ty * TX + threadIdx.x;
  const int nq = ty < rows ? (rows - ty + ROW_GROUPS - 1) / ROW_GROUPS : 0;
  const int chunks = (nq + STAGE_ROWS - 1) / STAGE_ROWS;
  auto issue = [&](int chunk) {
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k) {
      const int q = chunk * STAGE_ROWS + k;
      if (q < nq) {
        const int i = ty + q * ROW_GROUPS;
        const int64_t off = int64_t(base + i) * m + col;
        uint4* slot = mine + ((chunk % STAGES) * STAGE_ROWS + k) * THREADS;
        if (act[i])
          cp_async(slot, u + off);
        else
          cp_async(slot, g + off);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int c = 0; c < STAGES; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 1>();  // chunk c has landed
#pragma unroll
    for (int k = 0; k < STAGE_ROWS; ++k) {
      const int q = c * STAGE_ROWS + k;
      if (q < nq) {
        const int i = ty + q * ROW_GROUPS;
        const bool a = act[i] != 0;
        float v[VEC];
        read_slot<TG>(mine + ((c % STAGES) * STAGE_ROWS + k) * THREADS, a, v);
        if (a) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) v[j] = repro::round_to<TG>(v[j]);
          repro::store4(g + int64_t(base + i) * m + col, v);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += v[j];
      }
    }
    issue(c + STAGES);  // into the slots just read
  }
  cp_async_wait<0>();
}

// The scalar walk (a ragged or unaligned leaf): thread tx owns columns
// tile_col0 + j*TX + tx, j < VEC, so a warp reads 32 consecutive columns;
// row group ty takes rows ty, ty + ROW_GROUPS, ... in increasing order,
// UNROLL_SCALAR at a time: first the loads, then the writes and the adds.
template <typename TG>
__device__ __forceinline__ void walk_scalar(const float* __restrict__ u,
                                            TG* __restrict__ g,
                                            const uint8_t* act, int base,
                                            int rows, int64_t m,
                                            int64_t tile_col0,
                                            float acc[VEC]) {
  const int tx = threadIdx.x;
  for (int i0 = threadIdx.y; i0 < rows; i0 += ROW_GROUPS * UNROLL_SCALAR) {
    float v[UNROLL_SCALAR][VEC];
    bool a[UNROLL_SCALAR];
#pragma unroll
    for (int k = 0; k < UNROLL_SCALAR; ++k) {
      const int i = i0 + k * ROW_GROUPS;
      a[k] = i < rows && act[i] != 0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int64_t col = tile_col0 + j * TX + tx;
        if (i < rows && col < m) {
          const int64_t off = int64_t(base + i) * m + col;
          v[k][j] = a[k] ? u[off] : repro::to_f32(g[off]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL_SCALAR; ++k) {
      const int i = i0 + k * ROW_GROUPS;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int64_t col = tile_col0 + j * TX + tx;
        if (i < rows && col < m) {
          if (a[k]) {
            const TG s = repro::from_f32<TG>(v[k][j]);
            g[int64_t(base + i) * m + col] = s;
            v[k][j] = repro::to_f32(s);
          }
          acc[j] += v[k][j];
        }
      }
    }
  }
}

template <typename TG>
__device__ __forceinline__ void walk_leaf(const Leaf& leaf, bool vector,
                                          const uint8_t* act, uint4* ring,
                                          int base, int rows,
                                          int64_t tile_col0, float acc[VEC]) {
  const auto* u = static_cast<const float*>(leaf.ptr[0]);
  auto* g = static_cast<TG*>(leaf.ptr[1]);
  if (vector)
    walk_vector<TG>(u, g, act, ring, base, rows, leaf.m,
                    tile_col0 + threadIdx.x * VEC, acc);
  else
    walk_scalar<TG>(u, g, act, base, rows, leaf.m, tile_col0, acc);
}

// w[c] as f32, loaded before the walk so its latency hides behind it
__device__ __forceinline__ float load_w(const Leaf& leaf, int64_t c) {
  if (leaf.flags & repro::LEAF_W_BF16)
    return repro::to_f32(static_cast<const __nv_bfloat16*>(leaf.ptr[2])[c]);
  return static_cast<const float*>(leaf.ptr[2])[c];
}

// w_new[c] = w[c] - eta * mean, unfused multiply and subtract, rounded as
// the plain version rounds.
template <typename TW>
__device__ __forceinline__ void step_w(const Leaf& leaf, int64_t c, float w,
                                       float eta, float mean) {
  static_cast<TW*>(leaf.ptr[3])[c] =
      repro::from_f32<TW>(__fsub_rn(w, __fmul_rn(eta, mean)));
}

// Leaf pointers: ptr[0] U (N, M) f32, ptr[1] G (N, M), ptr[2] w (M,),
// ptr[3] w_new (M,). One block per 128-column tile of the table's leaves.
__global__ void __launch_bounds__(TX * ROW_GROUPS, MIN_BLOCKS)
mifa_aggregate_kernel(const __grid_constant__ LeafTable table,
                      const uint8_t* __restrict__ active, int n,
                      const float* __restrict__ eta_ptr) {
  __shared__ uint4 ring[STAGES * STAGE_ROWS * THREADS];
  __shared__ uint8_t act[MASK_ROWS];
  __shared__ float partial[ROW_GROUPS][COLS_PER_BLOCK];
  const Leaf& leaf = table.leaf[repro::find_leaf(table, blockIdx.x)];
  const int64_t tile_col0 =
      int64_t(blockIdx.x - leaf.first_tile) * COLS_PER_BLOCK;
  const bool vector = (leaf.flags & repro::LEAF_VECTOR) != 0;
  const int tid = threadIdx.y * TX + threadIdx.x;
  // thread tid < COLS_PER_BLOCK finishes column tile_col0 + tid
  const int64_t c = tile_col0 + tid;
  const bool finishes = tid < COLS_PER_BLOCK && c < leaf.m;
  const float w = finishes ? load_w(leaf, c) : 0.f;
  // the learning rate lives on the card, so a captured launch reads the
  // round's rate rather than the one it was captured with
  const float eta = finishes ? *eta_ptr : 0.f;

  float acc[VEC] = {0.f, 0.f, 0.f, 0.f};
  for (int base = 0; base < n; base += MASK_ROWS) {
    const int rows = min(MASK_ROWS, n - base);
    __syncthreads();  // the previous pass is done with act
    for (int i = tid; i < rows; i += THREADS) act[i] = active[base + i];
    __syncthreads();
    if (leaf.flags & repro::LEAF_A_BF16)
      walk_leaf<__nv_bfloat16>(leaf, vector, act, ring, base, rows, tile_col0,
                               acc);
    else
      walk_leaf<float>(leaf, vector, act, ring, base, rows, tile_col0, acc);
  }

  // partial[y][p] is row group y's sum of column tile_col0 + p
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    partial[threadIdx.y][vector ? threadIdx.x * VEC + j
                                : j * TX + threadIdx.x] = acc[j];
  __syncthreads();
  if (finishes) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < ROW_GROUPS; ++y) s += partial[y][tid];
    const float mean = s / float(n);
    if (leaf.flags & repro::LEAF_W_BF16)
      step_w<__nv_bfloat16>(leaf, c, w, eta, mean);
    else
      step_w<float>(leaf, c, w, eta, mean);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes: one launch over the table's
// leaves (table->n_tiles blocks). The table is copied into the launch's
// parameters, so the caller's copy may go once this returns. active (n,)
// bool; eta one f32 on the card. Returns cudaGetLastError() after the
// launch.
extern "C" int mifa_aggregate(const LeafTable* table, const void* active,
                              int n, const void* eta, void* stream) {
  // the ring, mask and partial sums take 40 KB a block: ask for the
  // largest shared-memory carveout so that four blocks fit an SM
  static const cudaError_t carveout = cudaFuncSetAttribute(
      mifa_aggregate_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      int(cudaSharedmemCarveoutMaxShared));
  if (carveout != cudaSuccess) return int(carveout);
  mifa_aggregate_kernel<<<unsigned(table->n_tiles), dim3(TX, ROW_GROUPS), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      *table, static_cast<const uint8_t*>(active), n,
      static_cast<const float*>(eta));
  return int(cudaGetLastError());
}
