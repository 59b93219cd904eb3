// Weight-only int8 matmul (K8), sm_90a: out[M, N] = bf16((a[M, K] @ w8[K, N])
// * scale[N]) with a bf16, w8 int8 and scale f32 per output column, the sum
// in f32 and the scale applied once at the end.
//
// Replaces deepspeed_tpu/ops/pallas/quantized_matmul.py quantized_matmul
// (:82, body _qmm_kernel :64), which is the function of the v2 engine's
// int8 _mm (deepspeed_tpu/inference/v2/ragged_model.py:422-426).
//
// Two kernels, by M:
//
// qmm_gemv (M <= 8, the decode step): bound by the weight stream, K*N bytes
// (half of bf16's; a quarter with packed int4, which the same body reads
// in the kernel): 70.8 MB at Llama-2-13B's gate/up (5120 -> 13824), 0.021
// ms at 3.35 TB/s, against 2*M*K*N = 0.57 GFLOP at M = 4. A block of 8
// warps owns 128 columns and one split of K; the grid is one wave of about
// two blocks an SM (the wrapper's gemv_splits, from the SM count). Each
// lane keeps 8 16-byte weight loads in flight (two 16-row steps of int8,
// four of int4; 32 KB a block), issued first, with a's few words read
// beside them from L1/L2: no prologue stages a. Weight bytes become exact
// bf16 by byte permutes (int8 through f32: 2^23 + (b + 128); int4 as 0x4300
// | n in bf16, less 136), not I2F, and feed mma.sync m16n8k16 as the A
// operand, with a's <= 8 rows, zero-padded, as the n8 B operand. The K
// splits' f32 partial sums go to `work`, and the last block of each column
// group to finish (a counter per column group) adds them in split order,
// scales and writes bf16: one launch, no value atomics, the same sums in
// the same order on every run, and the same for packed int4 as for its
// unpacked int8 values.
//
// qmm_mma (M > 8, the prefill passes): bound by operations at M = 736
// (2*M*K*N flops against K*N + 2*M*(K+N) bytes: 104 GFLOP = 105 us at 989
// TFLOP/s against 99 MB = 29 us at Llama-2-13B's gate/up, 5120 -> 13824).
// Hopper's warp-specialised GEMM: a block of three warpgroups owns 128
// output columns and TM = 128 or 256 tokens. A producer thread keeps a
// 4-stage ring of TMA loads in flight (a's bf16 [TM][64] tile and w8's
// int8 [64][128] tile, both with the 128-byte swizzle, completing on
// mbarriers; TMA zero-fills rows past M and columns past K). Two consumer
// warpgroups of 64 columns each run wgmma m64n128k16 (bf16 x bf16 -> f32)
// with the weight as the A operand from registers: each stage's int8 tile
// is read from shared memory, its k pairs gathered with byte permutes and
// converted to bf16 exactly (|w8| <= 127) on the way (wgmma takes no mixed
// types, and no bf16 copy of the weight is stored), and a's tile is the B
// operand, K-major in shared memory (out^T = w8^T . a^T). A consumer
// converts the next stage's tile while the current stage's products run
// (two fragment buffers; wgmma.wait_group 1 releases a stage). The epilogue
// scales in f32, rounds to bf16, stages the tile in shared memory and
// stores 16-byte rows.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"  // mma16816, kernel_attributes

namespace dstorch {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------- //
// GEMV-shaped: M <= 8
// ---------------------------------------------------------------------- //

constexpr int kGvWarps = 8;
constexpr int kGvCols = 128;     // columns a block: 16 per lane group g
constexpr int kGvStep = 16;      // K rows a warp step: one m16n8k16 product's depth
constexpr int kGvInFlight = 8;   // 16-byte weight loads in flight a thread

// bytes 2 HALF and 2 HALF + 1 of `u` (int8 values + 128, as unsigned) as a
// bf16 pair, low half first; exact for |b| <= 128
template <int HALF>
__device__ __forceinline__ uint32_t biased_i8x2_to_bf16x2(uint32_t u) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + 2 * HALF));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + 2 * HALF));
  __nv_bfloat162 v = __floats2bfloat162_rn(f0 - 8388736.f, f1 - 8388736.f);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the low nibbles of bytes 0 and 2 of `u` (int4 values + 8, as unsigned)
// as a bf16 pair, low half first: 128 + n in bf16 is 0x4300 | n, less 136
// (0x4308); exact
__device__ __forceinline__ uint32_t biased_i4x2_to_bf16x2(uint32_t u) {
  const uint32_t x = (u & 0x000F000Fu) | 0x43004300u, bias = 0x43084308u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                             *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 weight bytes, streamed: read once, kept out of L1
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// a's two bf16 at columns k, k + 1 of row m (0 past the split's end)
__device__ __forceinline__ uint32_t a_pair(const bf16* a, int m, int K, int k, int k_hi) {
  return k < k_hi ? __ldg(reinterpret_cast<const unsigned int*>(a + (size_t)m * K + k)) : 0u;
}

// One warp's share of a block's K split [k_lo, k_hi) for 128 columns:
// the 16-row steps w, w + 8, ... as m16n8k16 products with the weight as A
// and a's first m_rows (<= 8) rows as B (tokens as n, zero from m_rows on),
// its k order permuted so that each A register pairs rows k and k + 8 of
// one column: lane (g, t) loads rows 2t, 2t + 1, 2t + 8, 2t + 9 (int4:
// packed rows t and t + 4, whose low and high nibbles are those four rows)
// of columns 16g .. 16g + 15 with 16-byte loads, and A fragment j (columns
// 16g + 2j, + 1 as rows g, g + 8) takes bytes 2j and 2j + 1 of them; B
// pairs a's k and k + 8 the same way. acc [j][0..3]: columns 16g + 2j (0,
// 1) and + 1 (2, 3), tokens 2t, 2t + 1.
template <bool INT4>
__device__ __forceinline__ void gemv_steps(float (&acc)[8][4], const bf16* __restrict__ a,
                                           int m_rows, const int8_t* __restrict__ w, int K,
                                           int N, int col, bool col_ok, int k_lo, int k_hi,
                                           int warp, int g, int t) {
  constexpr int NL = INT4 ? 2 : 4;          // 16-byte loads a step
  constexpr int U = kGvInFlight / NL;       // steps loaded together
  const int n_steps = (k_hi - k_lo + kGvStep - 1) / kGvStep;
  for (int s0 = warp; s0 < n_steps; s0 += kGvWarps * U) {
    uint4 wv[U][NL];
    uint32_t av[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k0 = k_lo + kGvStep * (s0 + kGvWarps * u);
#pragma unroll
      for (int r = 0; r < NL; ++r) {
        // int8: rows 2t, 2t + 1, 2t + 8, 2t + 9; int4: packed rows t, t + 4
        const int row = INT4 ? k0 / 2 + t + 4 * r : k0 + 2 * t + (r & 1) + 8 * (r >> 1);
        const bool ok = col_ok && (INT4 ? 2 * row : row) < k_hi;
        wv[u][r] = ok ? ld_stream16(w + (size_t)row * N + col) : make_uint4(0, 0, 0, 0);
      }
      av[u][0] = g < m_rows ? a_pair(a, g, K, k0 + 2 * t, k_hi) : 0u;
      av[u][1] = g < m_rows ? a_pair(a, g, K, k0 + 2 * t + 8, k_hi) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + kGvWarps * u >= n_steps) break;
      // B: a's k pairs (2t, 2t + 8) and (2t + 1, 2t + 9)
      const uint32_t b0 = __byte_perm(av[u][0], av[u][1], 0x5410);
      const uint32_t b1 = __byte_perm(av[u][0], av[u][1], 0x7632);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = j >> 1, b = 2 * (j & 1);
        uint32_t af[4];
        if constexpr (INT4) {
          // [lo row t, lo row t + 4 | hi ...] of columns 2j, 2j + 1
          const uint32_t x = __byte_perm(word(wv[u][0], q), word(wv[u][1], q),
                                         b | (b + 1) << 4 | (b + 4) << 8 | (b + 5) << 12) ^
                             0x88888888u;
          af[0] = biased_i4x2_to_bf16x2(x);        // column 2j: rows 2t, 2t + 8
          af[1] = biased_i4x2_to_bf16x2(x >> 8);   // column 2j + 1
          af[2] = biased_i4x2_to_bf16x2(x >> 4);   // column 2j: rows 2t + 1, 2t + 9
          af[3] = biased_i4x2_to_bf16x2(x >> 12);  // column 2j + 1
        } else {
          const int sel = b | (b + 4) << 4 | (b + 1) << 8 | (b + 5) << 12;
          // bytes of columns 2j, 2j + 1: [row 2t, row 2t + 8, ...] and
          // [row 2t + 1, row 2t + 9, ...]
          const uint32_t lo = __byte_perm(word(wv[u][0], q), word(wv[u][2], q), sel) ^
                              0x80808080u;
          const uint32_t hi = __byte_perm(word(wv[u][1], q), word(wv[u][3], q), sel) ^
                              0x80808080u;
          af[0] = biased_i8x2_to_bf16x2<0>(lo);
          af[1] = biased_i8x2_to_bf16x2<1>(lo);
          af[2] = biased_i8x2_to_bf16x2<0>(hi);
          af[3] = biased_i8x2_to_bf16x2<1>(hi);
        }
        mma::mma16816(acc[j], af, b0, b1);
      }
    }
  }
}

// out[M, N] = bf16((a . w) * scale) for M <= 8, w int8 [K][N] or packed
// int4 [K/2][N] (INT4). A block owns 128 columns and one split of K (grid
// y); its 8 warps take the split's 16-row steps in turn (gemv_steps). The
// warps' sums meet in shared memory (added in warp order), a split's sums
// in `work`, added in split order by the column group's last block.
template <int M, bool INT4>
__global__ void __launch_bounds__(kGvWarps * 32, 2)
qmm_gemv_kernel(const bf16* __restrict__ a, const int8_t* __restrict__ w,
                const float* __restrict__ scale, bf16* __restrict__ out,
                float* __restrict__ work, int* __restrict__ counters, int K, int N,
                int rows_per_split, int n_splits) {
  __shared__ __align__(16) float red[kGvWarps * M * kGvCols];
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kGvCols, col = n0 + 16 * g;
  const bool col_ok = col < N;  // N % 16 == 0: a lane's 16 columns are all in or out
  const int split = blockIdx.y;
  const int k_lo = split * rows_per_split;
  const int k_hi = min(K, k_lo + rows_per_split);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  gemv_steps<INT4>(acc, a, M, w, K, N, col, col_ok, k_lo, k_hi, warp, g, t);

  // the warps' sums, [warp][m][column], then added in warp order
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * t + (e & 1), c = 16 * g + 2 * j + (e >> 1);
      if (m < M) red[(warp * M + m) * kGvCols + c] = acc[j][e];
    }
  __syncthreads();
  for (int i = tid; i < M * kGvCols; i += kGvWarps * 32) {
    float sum = red[i];
#pragma unroll
    for (int wi = 1; wi < kGvWarps; ++wi) sum += red[wi * M * kGvCols + i];
    red[i] = sum;   // warp 0's slot: read back only by this thread
  }
  const int n_cols = min(kGvCols, N - n0);
  if (n_splits == 1) {
    for (int i = tid; i < M * kGvCols; i += kGvWarps * 32) {
      const int m = i / kGvCols, c = i - (i / kGvCols) * kGvCols;
      if (c < n_cols) out[(size_t)m * N + n0 + c] = __float2bfloat16(red[i] * scale[n0 + c]);
    }
    return;
  }
  for (int i = tid; i < M * kGvCols; i += kGvWarps * 32) {
    const int m = i / kGvCols, c = i - (i / kGvCols) * kGvCols;
    if (c < n_cols) work[((size_t)split * M + m) * N + n0 + c] = red[i];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + blockIdx.x, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < M * kGvCols; i += kGvWarps * 32) {
    const int m = i / kGvCols, c = i - (i / kGvCols) * kGvCols;
    if (c >= n_cols) continue;
    float sum = 0.f;
    for (int sp = 0; sp < n_splits; ++sp)
      sum += __ldcg(work + ((size_t)sp * M + m) * N + n0 + c);
    out[(size_t)m * N + n0 + c] = __float2bfloat16(sum * scale[n0 + c]);
  }
  if (tid == 0) counters[blockIdx.x] = 0;   // ready for the next launch
}

// The grouped gemv (an MoE layer's expert products at decode sizes): rows
// of a [R, K] sorted by expert, expert e's rows [ends[e - 1], ends[e]),
// each times its expert's weight w [E][K][N] int8 and scale [E][N]. A
// block owns (128 columns, one K split, expert e) (grid x, y, z) and reads
// that expert's weight columns once for up to 8 of its rows (gemv_steps),
// looping over them in groups of 8; a block whose expert has no rows exits
// before it reads a byte, so a decode step streams only the routed
// experts' weights. Split sums go to `work` [n_splits][R][N] and the
// (expert, column group)'s last block adds them in split order (counters
// [E][gridDim.x], left 0), as qmm_gemv_kernel does.
__global__ void __launch_bounds__(kGvWarps * 32, 2)
qmm_gemv_grouped_kernel(const bf16* __restrict__ a, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, const int* __restrict__ ends,
                        bf16* __restrict__ out, float* __restrict__ work,
                        int* __restrict__ counters, int R, int K, int N, int rows_per_split,
                        int n_splits) {
  constexpr int MG = 8;   // rows a pass over the weight
  __shared__ __align__(16) float red[kGvWarps * MG * kGvCols];
  __shared__ int is_last;
  const int e = blockIdx.z;
  const int r0 = e == 0 ? 0 : ends[e - 1], r1 = ends[e];
  if (r0 >= r1) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kGvCols, col = n0 + 16 * g;
  const bool col_ok = col < N;
  const int split = blockIdx.y;
  const int k_lo = split * rows_per_split;
  const int k_hi = min(K, k_lo + rows_per_split);
  const int n_cols = min(kGvCols, N - n0);
  const int8_t* we = w + (size_t)e * K * N;
  const float* se = scale + (size_t)e * N;

  for (int rg = r0; rg < r1; rg += MG) {
    const int m_rows = min(MG, r1 - rg);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    gemv_steps<false>(acc, a + (size_t)rg * K, m_rows, we, K, N, col, col_ok, k_lo, k_hi,
                      warp, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = 2 * t + (q & 1), c = 16 * g + 2 * j + (q >> 1);
        if (m < m_rows) red[(warp * MG + m) * kGvCols + c] = acc[j][q];
      }
    __syncthreads();
    for (int i = tid; i < m_rows * kGvCols; i += kGvWarps * 32) {
      const int m = i / kGvCols, c = i - m * kGvCols;
      float sum = red[i];
#pragma unroll
      for (int wi = 1; wi < kGvWarps; ++wi) sum += red[wi * MG * kGvCols + i];
      if (c >= n_cols) continue;
      if (n_splits == 1)
        out[(size_t)(rg + m) * N + n0 + c] = __float2bfloat16(sum * se[n0 + c]);
      else
        work[((size_t)split * R + rg + m) * N + n0 + c] = sum;
    }
    __syncthreads();   // red is the next group's
  }
  if (n_splits == 1) return;
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)e * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < (r1 - r0) * kGvCols; i += kGvWarps * 32) {
    const int m = r0 + i / kGvCols, c = i % kGvCols;
    if (c >= n_cols) continue;
    float sum = 0.f;
    for (int sp = 0; sp < n_splits; ++sp)
      sum += __ldcg(work + ((size_t)sp * R + m) * N + n0 + c);
    out[(size_t)m * N + n0 + c] = __float2bfloat16(sum * se[n0 + c]);
  }
  if (tid == 0) *counter = 0;   // ready for the next launch
}

// ---------------------------------------------------------------------- //
// tensor-core tiles: M > 8 (wgmma fed by a TMA ring)
// ---------------------------------------------------------------------- //
//
// The block computes out^T[n][m] = sum_k w8[k][n] a[m][k] for 128 columns n
// and TM tokens m: the weight is wgmma's A operand (64 rows n a consumer
// warpgroup, from registers: int8 cannot be a bf16 operand in shared
// memory) and a's tile is its B operand, read by wgmma from shared memory
// where TMA put it K-major with the 128-byte swizzle (b-descriptor below).
//
// A-fragment rows are permuted: row 16 w + g of consumer warpgroup c holds
// column n = 64 c + 16 w + 2 g and row 16 w + g + 8 holds n + 1, so that
// a thread's two rows are one 16-bit pair of the [k][n] int8 tile; four
// 16-bit reads (k = 2t, 2t + 1, 2t + 8, 2t + 9 of a 16-deep step) and two
// byte permutes gather the k pairs of both rows, and each byte becomes an
// exact bf16 through f32 (2^23 + (b + 128) has b + 128 in its low byte).
// The accumulator then holds, for token m, the column pair (n, n + 1).

constexpr int kQmmBN = 128;       // output columns a block
constexpr int kQmmBK = 64;        // K depth of a stage: one 128-byte bf16 row of a
constexpr int kQmmStages = 4;
constexpr int kQmmThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kQmmEpiRow = 72;    // bf16 row of the epilogue's [TM][64] tile (padded)

template <int TM>
struct QmmCfg {
  static constexpr int a_bytes = TM * kQmmBK * 2;      // bf16 [TM][64]
  static constexpr int w_bytes = kQmmBK * kQmmBN;      // int8 [64][128]
  static constexpr int stage_bytes = a_bytes + w_bytes;
  static constexpr int ring_bytes = kQmmStages * stage_bytes;
  // 1024 bytes of slack to align the ring (the swizzle's period), then the
  // full and empty barriers
  static constexpr size_t smem_bytes = 1024 + ring_bytes + 2 * kQmmStages * 8;
  static_assert(2 * TM * kQmmEpiRow * 2 <= ring_bytes, "epilogue tile exceeds the ring");
  static_assert(TM % 128 == 0 && TM <= 256, "TM is 128 or 256");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 inner, c1 outer) of `map` into dst, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows and
// the 128-byte swizzle (8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// keep the compiler from moving accumulator registers across wgmma
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d [64 x 128] += A [64 x 16] (registers) . B [16 x 128] (shared, desc)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// TMA: the box at (c0, c1, c2) of a 3-D `map` into dst, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// GROUPED (an MoE layer's expert products at prefill sizes): a's rows are
// sorted by expert, expert e's rows [ends[e - 1], ends[e]) of M, w_map is
// 3-D over w8 [E][K][N] and scale is [E][N]. Block x takes tile x of the
// schedule that the block reads from `ends` itself: each expert's rows in
// tiles of TM, experts in order; the grid is its upper bound ceil(M / TM)
// + E, and blocks past the schedule's end exit at once. A tile's rows past
// its expert's end belong to the next expert (or lie past M, zero-filled
// by TMA): they are computed and not stored.
template <int TM, bool GROUPED>
__global__ void __launch_bounds__(kQmmThreads, 1)
qmm_mma_kernel(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap w_map, const float* __restrict__ scale,
               bf16* __restrict__ out, int M, int K, int N, const int* __restrict__ ends,
               int E) {
  using Cfg = QmmCfg<TM>;
  int m0 = blockIdx.x * TM, m_end = M, e = 0;
  if constexpr (GROUPED) {
    int tile = blockIdx.x, start = 0;
    for (e = 0; e < E; ++e) {
      const int end = ends[e], n = (end - start + TM - 1) / TM;
      if (tile < n) break;
      tile -= n;
      start = end;
    }
    if (e == E) return;
    m0 = start + tile * TM;
    m_end = ends[e];
    scale += (size_t)e * N;
  }
  constexpr int NSUB = TM / 128;  // m64n128 products a 16-deep step
  extern __shared__ uint8_t qmm_smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(qmm_smem) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Cfg::ring_bytes);
  uint64_t* empty = full + kQmmStages;
  auto a_tile = [=](int s) { return ring + s * Cfg::stage_bytes; };
  auto w_tile = [=](int s) { return ring + s * Cfg::stage_bytes + Cfg::a_bytes; };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.y * kQmmBN;
  const int n_k = (K + kQmmBK - 1) / kQmmBK;
  if (tid == 0) {
    for (int s = 0; s < kQmmStages; ++s) {
      mbar_init(full + s, 1);   // the producer's arrive; the bytes complete it
      mbar_init(empty + s, 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kQmmStages;
        mbar_wait(empty + s, ((i / kQmmStages) & 1) ^ 1);
        mbar_expect_tx(full + s, Cfg::stage_bytes);
        tma_load_2d(a_tile(s), &a_map, full + s, i * kQmmBK, m0);
        if constexpr (GROUPED)
          tma_load_3d(w_tile(s), &w_map, full + s, n0, i * kQmmBK, e);
        else
          tma_load_2d(w_tile(s), &w_map, full + s, n0, i * kQmmBK);
      }
    }
    return;
  }

  // consumers: warpgroup c owns columns n0 + 64 c .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nl = 64 * c + 16 * warp + 2 * g;  // the thread's column pair in the block
  // acc[j]: tokens 128 j + 8 q + 2 t + e, column n at [4 q + e], n + 1 at
  // [4 q + 2 + e]
  float acc[NSUB][64];
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;

  // stage s's weight tile as the A fragments of its four 16-deep steps
  auto convert = [&](uint32_t (&af)[4][4], int s) {
    const uint8_t* wt = w_tile(s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = 16 * kk + 2 * t + (j & 1) + 8 * (j >> 1);
        // the 128-byte swizzle: chunk nl / 16 of row kr sits at chunk
        // (nl / 16) ^ (kr % 8)
        x[j] = *reinterpret_cast<const uint16_t*>(
            wt + kr * kQmmBN + ((((nl >> 4) ^ (kr & 7)) << 4) | (nl & 15)));
      }
      // bytes (n k, n k+1, n+1 k, n+1 k+1) for k = 2t and k = 2t + 8
      const uint32_t lo = __byte_perm(x[0], x[1], 0x5140) ^ 0x80808080u;
      const uint32_t hi = __byte_perm(x[2], x[3], 0x5140) ^ 0x80808080u;
      af[kk][0] = biased_i8x2_to_bf16x2<0>(lo);  // row g (n), k 2t, 2t + 1
      af[kk][1] = biased_i8x2_to_bf16x2<1>(lo);  // row g + 8 (n + 1)
      af[kk][2] = biased_i8x2_to_bf16x2<0>(hi);  // row g, k 2t + 8, 2t + 9
      af[kk][3] = biased_i8x2_to_bf16x2<1>(hi);
    }
  };
  // k-step i: its products go out on fragments `cur`; while they run, step
  // i - 1's stage is released (its products are done) and step i + 1's
  // fragments are converted into `nxt`, the registers step i - 1 read
  auto step = [&](int i, uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4]) {
    const int s = i % kQmmStages;
#pragma unroll
    for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
        wgmma_m64n128k16(acc[j], cur[kk], desc_sw128(a_tile(s) + j * 128 * 128 + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (i > 0) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
      if (lane == 0) mbar_arrive(empty + (i - 1) % kQmmStages);
    }
    if (i + 1 < n_k) {
      mbar_wait(full + (i + 1) % kQmmStages, ((i + 1) / kQmmStages) & 1);
      convert(nxt, (i + 1) % kQmmStages);
    }
  };
  uint32_t fa[4][4], fb[4][4];
  mbar_wait(full, 0);
  convert(fa, 0);
  for (int i = 0; i < n_k; i += 2) {
    step(i, fa, fb);
    if (i + 1 < n_k) step(i + 1, fb, fa);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);

  // epilogue: scale, round, stage [TM][64] bf16 in the ring (free once both
  // consumer warpgroups are past their last product), store 16-byte rows
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  bf16* epi = reinterpret_cast<bf16*>(ring) + c * TM * kQmmEpiRow;
  const int n = n0 + nl;
  const float s0 = n < N ? scale[n] : 0.f, s1 = n < N ? scale[n + 1] : 0.f;
  const int wl = 16 * warp + 2 * g;  // the column pair inside the warpgroup's 64
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ml = 128 * j + 8 * q + 2 * t + e;
        *reinterpret_cast<__nv_bfloat162*>(epi + ml * kQmmEpiRow + wl) =
            __floats2bfloat162_rn(acc[j][4 * q + e] * s0, acc[j][4 * q + 2 + e] * s1);
      }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
  const int tc = tid & 127, col = n0 + 64 * c;
#pragma unroll 4
  for (int idx = tc; idx < TM * 8; idx += 128) {
    const int ml = idx >> 3, ch = idx & 7;
    if (m0 + ml < m_end && col + 8 * ch < N)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + ml) * N + col + 8 * ch) =
          *reinterpret_cast<const uint4*>(epi + ml * kQmmEpiRow + 8 * ch);
  }
}

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*,
                                         const cuuint32_t*, const cuuint32_t*,
                                         CUtensorMapInterleave, CUtensorMapSwizzle,
                                         CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, fetched through the runtime (the
// library links no libcuda); null when the driver has none
static TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// a 2-D TMA map over a row-major [rows][cols] matrix of `elem` bytes, box
// [box_rows][box_cols], 128-byte swizzle; out-of-range elements read as 0
static bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                       int rows, int cols, int box_rows, int box_cols) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same over an [E][K][N] int8 stack as one 3-D map (box [1][64][128]):
// a box never crosses into the next expert, and rows past K read as 0
static bool encode_map_experts(CUtensorMap* map, const void* base, int E, int K, int N) {
  TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
  const cuuint32_t box[3] = {(cuuint32_t)kQmmBN, (cuuint32_t)kQmmBK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// GROUPED: the grouped product (ends [E] on the device, w8 [E][K][N]); a
// template parameter, so each entry instantiates only the kernel it launches
template <int TM, bool GROUPED>
int launch_qmm_mma(const void* a, const void* w8, const void* scale, void* out, int M, int K,
                   int N, const void* ends, int E, cudaStream_t st) {
  CUtensorMap a_map, w_map;
  if (!encode_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, M, K, TM, kQmmBK) ||
      !(GROUPED ? encode_map_experts(&w_map, w8, E, K, N)
                : encode_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w8, K, N, kQmmBK,
                             kQmmBN)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = QmmCfg<TM>::smem_bytes;
  auto kernel = qmm_mma_kernel<TM, GROUPED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + TM - 1) / TM + (GROUPED ? E : 0), (N + kQmmBN - 1) / kQmmBN);
  kernel<<<grid, kQmmThreads, smem, st>>>(a_map, w_map, static_cast<const float*>(scale),
                                          static_cast<bf16*>(out), M, K, N,
                                          static_cast<const int*>(ends), E);
  return (int)cudaGetLastError();
}

template <int M, bool INT4>
int launch_gemv(const void* a, const void* w, const void* scale, void* out, void* work,
                void* counters, int K, int N, int rows_per_split, int n_splits,
                cudaStream_t st) {
  dim3 grid((N + kGvCols - 1) / kGvCols, n_splits);
  qmm_gemv_kernel<M, INT4><<<grid, kGvWarps * 32, 0, st>>>(
      static_cast<const bf16*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<bf16*>(out),
      static_cast<float*>(work), static_cast<int*>(counters), K, N, rows_per_split,
      n_splits);
  return (int)cudaGetLastError();
}

template <int M, bool INT4>
int gemv_attributes(int* out) {
  return mma::kernel_attributes(qmm_gemv_kernel<M, INT4>, kGvWarps * 32, 0, out);
}

}  // namespace dstorch

// Dispatch on the token count M (1..8) of qmm_gemv_kernel<M, INT4>
#define DSTORCH_GEMV_DISPATCH(M, INT4, FN, ...) \
  switch (M) {                                  \
    case 1: return FN<1, INT4>(__VA_ARGS__);    \
    case 2: return FN<2, INT4>(__VA_ARGS__);    \
    case 3: return FN<3, INT4>(__VA_ARGS__);    \
    case 4: return FN<4, INT4>(__VA_ARGS__);    \
    case 5: return FN<5, INT4>(__VA_ARGS__);    \
    case 6: return FN<6, INT4>(__VA_ARGS__);    \
    case 7: return FN<7, INT4>(__VA_ARGS__);    \
    case 8: return FN<8, INT4>(__VA_ARGS__);    \
    default: return -1;                         \
  }

namespace dstorch {

// a [M, K] bf16, w [K, N] int8 (int4 false) or packed int4 [K / 2, N]
// (int4 true: byte [i][n] holds row 2i in its low nibble, 2i + 1 in its high
// one), scale [N] f32 -> out [M, N] bf16, for 1 <= M <= 8. K's rows are cut
// into n_splits splits of rows_per_split (a multiple of 16). work:
// [n_splits, M, N] f32 scratch; counters: [ceil(N / 128)] int32, all 0
// before the launch and left 0 after it. Needs even K, N % 16 == 0, w
// 16-byte and a 4-byte aligned. Returns the launch's cudaError_t, -1 for an
// unsupported shape.
static int qmm_gemv(const void* a, const void* w, const void* scale, void* out, void* work,
                    void* counters, int M, int K, int N, int rows_per_split, int n_splits,
                    bool int4, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % 2 != 0 || N % 16 != 0 || rows_per_split < 1 || rows_per_split % kGvStep != 0 ||
      n_splits < 1 || (long)rows_per_split * n_splits < K ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 || (reinterpret_cast<uintptr_t>(a) & 3) != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int4) {
    DSTORCH_GEMV_DISPATCH(M, true, launch_gemv, a, w, scale, out, work, counters, K, N,
                          rows_per_split, n_splits, st)
  }
  DSTORCH_GEMV_DISPATCH(M, false, launch_gemv, a, w, scale, out, work, counters, K, N,
                        rows_per_split, n_splits, st)
}

}  // namespace dstorch

// The int8 weight: the route of quantized_matmul at M <= 8.
extern "C" int dstorch_qmm_gemv(const void* a, const void* w8, const void* scale,
                                void* out, void* work, void* counters, int M, int K, int N,
                                int rows_per_split, int n_splits, void* stream) {
  return dstorch::qmm_gemv(a, w8, scale, out, work, counters, M, K, N, rows_per_split,
                           n_splits, false, stream);
}

// The packed int4 weight w4 [K / 2, N] (K the unpacked depth): the route of
// quantized_matmul_int4, the same sums in the same order as dstorch_qmm_gemv
// on the unpacked weight.
extern "C" int dstorch_qmm_gemv_int4(const void* a, const void* w4, const void* scale,
                                     void* out, void* work, void* counters, int M, int K,
                                     int N, int rows_per_split, int n_splits, void* stream) {
  return dstorch::qmm_gemv(a, w4, scale, out, work, counters, M, K, N, rows_per_split,
                           n_splits, true, stream);
}

// qmm_gemv_kernel<M, int4> as compiled: out [6] int32 as
// dstorch_flash_kernel_attrs gives them. Returns a cudaError_t, -1 for an
// unsupported M.
extern "C" int dstorch_qmm_gemv_attrs(int M, int int4, void* out) {
  int* o = static_cast<int*>(out);
  if (int4) { DSTORCH_GEMV_DISPATCH(M, true, dstorch::gemv_attributes, o) }
  DSTORCH_GEMV_DISPATCH(M, false, dstorch::gemv_attributes, o)
}

// The same for any M >= 1 through tensor cores (wgmma); needs K % 32 == 0
// and N % 16 == 0 (a K that 64 does not divide is zero-filled by TMA).
// Tiles of 128 tokens for M <= 128, else 256.
extern "C" int dstorch_qmm_mma_tiled(const void* a, const void* w8, const void* scale,
                                     void* out, int M, int K, int N, int tile_m,
                                     void* stream);

extern "C" int dstorch_qmm_mma(const void* a, const void* w8, const void* scale, void* out,
                               int M, int K, int N, void* stream) {
  return dstorch_qmm_mma_tiled(a, w8, scale, out, M, K, N, M <= 128 ? 128 : 256, stream);
}

// dstorch_qmm_mma at a given token tile (128 or 256; -1 for another).
extern "C" int dstorch_qmm_mma_tiled(const void* a, const void* w8, const void* scale,
                                     void* out, int M, int K, int N, int tile_m,
                                     void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % 32 != 0 || N % 16 != 0 || K < 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0) return (int)cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(dstorch::bf16), st);
  if (tile_m == 128)
    return dstorch::launch_qmm_mma<128, false>(a, w8, scale, out, M, K, N, nullptr, 0, st);
  if (tile_m == 256)
    return dstorch::launch_qmm_mma<256, false>(a, w8, scale, out, M, K, N, nullptr, 0, st);
  return -1;
}

// qmm_mma_kernel<tile_m> as compiled: out [6] int32 as
// dstorch_flash_kernel_attrs gives them (registers, local spill bytes,
// static and dynamic shared bytes, threads, blocks per SM).
extern "C" int dstorch_qmm_mma_attrs(int tile_m, void* out) {
  int* o = static_cast<int*>(out);
  if (tile_m == 128)
    return dstorch::mma::kernel_attributes(dstorch::qmm_mma_kernel<128, false>,
                                           dstorch::kQmmThreads,
                                           dstorch::QmmCfg<128>::smem_bytes, o);
  if (tile_m == 256)
    return dstorch::mma::kernel_attributes(dstorch::qmm_mma_kernel<256, false>,
                                           dstorch::kQmmThreads,
                                           dstorch::QmmCfg<256>::smem_bytes, o);
  return -1;
}

// The grouped entries of an MoE layer: a [R, K] bf16 with rows sorted by
// expert, ends [E] int32 on the device (expert e's rows end at ends[e],
// ends[E - 1] == R), w8 [E, K, N] int8, scale [E, N] f32 -> out [R, N]
// bf16, row r of expert e = bf16((a[r] . w8[e]) * scale[e]).
//
// qmm_gemv_grouped_kernel, for a few rows (the decode step): K's rows cut
// into n_splits splits of rows_per_split (a multiple of 16); work [n_splits,
// R, N] f32; counters [E * ceil(N / 128)] int32, 0 before and after. Needs
// even K, N % 16 == 0, w8 16-byte and a 4-byte aligned.
extern "C" int dstorch_qmm_gemv_grouped(const void* a, const void* w8, const void* scale,
                                        const void* ends, void* out, void* work,
                                        void* counters, int R, int K, int N, int E,
                                        int rows_per_split, int n_splits, void* stream) {
  using namespace dstorch;
  if (R == 0 || N == 0) return 0;
  if (E < 1 || K % 2 != 0 || N % 16 != 0 || rows_per_split < 1 ||
      rows_per_split % kGvStep != 0 || n_splits < 1 || (long)rows_per_split * n_splits < K ||
      (reinterpret_cast<uintptr_t>(w8) & 15) != 0 || (reinterpret_cast<uintptr_t>(a) & 3) != 0)
    return -1;
  dim3 grid((N + kGvCols - 1) / kGvCols, n_splits, E);
  qmm_gemv_grouped_kernel<<<grid, kGvWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<const int*>(ends), static_cast<bf16*>(out),
      static_cast<float*>(work), static_cast<int*>(counters), R, K, N, rows_per_split,
      n_splits);
  return (int)cudaGetLastError();
}

// qmm_mma_kernel<128, grouped>, for many rows (the prefill passes): tiles of
// 128 rows, each inside one expert's rows. Needs K % 32 == 0 and N % 16 ==
// 0.
extern "C" int dstorch_qmm_mma_grouped(const void* a, const void* w8, const void* scale,
                                       const void* ends, void* out, int R, int K, int N, int E,
                                       void* stream) {
  if (R == 0 || N == 0) return 0;
  if (E < 1 || K % 32 != 0 || N % 16 != 0 || K < 32) return -1;
  return dstorch::launch_qmm_mma<128, true>(a, w8, scale, out, R, K, N, ends, E,
                                      static_cast<cudaStream_t>(stream));
}

// The grouped kernels as compiled: kernel 0 = qmm_gemv_grouped_kernel, 1 =
// qmm_mma_kernel<128, grouped>; out [6] int32 as dstorch_flash_kernel_attrs
// gives them. Returns a cudaError_t, -1 for another kernel.
extern "C" int dstorch_qmm_grouped_attrs(int kernel, void* out) {
  using namespace dstorch;
  int* o = static_cast<int*>(out);
  if (kernel == 0) return mma::kernel_attributes(qmm_gemv_grouped_kernel, kGvWarps * 32, 0, o);
  if (kernel == 1)
    return mma::kernel_attributes(qmm_mma_kernel<128, true>, kQmmThreads,
                                  QmmCfg<128>::smem_bytes, o);
  return -1;
}
