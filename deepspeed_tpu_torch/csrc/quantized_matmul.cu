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
// (half of bf16). A block of 8 warps owns 128 columns; each lane reads 4
// columns (one 32-bit word) of a weight row, so a warp reads 128 contiguous
// bytes per row, and the warps take rows k = w, w + 8, ... of the block's K
// range, 8 rows in flight per lane. a's rows for that range sit in shared
// memory as f32. To put enough blocks on 132 SMs the K range is cut into
// splits (grid.y): each block writes its f32 partial sums, and the last
// block of a column group to finish (a counter per column group) adds the
// partials in split order, scales and writes bf16 — one launch, and the
// same sums in the same order every time.
//
// qmm_mma (M > 8, the prefill passes): bound by operations at M = 736
// (2*M*K*N flops against K*N + 2*M*(K+N) bytes). 128x128 output tiles, 8
// warps of 64x32, bf16 tensor cores through mma.sync m16n8k16 with f32
// accumulators. Each K step of 32 stages a's tile and the int8 weight tile
// in shared memory, the weights converted to bf16 (exact: |w8| <= 127) and
// stored column-major so a fragment pair is one 32-bit read; the next
// step's global loads are issued before this step's mma. No TMA, wgmma or
// multi-stage pipeline yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstorch {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------- //
// GEMV-shaped: M <= 8
// ---------------------------------------------------------------------- //

constexpr int kGvWarps = 8;
constexpr int kGvCols = 128;      // columns per block (4 per lane)
constexpr int kGvUnroll = 8;      // weight rows in flight per lane
constexpr int kGvMaxRows = 512;   // K rows per split (a's tile in shared memory)

template <int M>
__global__ void __launch_bounds__(kGvWarps * 32)
qmm_gemv_kernel(const bf16* __restrict__ a, const int8_t* __restrict__ w8,
                const float* __restrict__ scale, bf16* __restrict__ out,
                float* __restrict__ work, int* __restrict__ counters, int K, int N,
                int rows_per_split, int n_splits) {
  // a's rows [rows][M] f32 during the loop; the warps' partial sums
  // [warps][M][cols] after it
  __shared__ __align__(16) float smem[kGvWarps * M * kGvCols];
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kGvCols;
  const int split = blockIdx.y;
  const int k_lo = split * rows_per_split;
  const int k_hi = min(K, k_lo + rows_per_split);
  const int nrows = k_hi - k_lo;

  for (int i = tid; i < nrows * M; i += kGvWarps * 32) {
    const int r = i / M, m = i - (i / M) * M;
    smem[i] = __bfloat162float(a[(size_t)m * K + k_lo + r]);
  }
  __syncthreads();

  const int col = n0 + lane * 4;
  const bool col_ok = col < N;
  float acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int r0 = warp; r0 < nrows; r0 += kGvWarps * kGvUnroll) {
    uint32_t wv[kGvUnroll];
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      const int r = r0 + u * kGvWarps;
      wv[u] = (col_ok && r < nrows)
                  ? __ldg(reinterpret_cast<const uint32_t*>(w8 + (size_t)(k_lo + r) * N + col))
                  : 0u;
    }
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      const int r = r0 + u * kGvWarps;
      if (r >= nrows) break;
      const char4 w4 = *reinterpret_cast<const char4*>(&wv[u]);
      const float wf[4] = {(float)w4.x, (float)w4.y, (float)w4.z, (float)w4.w};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float av = smem[r * M + m];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(av, wf[c], acc[m][c]);
      }
    }
  }
  __syncthreads();  // a's tile is dead; the region takes the warps' sums
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) smem[(warp * M + m) * kGvCols + lane * 4 + c] = acc[m][c];
  __syncthreads();

  // each thread sums the warps for some (m, column) of the block
  for (int i = tid; i < M * kGvCols; i += kGvWarps * 32) {
    const int m = i / kGvCols, c = i - (i / kGvCols) * kGvCols;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kGvWarps; ++w) sum += smem[(w * M + m) * kGvCols + c];
    smem[i] = sum;   // row w = 0 of the region: read back only by this thread
  }
  const int n_cols = min(kGvCols, N - n0);
  if (n_splits == 1) {
    for (int i = tid; i < M * kGvCols; i += kGvWarps * 32) {
      const int m = i / kGvCols, c = i - (i / kGvCols) * kGvCols;
      if (c < n_cols)
        out[(size_t)m * N + n0 + c] = __float2bfloat16(smem[i] * scale[n0 + c]);
    }
    return;
  }
  for (int i = tid; i < M * kGvCols; i += kGvWarps * 32) {
    const int m = i / kGvCols, c = i - (i / kGvCols) * kGvCols;
    if (c < n_cols) work[((size_t)split * M + m) * N + n0 + c] = smem[i];
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

// ---------------------------------------------------------------------- //
// tensor-core tiles: M > 8
// ---------------------------------------------------------------------- //

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kAS = kBK + 8;      // padded smem row (bf16): conflict-free fragments
constexpr int kMmaThreads = 256;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kMmaThreads)
qmm_mma_kernel(const bf16* __restrict__ a, const int8_t* __restrict__ w8,
               const float* __restrict__ scale, bf16* __restrict__ out, int M, int K,
               int N) {
  __shared__ __align__(16) bf16 As[kBM * kAS];   // [m][k]
  __shared__ __align__(16) bf16 Bs[kBN * kAS];   // [n][k] (transposed)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;

  // global -> register staging: 2 chunks of 8 bf16 of a, 16 int8 of w8
  uint4 ar[2];
  uint4 wr;
  const int b_k = lane, b_n = warp * 16;          // this thread's w8 chunk
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + i * kMmaThreads;
      const int r = chunk >> 2, c = (chunk & 3) * 8;
      ar[i] = (m0 + r < M)
                  ? *reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * K + k0 + c)
                  : make_uint4(0, 0, 0, 0);
    }
    wr = (n0 + b_n < N)
             ? __ldg(reinterpret_cast<const uint4*>(w8 + (size_t)(k0 + b_k) * N + n0 + b_n))
             : make_uint4(0, 0, 0, 0);
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + i * kMmaThreads;
      const int r = chunk >> 2, c = (chunk & 3) * 8;
      *reinterpret_cast<uint4*>(As + r * kAS + c) = ar[i];
    }
    const int8_t* wb = reinterpret_cast<const int8_t*>(&wr);
#pragma unroll
    for (int i = 0; i < 16; ++i) Bs[(b_n + i) * kAS + b_k] = __float2bfloat16((float)wb[i]);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();   // the previous step's fragment reads are done
    store_tiles();
    __syncthreads();
    if (k0 + kBK < K) load_tiles(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* p0 = As + (wm + i * 16 + g) * kAS + kk + t * 2;
        const bf16* p1 = p0 + 8 * kAS;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p1);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16* p = Bs + (wn + j * 8 + g) * kAS + kk + t * 2;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + t * 2;
    if (n >= N) continue;
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + h * 8;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
              __floats2bfloat162_rn(acc[i][j][2 * h] * s0, acc[i][j][2 * h + 1] * s1);
      }
    }
  }
}

template <int M>
int launch_gemv(const void* a, const void* w8, const void* scale, void* out, void* work,
                void* counters, int K, int N, int rows_per_split, int n_splits,
                cudaStream_t st) {
  dim3 grid((N + kGvCols - 1) / kGvCols, n_splits);
  qmm_gemv_kernel<M><<<grid, kGvWarps * 32, 0, st>>>(
      static_cast<const bf16*>(a), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<bf16*>(out),
      static_cast<float*>(work), static_cast<int*>(counters), K, N, rows_per_split,
      n_splits);
  return (int)cudaGetLastError();
}

}  // namespace dstorch

// a [M, K] bf16, w8 [K, N] int8, scale [N] f32 -> out [M, N] bf16, for
// 1 <= M <= 8. work: [n_splits, M, N] f32 scratch; counters:
// [ceil(N / 128)] int32, all 0 before the launch and left 0 after it.
// Needs N % 4 == 0 and rows_per_split <= 512. Returns the launch's
// cudaError_t, -1 for an unsupported shape.
extern "C" int dstorch_qmm_gemv(const void* a, const void* w8, const void* scale,
                                void* out, void* work, void* counters, int M, int K, int N,
                                int rows_per_split, int n_splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (N % 4 != 0 || rows_per_split > dstorch::kGvMaxRows || rows_per_split < 1 ||
      n_splits < 1 || (long)rows_per_split * n_splits < K)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return dstorch::launch_gemv<1>(a, w8, scale, out, work, counters, K, N, rows_per_split, n_splits, st);
    case 2: return dstorch::launch_gemv<2>(a, w8, scale, out, work, counters, K, N, rows_per_split, n_splits, st);
    case 3: return dstorch::launch_gemv<3>(a, w8, scale, out, work, counters, K, N, rows_per_split, n_splits, st);
    case 4: return dstorch::launch_gemv<4>(a, w8, scale, out, work, counters, K, N, rows_per_split, n_splits, st);
    case 5: return dstorch::launch_gemv<5>(a, w8, scale, out, work, counters, K, N, rows_per_split, n_splits, st);
    case 6: return dstorch::launch_gemv<6>(a, w8, scale, out, work, counters, K, N, rows_per_split, n_splits, st);
    case 7: return dstorch::launch_gemv<7>(a, w8, scale, out, work, counters, K, N, rows_per_split, n_splits, st);
    case 8: return dstorch::launch_gemv<8>(a, w8, scale, out, work, counters, K, N, rows_per_split, n_splits, st);
    default: return -1;
  }
}

// The same for any M >= 1 through tensor cores; needs K % 32 == 0 and
// N % 16 == 0.
extern "C" int dstorch_qmm_mma(const void* a, const void* w8, const void* scale, void* out,
                               int M, int K, int N, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % dstorch::kBK != 0 || N % 16 != 0) return -1;
  dim3 grid((N + dstorch::kBN - 1) / dstorch::kBN, (M + dstorch::kBM - 1) / dstorch::kBM);
  dstorch::qmm_mma_kernel<<<grid, dstorch::kMmaThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const dstorch::bf16*>(a), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<dstorch::bf16*>(out), M, K, N);
  return (int)cudaGetLastError();
}
