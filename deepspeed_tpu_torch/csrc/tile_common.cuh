// Tile helpers of the Evoformer forward, the one kernel still on the CUDA
// cores that stages 64-row tiles (evoformer_fwd.cu, through
// evoformer_common.cuh). 64-row bf16 tiles staged in shared memory with
// padded rows (D + 2 bf16, an odd number of words, so the 16 threads
// reading 16 different rows at one depth hit 16 banks), 64 x 64 products
// with f32 FMAs on CUDA cores, and accumulation of an f32 64 x 64 tile into
// a thread's 4 rows x D/16 dims. Thread layout of attn_common.cuh's
// flash_block: thread (ty = tid / 16, tx = tid % 16) owns tile rows
// 4ty..4ty+3 and, for the 64 x 64 products, columns tx + 16c. (The
// tensor-core kernels, the Evoformer backward among them, use
// mma_common.cuh.)
#pragma once

#include "attn_common.cuh"

namespace dstorch {

template <int D>
struct BwdSmem {
  static constexpr int QS = D + 2;    // padded bf16 row
  static constexpr int PS = kBK + 1;  // padded f32 row of a 64 x 64 tile
  static constexpr size_t tile_bytes = (size_t)kBQ * QS * sizeof(bf16);
  static constexpr size_t f32_tile_bytes = (size_t)kBQ * PS * sizeof(float);
};

// Stage 64 rows (row r < n valid, else zeros) of D bf16 each, row r at
// src + r * stride, into padded shared rows.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           size_t stride, int n) {
  constexpr int CH = D / 8;
  constexpr int QS = D + 2;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kBQ * CH; i += kTileThreads) {
    const int r = i / CH, c = i - (i / CH) * CH;
    const uint4 u = r < n ? load16(src + r * stride + c * 8) : zero;
    store8_words(dst + r * QS + c * 8, u);
  }
}

// acc[r][c] = A[4ty + r] . B[tx + 16c] over D, both padded shared tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const bf16* A, const bf16* Bt, float (&acc)[4][4]) {
  constexpr int QS = D + 2;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    float2 a[4], bb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[r] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(A + (ty * 4 + r) * QS + d));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bb[c] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Bt + (tx + 16 * c) * QS + d));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] = fmaf(a[r].y, bb[c].y, fmaf(a[r].x, bb[c].x, acc[r][c]));
  }
}

// acc[r][n] += sum_j W[4ty + r][j] * X[j][tx + 16n]; W a padded f32 tile,
// X a padded bf16 tile.
template <int D>
__device__ __forceinline__ void tile_accumulate(const float* W, const bf16* X,
                                                float (&acc)[4][D / 16]) {
  constexpr int QS = D + 2;
  constexpr int PS = kBK + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int j = 0; j < kBK; ++j) {
    float w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = W[(ty * 4 + r) * PS + j];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      const float x = __bfloat162float(X[j * QS + tx + 16 * n]);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][n] = fmaf(w[r], x, acc[r][n]);
    }
  }
}

// x rounded to bf16 and back: the probabilities and their gradients enter
// the products in the inputs' type, as the Pallas kernels cast them
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

}  // namespace dstorch
