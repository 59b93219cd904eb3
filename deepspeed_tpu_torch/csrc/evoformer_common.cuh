// Shared device code of the Evoformer pair-bias attention kernels (K10,
// evoformer_fwd.cu and evoformer_bwd.cu).
//
// Layouts: q, k, v, o, dO [L, S, H, D] bf16 as the caller holds them (row
// (l, s, h) at ((l * S + s) * H + h) * D, so consecutive positions of one
// head are H * D apart); lse and delta [L, H, S] f32; the mask bias [L, S]
// f32 (or none); the pair bias [G, H, S, S] in bf16 or f32 (PT), row l
// reading group g = l / R. The pair bias keeps its own type: an f32 bias is
// added in f32, as the JAX kernel adds it.
//
// Score order (deepspeed_tpu/ops/pallas/evoformer_attention.py:54 _scores):
// s = (q . k) * scale, then + mask, then + pair, each step rounded to f32.
// The intrinsics below keep nvcc from contracting the first two into one
// FMA: with a -1e9 mask the f32 spacing is 64, so the rounding of a masked
// score depends on that order. Both biases are finite: a row whose keys are
// all masked gets the same score for every key, so p is uniform there (no
// row is excluded, unlike K1 and K9).
#pragma once

#include "tile_common.cuh"

namespace dstorch {

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ void store_f32(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

// ((dot * scale) + mask) + pair, rounded to f32 after each step
__device__ __forceinline__ float evo_score(float dot, float scale, float mask, float pair) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dot, scale), mask), pair);
}

// mk[c] = mask[key0 + tx + 16c] for keys below n (0 without a mask)
__device__ __forceinline__ void load_key_mask(const float* __restrict__ mask_row, int key0,
                                              int n, float (&mk)[4]) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int key = tx + 16 * c;
    mk[c] = (mask_row != nullptr && key < n) ? mask_row[key0 + key] : 0.f;
  }
}

}  // namespace dstorch

// Dispatch on the head dim, with the pair bias's type PT.
#define DSTORCH_K10_DISPATCH(D, PT, FN, ...)   \
  switch (D) {                                 \
    case 16: return FN<16, PT>(__VA_ARGS__);   \
    case 32: return FN<32, PT>(__VA_ARGS__);   \
    case 64: return FN<64, PT>(__VA_ARGS__);   \
    case 128: return FN<128, PT>(__VA_ARGS__); \
    default: return -1;                        \
  }
