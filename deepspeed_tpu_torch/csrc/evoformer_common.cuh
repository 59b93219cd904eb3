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
//
// Design shared by the four kernels: the tensor cores (mma_common.cuh:
// mma.sync m16n8k16, ldmatrix, cp.async rings zero-filled past S), 4 warps
// a block (kEvoThreads), each owning 16 rows of every product, over 64-row
// q- and k-tiles (kEvoTile). The pair bias's 64-key tile rows are copied by
// load_pair with 16-byte cp.async when their starts are 16-byte aligned,
// 4-byte when 4-byte aligned, else (a bf16 bias with odd S) plain loads.
// All four are bound by bytes on the H100: at AlphaFold 2's MSA row
// attention (L = 512, S = 384, H = 8, D = 32, R = 512) the forward's bound
// is 0.123 ms, dq's 0.155, dk/dv's 0.185 and d(pair)'s 0.126 (each input
// read once and each output written once at 3.35 TB/s).
#pragma once

#include "mma_common.cuh"

namespace dstorch {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ void store_f32(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

// ((dot * scale) + mask) + pair, rounded to f32 after each step
__device__ __forceinline__ float evo_score(float dot, float scale, float mask, float pair) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dot, scale), mask), pair);
}

constexpr int kEvoThreads = 128;  // 4 warps of 16 rows
constexpr int kEvoTile = 64;      // q- and k-tiles

// A fragments of rows [r0, r0 + 16) of a resident [64][D] tile
template <int D>
__device__ __forceinline__ void evo_frags(uint32_t (&f)[D / 16][4], const bf16* tile, int r0,
                                          int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) mma::ldsm_a<D>(f[kc], tile, r0, kc, lane);
}

// acc [16 x 8 NT] = A . B^T with A the warp's resident rows: from `frags`
// at D <= 64, else through ldmatrix from `a_tile` rows [a_r0, a_r0 + 16)
template <int D, int NT>
__device__ __forceinline__ void evo_abt(float (&acc)[NT][4], const uint32_t (&frags)[D / 16][4],
                                        const bf16* a_tile, int a_r0, const bf16* b_tile,
                                        int lane) {
  mma::zero(acc);
  if constexpr (D <= 64) {
    mma::gemm_abt<D, NT>(acc, frags, b_tile, lane);
  } else {
    mma::gemm_abt<D, NT>(acc, a_tile, a_r0, b_tile, lane);
  }
}

__device__ __forceinline__ float2 to_f32x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 to_f32x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// two pair-bias values in one register (bf16) or two (f32)
template <typename PT>
struct Pair2;
template <>
struct Pair2<bf16> {
  typedef __nv_bfloat162 T;
  static __device__ __forceinline__ T make(bf16 a, bf16 b) { return __halves2bfloat162(a, b); }
  static __device__ __forceinline__ float2 f32(T x) { return __bfloat1622float2(x); }
};
template <>
struct Pair2<float> {
  typedef float2 T;
  static __device__ __forceinline__ T make(float a, float b) { return make_float2(a, b); }
  static __device__ __forceinline__ float2 f32(T x) { return x; }
};

// How the pair bias's tile rows may be copied: 16-byte cp.async when every
// row start is 16-byte aligned, 4-byte when 4-byte aligned, else (a bf16
// bias with odd S) plain loads.
template <typename PT>
__device__ __forceinline__ int pair_copy_bytes(const PT* pair, int S) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(pair) | ((uintptr_t)S * sizeof(PT));
  return (a & 15) == 0 ? 16 : (a & 3) == 0 ? 4 : 0;
}

// Rows [0, n_rows) x keys [0, n_keys) of the pair bias (row r at src + r *
// S) into a ROWS x 64 tile of row pitch PITCH elements; the rest of the tile
// is zero-filled. cp.async (in the caller's commit group) unless `bytes` is 0.
template <typename PT, int ROWS, int PITCH>
__device__ __forceinline__ void load_pair(PT* tile, const PT* src, int S, int n_rows,
                                          int n_keys, int bytes, int tid) {
  constexpr int TH = kEvoThreads;
  if (bytes == 16) {
    constexpr int E = 16 / sizeof(PT), C = kEvoTile / E, N = ROWS * C;
#pragma unroll
    for (int j = 0; j < (N + TH - 1) / TH; ++j) {
      const int i = tid + j * TH;
      if (N % TH == 0 || i < N) {
        const int r = i / C, c = (i - r * C) * E;
        const bool ok = r < n_rows && c < n_keys;
        mma::cp_async16(tile + r * PITCH + c, src + (ok ? (size_t)r * S + c : 0), ok);
      }
    }
  } else if (bytes == 4) {
    constexpr int E = 4 / sizeof(PT), C = kEvoTile / E, N = ROWS * C;
    for (int i = tid; i < N; i += TH) {
      const int r = i / C, c = (i - r * C) * E;
      const bool ok = r < n_rows && c < n_keys;
      mma::cp_async4(tile + r * PITCH + c, src + (ok ? (size_t)r * S + c : 0), ok);
    }
  } else {
    for (int i = tid; i < ROWS * kEvoTile; i += TH) {
      const int r = i / kEvoTile, c = i - r * kEvoTile;
      tile[r * PITCH + c] = r < n_rows && c < n_keys ? src[(size_t)r * S + c] : PT(0.f);
    }
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
