// Tensor-core building blocks of the port's attention kernels (sm_90a, bf16
// in, f32 accumulate): the FlashAttention-2 toolkit of mma.sync, ldmatrix
// and cp.async, for kernels in which each warp owns 16 rows of a product.
//
// Shared-memory tiles. A tile is `rows` x D bf16, row-major, with no
// padding: each row is D / 8 chunks of 16 bytes, and chunk c of row r is
// stored at chunk position c ^ f(r) (an XOR swizzle that keeps the chunk in
// its row). ldmatrix reads one 16-byte chunk from each of 8 rows at once
// (rows 8i .. 8i + 7); the swizzle puts those 8 chunks in 8 different
// 16-byte bank groups for every D in {16, 32, 64, 80, 96, 128, 256}, so no
// ldmatrix and no cp.async store conflicts on banks. Tiles are
// filled by cp.async (16 bytes a thread, zero-filled past the last valid
// row, so a ragged edge holds zeros and never NaN garbage) in commit
// groups, two stages deep in the kernels that stream.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * g + t. An f32
// accumulator of a 16 x 8 tile holds, per thread, rows g (elements 0, 1)
// and g + 8 (elements 2, 3) at columns 2t, 2t + 1. The A operand of a
// 16 x 16 product holds the same rows at columns 2t, 2t + 1 (regs 0, 1)
// and 2t + 8, 2t + 9 (regs 2, 3); so the accumulators of two neighbouring
// n8 tiles, packed to bf16 pairs, ARE an A fragment (acc_to_a): softmax
// probabilities and score gradients feed the next product from registers.
//
// Naming: S = A . B^T with A [16 rows][k] and B [n][k] both stored with k
// contiguous (gemm_abt: Q.K^T, dO.V^T, K.Q^T, V.dO^T); O += P . B with B
// stored [k][n], n contiguous (gemm_pb, ldmatrix.trans: P.V, dS.K, P^T.dO,
// dS^T.Q).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dstorch {
namespace mma {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// ---- swizzled tiles ------------------------------------------------------ //

// element offset of 16-byte chunk `chunk` of row `row` in a [rows][D] tile
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int C = D / 8;  // chunks per row
  if constexpr (C % 8 == 0 || 8 % C == 0) {
    constexpr int R = C >= 8 ? 1 : 8 / C;  // rows per 128-byte line
    constexpr int M = C >= 8 ? 7 : C - 1;
    return row * D + ((chunk ^ ((row / R) & M)) << 3);
  } else if constexpr (C % 4 == 0) {
    // 12 chunks (D = 96): row r starts 4r bank groups (mod 8) on, so rows
    // 2i and 2i + 1 fill both halves of a line and the low two chunk bits
    // XOR (r / 2) & 3
    return row * D + ((chunk ^ ((row >> 1) & 3)) << 3);
  } else {
    // 10 chunks (D = 80): row r starts 2r bank groups (mod 8) on, so rows
    // 0..3 take the even groups and rows 4..7 the odd ones: the low chunk
    // bit XORs (r / 4) & 1
    static_assert(C % 2 == 0, "head dim must be a multiple of 16");
    return row * D + ((chunk ^ ((row >> 2) & 1)) << 3);
  }
}

// ---- cp.async ------------------------------------------------------------ //

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, n_rows) of a [*, D] bf16 matrix with row stride `stride` (in
// elements) into a swizzled ROWS x D tile; rows >= n_rows are zero-filled
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, size_t stride,
                                          int n_rows, int tid) {
  constexpr int C = D / 8, N = ROWS * C;
#pragma unroll
  for (int j = 0; j < (N + THREADS - 1) / THREADS; ++j) {
    const int i = tid + j * THREADS;
    if (N % THREADS == 0 || i < N) {
      const int r = i / C, c = i - (i / C) * C;
      const bool ok = r < n_rows;
      cp_async16(tile + swz<D>(r, c), src + (size_t)(ok ? r : 0) * stride + c * 8, ok);
    }
  }
}

// n floats of src (n <= ROWS) into dst[0, ROWS), zero-filled past n
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int n, int tid) {
#pragma unroll
  for (int j = 0; j < (ROWS + THREADS - 1) / THREADS; ++j) {
    const int i = tid + j * THREADS;
    if (ROWS % THREADS == 0 || i < ROWS) cp_async4(dst + i, src + (i < n ? i : 0), i < n);
  }
}

// ---- ldmatrix --------------------------------------------------------- //

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// A fragment: rows [r0, r0 + 16), columns [16 kc, 16 kc + 16) of a tile
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile, int r0, int kc,
                                       int lane) {
  ldsm_x4(a, tile + swz<D>(r0 + (lane & 15), 2 * kc + (lane >> 4)));
}

// B fragments of two n8 tiles, rows [n0, n0 + 16) of a tile stored [n][k],
// k columns [16 kc, 16 kc + 16): b[0], b[1] for rows n0..n0+7, b[2], b[3]
// for n0+8..n0+15
template <int D>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16* tile, int n0, int kc,
                                       int lane) {
  ldsm_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                           2 * kc + ((lane >> 3) & 1)));
}

// B fragments of two n8 tiles from a tile stored [k][n]: k rows [k0, k0 +
// 16), n columns [16 nc, 16 nc + 16): b[0], b[1] for columns 16nc..+7,
// b[2], b[3] for 16nc+8..+15
template <int D>
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const bf16* tile, int k0, int nc,
                                        int lane) {
  ldsm_x4_trans(b, tile + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                 2 * nc + (lane >> 4)));
}

// ---- mma.sync ------------------------------------------------------------ //

// d += a . b, one m16n8k16 product, bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of columns [16 kc, 16 kc + 16) of a 16-row accumulator
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&acc)[NT][4], int kc) {
  a[0] = pack_bf16(acc[2 * kc][0], acc[2 * kc][1]);
  a[1] = pack_bf16(acc[2 * kc][2], acc[2 * kc][3]);
  a[2] = pack_bf16(acc[2 * kc + 1][0], acc[2 * kc + 1][1]);
  a[3] = pack_bf16(acc[2 * kc + 1][2], acc[2 * kc + 1][3]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// acc [16 x 8 NT] += A . B^T: A from registers (D / 16 fragments), B rows
// [0, 8 NT) of a [n][D] tile
template <int D, int NT>
__device__ __forceinline__ void gemm_abt(float (&acc)[NT][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* b_tile, int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_b<D>(b, b_tile, 16 * np, kc, lane);
      mma16816(acc[2 * np], a[kc], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
}

// the same with A = rows [a_r0, a_r0 + 16) of a [rows][D] tile
template <int D, int NT>
__device__ __forceinline__ void gemm_abt(float (&acc)[NT][4], const bf16* a_tile, int a_r0,
                                         const bf16* b_tile, int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ldsm_a<D>(a, a_tile, a_r0, kc, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_b<D>(b, b_tile, 16 * np, kc, lane);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc [16 x D] += P . B: P a 16 x 8 KT accumulator (packed to bf16 A
// fragments in registers), B rows [0, 8 KT) of a [k][D] tile
template <int D, int KT>
__device__ __forceinline__ void gemm_pb(float (&acc)[D / 8][4], const float (&p)[KT][4],
                                        const bf16* b_tile, int lane) {
#pragma unroll
  for (int kc = 0; kc < KT / 2; ++kc) {
    uint32_t a[4];
    acc_to_a<KT>(a, p, kc);
#pragma unroll
    for (int nc = 0; nc < D / 16; ++nc) {
      uint32_t b[4];
      ldsm_bt<D>(b, b_tile, 16 * kc, nc, lane);
      mma16816(acc[2 * nc], a, b[0], b[1]);
      mma16816(acc[2 * nc + 1], a, b[2], b[3]);
    }
  }
}

// ---- softmax on fragments -------------------------------------------------- //

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the four lanes of a quad hold one row: reduce over them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Online softmax over one tile of raw scores s [16 x 8 NT] (hidden pairs
// at -inf), for the thread's rows g (i = 0) and g + 8 (i = 1): m[i] is the
// running max of raw scores, l[i] this thread's share of the running sum
// of exp(scale (s - m)) (summed over the quad at the end), `scale_log2` =
// scale * log2(e). Overwrites s with the tile's probabilities relative to
// the new max and returns in alpha[i] the factor that rescales what was
// accumulated before. A row that has seen no visible key keeps m = -inf
// and gets p = 0, alpha = 0.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m[i];
#pragma unroll
    for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
    mx = quad_max(mx);
    const float base = mx == -INFINITY ? 0.f : mx * scale_log2;
    alpha[i] = exp2_approx(m[i] * scale_log2 - base);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        s[n][e] = exp2_approx(fmaf(s[n][e], scale_log2, -base));
        sum += s[n][e];
      }
    l[i] = l[i] * alpha[i] + sum;
    m[i] = mx;
  }
}

// ---- kernel attributes ---------------------------------------------------- //

// out[0..5] = registers per thread, local (spill) bytes per thread, static
// shared bytes, dynamic shared bytes of a launch, threads per block, and
// resident blocks per SM at that launch; returns the cudaError_t
template <typename Kernel>
int kernel_attributes(Kernel* kernel, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = threads;
  out[5] = blocks;
  return 0;
}

}  // namespace mma
}  // namespace dstorch

// Dispatch on the head dims the mma kernels are built for: returns
// FN<D>(...), or -1 for any other head dim.
#define DSTORCH_MMA_DISPATCH_D(D, FN, ...)  \
  switch (D) {                              \
    case 16: return FN<16>(__VA_ARGS__);    \
    case 32: return FN<32>(__VA_ARGS__);    \
    case 64: return FN<64>(__VA_ARGS__);    \
    case 128: return FN<128>(__VA_ARGS__);  \
    default: return -1;                     \
  }
