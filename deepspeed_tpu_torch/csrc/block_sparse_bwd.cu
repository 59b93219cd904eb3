// Block-sparse attention backward, bf16, sm_90a: two kernels.
//
// Replace deepspeed_tpu/ops/pallas/block_sparse_attention.py:132 _dq_kernel
// and :161 _dkv_kernel (launched through _BSA._common, :249). Inputs q, k,
// v, do [B, H, S, D] bf16; lse and delta = rowsum(dO * O) [B, H, S] f32
// (delta from the caller, as the JAX package computes it outside Pallas).
// The probabilities are recomputed from lse over the same tiles and fine
// pattern as the forward (block_sparse_fwd.cu):
//   p = exp(q.k * scale - lse),  dp = dO.v,  ds = p * (dp - delta) * scale
//   dq = sum_k ds k     (block_sparse_dq: block per 64-row q-tile, walking
//                        the q-tile's active k-tiles, row_ptr/ent)
//   dv = sum_q p dO,  dk = sum_q ds q
//                       (block_sparse_dkv: block per 64-key k-tile, walking
//                        the TRANSPOSED table col_ptr/tent, the q-tiles that
//                        attend it, as _BSA.rows :218; each block owns its
//                        keys' sums, so no atomics and the result is
//                        deterministic)
// p and ds are rounded to bf16 before their products, as the Pallas kernels
// cast them (:152, :179, :186). An excluded pair contributes nothing, so a
// row that sees no key (lse = -1e30) gets zero gradients.
//
// Bounds on the H100 at phase 7's documented fixed layout (B = 2, H = 16,
// S = 4096, D = 64, 141 M visible pairs): dq does three products a pair,
// 6*D flops, 54 GFLOP = 55 us at 989 TFLOP/s, against 85 MB (25 us); dk/dv
// four products, 8*D flops, 72 GFLOP = 73 us, against 101 MB (30 us). Both
// are bound by operations.
//
// Design: K1's backward (flash_bwd.cu) with its key or query loop driven by
// the tile list: 256 threads, 64 x 64 tiles in shared memory with padded
// rows, f32 FMAs on CUDA cores (tile_common.cuh), tensor cores idle.
#include "tile_common.cuh"

namespace dstorch {

template <int D>
__global__ void __launch_bounds__(kTileThreads)
block_sparse_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, const int* __restrict__ row_ptr,
                       const int2* __restrict__ ent, int H, int S, int Hl, float scale,
                       int causal) {
  using Sm = BwdSmem<D>;
  extern __shared__ __align__(16) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Sm::tile_bytes);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * Sm::tile_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * Sm::tile_bytes);
  float* dS = reinterpret_cast<float*>(smem + 4 * Sm::tile_bytes);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * Sm::tile_bytes + Sm::f32_tile_bytes);
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, h = bh % H;
  const int nt = (S + kBQ - 1) / kBQ;
  const int it = blockIdx.y;
  const int r0 = it * kBQ, n_q = min(kBQ, S - r0);
  const size_t base = (size_t)bh * S * D;
  const int* tp = row_ptr + (size_t)(h % Hl) * (nt + 1);
  const int e0 = tp[it], e1 = tp[it + 1];

  stage_rows<D>(Qs, q + base + (size_t)r0 * D, D, n_q);
  stage_rows<D>(dOs, dout + base + (size_t)r0 * D, D, n_q);
  if (tid < kBQ) {
    lse_s[tid] = tid < n_q ? lse[(size_t)bh * S + r0 + tid] : 0.f;
    delta_s[tid] = tid < n_q ? delta[(size_t)bh * S + r0 + tid] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[r][n] = 0.f;

  for (int e = e0; e < e1; ++e) {
    const int2 en = ent[e];
    const int k0 = en.x * kBK, n_k = min(kBK, S - k0);
    __syncthreads();  // previous tile's readers are done
    stage_rows<D>(Ks, k + base + (size_t)k0 * D, D, n_k);
    stage_rows<D>(Vs, v + base + (size_t)k0 * D, D, n_k);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, s);
    tile_dot<D>(dOs, Vs, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tx + 16 * c;
        const bool ok = row < n_q && key < n_k && fine_bit(en.y, row, key) &&
                        (!causal || k0 + key <= r0 + row);
        const float p = ok ? __expf(s[r][c] * scale - lse_s[row]) : 0.f;
        dS[row * Sm::PS + key] = round_bf16(p * (dp[r][c] - delta_s[row]) * scale);
      }
    }
    __syncthreads();  // ds complete
    tile_accumulate<D>(dS, Ks, acc);
  }
  store_rows<D>(dq + base + (size_t)r0 * D, D, n_q, acc);
}

template <int D>
__global__ void __launch_bounds__(kTileThreads)
block_sparse_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        const int* __restrict__ col_ptr, const int2* __restrict__ tent,
                        int H, int S, int Hl, float scale, int causal) {
  using Sm = BwdSmem<D>;
  extern __shared__ __align__(16) char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Sm::tile_bytes);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * Sm::tile_bytes);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * Sm::tile_bytes);
  float* Pt = reinterpret_cast<float*>(smem + 4 * Sm::tile_bytes);
  float* dSt = reinterpret_cast<float*>(smem + 4 * Sm::tile_bytes + Sm::f32_tile_bytes);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * Sm::tile_bytes + 2 * Sm::f32_tile_bytes);
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, h = bh % H;
  const int nt = (S + kBK - 1) / kBK;
  const int jt = blockIdx.y;
  const int k0 = jt * kBK, n_k = min(kBK, S - k0);
  const size_t base = (size_t)bh * S * D;
  const int* tp = col_ptr + (size_t)(h % Hl) * (nt + 1);
  const int e0 = tp[jt], e1 = tp[jt + 1];

  stage_rows<D>(Ks, k + base + (size_t)k0 * D, D, n_k);
  stage_rows<D>(Vs, v + base + (size_t)k0 * D, D, n_k);
  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc_k[r][n] = acc_v[r][n] = 0.f;

  for (int e = e0; e < e1; ++e) {
    const int2 en = tent[e];  // (q-tile, bits in the forward's orientation)
    const int q0 = en.x * kBQ, n_q = min(kBQ, S - q0);
    __syncthreads();  // previous tile's readers are done
    stage_rows<D>(Qs, q + base + (size_t)q0 * D, D, n_q);
    stage_rows<D>(dOs, dout + base + (size_t)q0 * D, D, n_q);
    if (tid < kBQ) {
      lse_s[tid] = tid < n_q ? lse[(size_t)bh * S + q0 + tid] : 0.f;
      delta_s[tid] = tid < n_q ? delta[(size_t)bh * S + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Ks, Qs, s);    // s[r][c] = k[4ty + r] . q[tx + 16c]
    tile_dot<D>(Vs, dOs, dp);  // dp[r][c] = v[4ty + r] . dO[tx + 16c]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kr = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 16 * c;
        const bool ok = kr < n_k && qc < n_q && fine_bit(en.y, qc, kr) &&
                        (!causal || q0 + qc >= k0 + kr);
        const float p = ok ? __expf(s[r][c] * scale - lse_s[qc]) : 0.f;
        Pt[kr * Sm::PS + qc] = round_bf16(p);
        dSt[kr * Sm::PS + qc] = round_bf16(p * (dp[r][c] - delta_s[qc]) * scale);
      }
    }
    __syncthreads();  // p and ds complete
    tile_accumulate<D>(Pt, dOs, acc_v);
    tile_accumulate<D>(dSt, Qs, acc_k);
  }
  store_rows<D>(dk + base + (size_t)k0 * D, D, n_k, acc_k);
  store_rows<D>(dv + base + (size_t)k0 * D, D, n_k, acc_v);
}

template <int D>
int launch_block_sparse_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq,
                           const void* row_ptr, const void* ent, int B, int H, int S,
                           int Hl, float scale, int causal, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_sparse_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  block_sparse_dq_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<const int*>(row_ptr),
      static_cast<const int2*>(ent), H, S, Hl, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_block_sparse_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv,
                            const void* col_ptr, const void* tent, int B, int H, int S,
                            int Hl, float scale, int causal, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_sparse_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + kBK - 1) / kBK);
  block_sparse_dkv_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<const int*>(col_ptr),
      static_cast<const int2*>(tent), H, S, Hl, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace dstorch

#define DSTORCH_K9_DISPATCH(D, FN, ...)    \
  switch (D) {                             \
    case 16: return FN<16>(__VA_ARGS__);   \
    case 32: return FN<32>(__VA_ARGS__);   \
    case 64: return FN<64>(__VA_ARGS__);   \
    case 128: return FN<128>(__VA_ARGS__); \
    default: return -1;                    \
  }

// q, k, v, dout [B, H, S, D] bf16; lse, delta [B, H, S] f32; the forward's
// tables row_ptr [Hl, nt + 1], ent [nnz, 2] int32 -> dq [B, H, S, D] bf16.
// Returns the launch's cudaError_t, -1 for an unsupported head dim.
extern "C" int dstorch_block_sparse_dq_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dq,
                                            const void* row_ptr, const void* ent, int B,
                                            int H, int S, int D, int Hl, float scale,
                                            int causal, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_K9_DISPATCH(D, dstorch::launch_block_sparse_dq, q, k, v, dout, lse, delta, dq,
                      row_ptr, ent, B, H, S, Hl, scale, causal, st)
}

// Same inputs with the transposed tables col_ptr [Hl, nt + 1], tent [nnz, 2]
// (q-tile, bits) -> dk, dv [B, H, S, D] bf16.
extern "C" int dstorch_block_sparse_dkv_bf16(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dk, void* dv,
                                             const void* col_ptr, const void* tent, int B,
                                             int H, int S, int D, int Hl, float scale,
                                             int causal, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_K9_DISPATCH(D, dstorch::launch_block_sparse_dkv, q, k, v, dout, lse, delta, dk,
                      dv, col_ptr, tent, B, H, S, Hl, scale, causal, st)
}
