// Flash attention backward (training), bf16, sm_90a: two kernels.
//
// Replace deepspeed_tpu/ops/pallas/flash_attention.py:288 _bwd_dq_kernel
// and :327 _bwd_dkv_kernel (launched by _bwd, :373). Inputs q, do [B, Tq, H,
// D], k, v [B, Tk, H, D] bf16; lse and delta = rowsum(dO * O) [B, H, Tq] f32
// (delta is computed by the caller, as the JAX package computes it outside
// Pallas). The probabilities are recomputed from lse, never stored:
//   p = exp(q.k * scale - lse),  dp = dO.v,  ds = p * (dp - delta) * scale
//   dq = sum_k ds k     (flash_bwd_dq: block per 64 query rows, loop over keys)
//   dv = sum_q p dO,  dk = sum_q ds q
//                       (flash_bwd_dkv: block per 64 keys, loop over queries;
//                        each block owns its keys' sums, so no atomics)
// Masking follows the forward (flash_fwd.cu): causal is top-left aligned
// (key <= query); a pair that is not visible contributes nothing, so a row
// with no visible key gets zero gradients (the Pallas backward would recompute
// p = exp(-1e30 + 1e30) = 1 there).
//
// Bounds on the H100 at GPT-2 small's shape (B = 8, H = 12, T = 1024, D =
// 64, causal, 50.4 M visible pairs): dq does three products per pair, 6*D
// flops, 19.4 GFLOP = 19.6 us at 989 TFLOP/s, against 50.7 MB of bytes (15.1
// us); dk/dv four products, 8*D flops, 25.8 GFLOP = 26.1 us, against ~76 MB
// (22.6 us). Both are bound by operations.
//
// Design: 256 threads; 64 x 64 tiles staged in shared memory with padded rows
// (D + 2 bf16, an odd number of words, so the 16 threads reading 16 different
// rows at one depth hit 16 banks), f32 FMAs on CUDA cores, the thread layout
// of attn_common.cuh's flash_block: thread (ty, tx) owns tile rows 4ty..4ty+3
// and, for the 64 x 64 products, columns tx + 16c. The f32 p or ds tile goes
// through shared memory to the accumulation, where the thread owns dims
// tx + 16n of its four rows. Like the forward, this first version leaves the
// tensor cores idle.
#include "tile_common.cuh"

namespace dstorch {

template <int D>
__global__ void __launch_bounds__(kTileThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Tq, int Tk, int H, float scale,
                    int causal) {
  using S = BwdSmem<D>;
  extern __shared__ __align__(16) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + S::tile_bytes);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * S::tile_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * S::tile_bytes);
  float* dS = reinterpret_cast<float*>(smem + 4 * S::tile_bytes);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * S::tile_bytes + S::f32_tile_bytes);
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int nq = (Tq + kBQ - 1) / kBQ;
  const int r0 = (nq - 1 - (int)blockIdx.y) * kBQ;
  const int n_q = min(kBQ, Tq - r0);
  const int n_keys = causal ? min(Tk, r0 + n_q) : Tk;
  const size_t stride = (size_t)H * D;
  const size_t q_off = (((size_t)b * Tq + r0) * H + h) * D;
  const bf16* kb = k + ((size_t)b * Tk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Tk * H + h) * D;

  stage_rows<D>(Qs, q + q_off, stride, n_q);
  stage_rows<D>(dOs, dout + q_off, stride, n_q);
  if (tid < kBQ) {
    lse_s[tid] = tid < n_q ? lse[(size_t)bh * Tq + r0 + tid] : 0.f;
    delta_s[tid] = tid < n_q ? delta[(size_t)bh * Tq + r0 + tid] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[r][n] = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // previous tile's readers are done
    stage_rows<D>(Ks, kb + k0 * stride, stride, min(kBK, n_keys - k0));
    stage_rows<D>(Vs, vb + k0 * stride, stride, min(kBK, n_keys - k0));
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, s);
    tile_dot<D>(dOs, Vs, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        const bool ok = row < n_q && key < n_keys && (!causal || key <= r0 + row);
        const float p = ok ? __expf(s[r][c] * scale - lse_s[row]) : 0.f;
        dS[row * S::PS + tx + 16 * c] = p * (dp[r][c] - delta_s[row]) * scale;
      }
    }
    __syncthreads();  // ds complete
    tile_accumulate<D>(dS, Ks, acc);
  }
  store_rows<D>(dq + q_off, stride, n_q, acc);
}

template <int D>
__global__ void __launch_bounds__(kTileThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
                     int H, float scale, int causal) {
  using S = BwdSmem<D>;
  extern __shared__ __align__(16) char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::tile_bytes);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * S::tile_bytes);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * S::tile_bytes);
  float* Pt = reinterpret_cast<float*>(smem + 4 * S::tile_bytes);
  float* dSt = reinterpret_cast<float*>(smem + 4 * S::tile_bytes + S::f32_tile_bytes);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * S::tile_bytes + 2 * S::f32_tile_bytes);
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  // low key blocks see the most queries under causal: issue them first
  const int k0 = (int)blockIdx.y * kBK;
  const int n_k = min(kBK, Tk - k0);
  const size_t stride = (size_t)H * D;
  const size_t k_off = (((size_t)b * Tk + k0) * H + h) * D;
  const bf16* qb = q + ((size_t)b * Tq * H + h) * D;
  const bf16* db = dout + ((size_t)b * Tq * H + h) * D;

  stage_rows<D>(Ks, k + k_off, stride, n_k);
  stage_rows<D>(Vs, v + k_off, stride, n_k);
  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc_k[r][n] = acc_v[r][n] = 0.f;

  // under causal, queries before k0 see none of these keys
  for (int q0 = causal ? k0 : 0; q0 < Tq; q0 += kBQ) {
    const int n_q = min(kBQ, Tq - q0);
    __syncthreads();  // previous tile's readers are done
    stage_rows<D>(Qs, qb + q0 * stride, stride, n_q);
    stage_rows<D>(dOs, db + q0 * stride, stride, n_q);
    if (tid < kBQ) {
      lse_s[tid] = tid < n_q ? lse[(size_t)bh * Tq + q0 + tid] : 0.f;
      delta_s[tid] = tid < n_q ? delta[(size_t)bh * Tq + q0 + tid] : 0.f;
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
        const bool ok = kr < n_k && qc < n_q && (!causal || q0 + qc >= k0 + kr);
        const float p = ok ? __expf(s[r][c] * scale - lse_s[qc]) : 0.f;
        Pt[kr * S::PS + qc] = p;
        dSt[kr * S::PS + qc] = p * (dp[r][c] - delta_s[qc]) * scale;
      }
    }
    __syncthreads();  // p and ds complete
    tile_accumulate<D>(Pt, dOs, acc_v);
    tile_accumulate<D>(dSt, Qs, acc_k);
  }
  store_rows<D>(dk + k_off, stride, n_k, acc_k);
  store_rows<D>(dv + k_off, stride, n_k, acc_v);
}

template <int D>
int launch_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int Tq,
                        int Tk, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Tq, Tk, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B,
                         int Tq, int Tk, int H, float scale, int causal,
                         cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tk + kBK - 1) / kBK);
  flash_bwd_dkv_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, H, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace dstorch

#define DSTORCH_K1_DISPATCH(D, FN, ...)    \
  switch (D) {                             \
    case 16: return FN<16>(__VA_ARGS__);   \
    case 32: return FN<32>(__VA_ARGS__);   \
    case 64: return FN<64>(__VA_ARGS__);   \
    case 128: return FN<128>(__VA_ARGS__); \
    default: return -1;                    \
  }

// q, dout [B, Tq, H, D], k, v [B, Tk, H, D] bf16; lse, delta [B, H, Tq] f32
// -> dq [B, Tq, H, D] bf16. Returns the launch's cudaError_t, -1 for an
// unsupported head dim.
extern "C" int dstorch_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, void* dq, int B, int Tq,
                                         int Tk, int H, int D, float scale, int causal,
                                         void* stream) {
  if (B == 0 || Tq == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_K1_DISPATCH(D, dstorch::launch_flash_bwd_dq, q, k, v, dout, lse, delta, dq, B,
                      Tq, Tk, H, scale, causal, st)
}

// Same inputs -> dk, dv [B, Tk, H, D] bf16.
extern "C" int dstorch_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, int B,
                                          int Tq, int Tk, int H, int D, float scale,
                                          int causal, void* stream) {
  if (B == 0 || Tk == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_K1_DISPATCH(D, dstorch::launch_flash_bwd_dkv, q, k, v, dout, lse, delta, dk, dv,
                      B, Tq, Tk, H, scale, causal, st)
}
