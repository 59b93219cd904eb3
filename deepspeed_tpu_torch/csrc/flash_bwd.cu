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
//                        each block owns its keys' sums, so no atomics and
//                        dq, dk, dv are the same bits from run to run)
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
// Design (FlashAttention-2's backward on mma.sync; mma_common.cuh), 4 warps
// a block, each warp owning 16 rows of every product, all products on the
// tensor cores with f32 accumulators in registers:
// - flash_bwd_dkv: the block's 64 K and V rows stay in shared memory; Q, dO,
//   lse and delta tiles of BQ queries stream through a 2-stage cp.async
//   ring, from q0 = k0 under causal. A warp computes S^T = K.Q^T, P^T =
//   exp(S^T scale - lse) in registers, dV += P^T.dO (P^T packed to bf16 A
//   fragments in registers, dO through ldmatrix.trans), dP^T = V.dO^T, dS^T
//   = P^T (dP^T - delta) scale, dK += dS^T.Q (Q through ldmatrix.trans).
// - flash_bwd_dq: the block's 64 Q and dO rows stay in shared memory; K and
//   V tiles of 64 keys stream through the ring. S = Q.K^T, P, dP = dO.V^T,
//   dS, dQ += dS.K (K through ldmatrix.trans), dS from registers.
// Only tiles that cross the diagonal or a ragged edge evaluate the mask.
// The dk/dv kernel streams 64 queries a step at D = 16 and 64, 32 at D = 32
// and 16 at D = 128 (where dK and dV alone hold 128 f32 registers): at 64
// queries, D = 32 and 128 spilled (ptxas: 12 and 36 bytes).
#include "mma_common.cuh"

namespace dstorch {

using mma::bf16;

int flash_fwd_attributes(int D, int* out);  // flash_fwd.cu

constexpr int kBwdThreads = 128;  // 4 warps of 16 rows
constexpr int kBwdRows = 64;      // dq: query rows a block; dk/dv: keys a block
constexpr int kDqBK = 64;         // dq: keys a step

template <int D>
struct BwdCfg {
  // dk/dv: queries a step, as many as keep dK, dV and the step's P^T and
  // dS^T in registers without a spill
  static constexpr int BQ = D == 128 ? 16 : D == 32 ? 32 : 64;
  // dq: Q, dO, then two stages of K and V
  static constexpr size_t dq_bytes = (size_t)(2 * kBwdRows + 4 * kDqBK) * D * sizeof(bf16);
  // dk/dv: K, V, two stages of Q and dO, then two stages of lse and delta
  static constexpr size_t dkv_bytes =
      (size_t)(2 * kBwdRows + 4 * BQ) * D * sizeof(bf16) + 4 * BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Tq, int Tk, int H, float scale,
                    int causal) {
  constexpr int BQ = kBwdRows, BK = kDqBK, NT = BK / 8;
  extern __shared__ __align__(128) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * D;
  auto k_tile = [=](int s) { return Qs + (2 * BQ + 2 * BK * s) * D; };
  auto v_tile = [=](int s) { return Qs + (2 * BQ + 2 * BK * s + BK) * D; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int nq = (Tq + BQ - 1) / BQ;
  const int r0 = (nq - 1 - (int)blockIdx.y) * BQ;
  const int n_q = min(BQ, Tq - r0);
  const int n_keys = causal ? min(Tk, r0 + n_q) : Tk;
  const int n_tiles = (n_keys + BK - 1) / BK;
  const size_t stride = (size_t)H * D;
  const size_t q_off = (((size_t)b * Tq + r0) * H + h) * D;
  const bf16* kb = k + ((size_t)b * Tk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Tk * H + h) * D;
  const int wr0 = r0 + 16 * warp;

  auto load_kv = [&](int j, int s) {
    const int k0 = j * BK, n = min(BK, n_keys - k0);
    mma::load_tile<D, BK, kBwdThreads>(k_tile(s), kb + k0 * stride, stride, n, tid);
    mma::load_tile<D, BK, kBwdThreads>(v_tile(s), vb + k0 * stride, stride, n, tid);
  };
  mma::load_tile<D, BQ, kBwdThreads>(Qs, q + q_off, stride, n_q, tid);
  mma::load_tile<D, BQ, kBwdThreads>(dOs, dout + q_off, stride, n_q, tid);
  if (n_tiles > 0) load_kv(0, 0);
  mma::cp_async_commit();
  // the thread's rows g and g + 8: lse (in log2 units) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    lse2[i] = row < Tq ? lse[(size_t)bh * Tq + row] * mma::kLog2e : 0.f;
    dlt[i] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
  }
  const float scale_log2 = scale * mma::kLog2e;
  float acc[D / 8][4];
  mma::zero(acc);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1, k0 = j * BK;
    if (j + 1 < n_tiles) {
      load_kv(j + 1, s ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (!(causal && k0 > wr0 + 15)) {
      float p[NT][4], ds[NT][4];
      mma::zero(p);
      mma::gemm_abt<D, NT>(p, Qs, 16 * warp, k_tile(s), lane);
      const bool edge = (causal && k0 + BK - 1 > wr0) || k0 + BK > Tk;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = mma::exp2_approx(fmaf(p[n][e], scale_log2, -lse2[e >> 1]));
          if (edge) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const int row = wr0 + g + 8 * (e >> 1);
            if (key >= Tk || (causal && key > row)) x = 0.f;
          }
          p[n][e] = x;
        }
      mma::zero(ds);
      mma::gemm_abt<D, NT>(ds, dOs, 16 * warp, v_tile(s), lane);  // dP
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] = p[n][e] * (ds[n][e] - dlt[e >> 1]) * scale;
      mma::gemm_pb<D, NT>(acc, ds, k_tile(s), lane);
    }
    __syncthreads();  // stage s is free for tile j + 2
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    if (row >= Tq) continue;
    bf16* out = dq + (((size_t)b * Tq + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk,
                     int H, float scale, int causal) {
  constexpr int BK = kBwdRows, BQ = BwdCfg<D>::BQ, NT = BQ / 8;
  extern __shared__ __align__(128) char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * D;
  auto q_tile = [=](int s) { return Ks + (2 * BK + 2 * BQ * s) * D; };
  auto do_tile = [=](int s) { return Ks + (2 * BK + 2 * BQ * s + BQ) * D; };
  float* vecs = reinterpret_cast<float*>(Ks + (2 * BK + 4 * BQ) * D);
  auto lse_tile = [=](int s) { return vecs + 2 * BQ * s; };
  auto delta_tile = [=](int s) { return vecs + 2 * BQ * s + BQ; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  // low key blocks see the most queries under causal: issue them first
  const int k0 = (int)blockIdx.y * BK;
  const int n_k = min(BK, Tk - k0);
  const size_t stride = (size_t)H * D;
  const size_t k_off = (((size_t)b * Tk + k0) * H + h) * D;
  const bf16* qb = q + ((size_t)b * Tq * H + h) * D;
  const bf16* db = dout + ((size_t)b * Tq * H + h) * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* deb = delta + (size_t)bh * Tq;
  // under causal, queries before k0 see none of these keys
  const int q_start = causal ? k0 : 0;
  const int n_steps = q_start < Tq ? (Tq - q_start + BQ - 1) / BQ : 0;
  const int wk0 = k0 + 16 * warp;  // the warp's first key

  auto load_q = [&](int it, int s) {
    const int q0 = q_start + it * BQ, n = min(BQ, Tq - q0);
    mma::load_tile<D, BQ, kBwdThreads>(q_tile(s), qb + q0 * stride, stride, n, tid);
    mma::load_tile<D, BQ, kBwdThreads>(do_tile(s), db + q0 * stride, stride, n, tid);
    mma::load_vec<BQ, kBwdThreads>(lse_tile(s), lb + q0, n, tid);
    mma::load_vec<BQ, kBwdThreads>(delta_tile(s), deb + q0, n, tid);
  };
  mma::load_tile<D, BK, kBwdThreads>(Ks, k + k_off, stride, n_k, tid);
  mma::load_tile<D, BK, kBwdThreads>(Vs, v + k_off, stride, n_k, tid);
  if (n_steps > 0) load_q(0, 0);
  mma::cp_async_commit();

  const float scale_log2 = scale * mma::kLog2e;
  float acc_k[D / 8][4], acc_v[D / 8][4];
  mma::zero(acc_k);
  mma::zero(acc_v);

  for (int it = 0; it < n_steps; ++it) {
    const int s = it & 1, q0 = q_start + it * BQ;
    if (it + 1 < n_steps) {
      load_q(it + 1, s ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (!(causal && q0 + BQ - 1 < wk0)) {
      const float* ls = lse_tile(s);
      const float* dls = delta_tile(s);
      float p[NT][4], ds[NT][4];
      mma::zero(p);
      mma::gemm_abt<D, NT>(p, Ks, 16 * warp, q_tile(s), lane);  // S^T
      const bool edge = (causal && q0 < wk0 + 15) || q0 + BQ > Tq || k0 + BK > Tk;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t + (e & 1);
          float x = mma::exp2_approx(fmaf(p[n][e], scale_log2, -ls[qi] * mma::kLog2e));
          if (edge) {
            const int key = wk0 + g + 8 * (e >> 1);
            if (q0 + qi >= Tq || key >= Tk || (causal && key > q0 + qi)) x = 0.f;
          }
          p[n][e] = x;
        }
      mma::gemm_pb<D, NT>(acc_v, p, do_tile(s), lane);  // dV += P^T.dO
      mma::zero(ds);
      mma::gemm_abt<D, NT>(ds, Vs, 16 * warp, do_tile(s), lane);  // dP^T
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t + (e & 1);
          ds[n][e] = p[n][e] * (ds[n][e] - dls[qi]) * scale;
        }
      mma::gemm_pb<D, NT>(acc_k, ds, q_tile(s), lane);  // dK += dS^T.Q
    }
    __syncthreads();  // stage s is free for step it + 2
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = wk0 + g + 8 * i;
    if (key >= Tk) continue;
    const size_t off = (((size_t)b * Tk + key) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

template <int D>
int launch_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int Tq,
                        int Tk, int H, float scale, int causal, cudaStream_t stream) {
  const size_t smem = BwdCfg<D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + kBwdRows - 1) / kBwdRows);
  flash_bwd_dq_kernel<D><<<grid, kBwdThreads, smem, stream>>>(
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
  const size_t smem = BwdCfg<D>::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tk + kBwdRows - 1) / kBwdRows);
  flash_bwd_dkv_kernel<D><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_attributes(int kernel, int* out) {
  if (kernel == 1)
    return mma::kernel_attributes(flash_bwd_dq_kernel<D>, kBwdThreads,
                                  BwdCfg<D>::dq_bytes, out);
  return mma::kernel_attributes(flash_bwd_dkv_kernel<D>, kBwdThreads,
                                BwdCfg<D>::dkv_bytes, out);
}

}  // namespace dstorch

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
  DSTORCH_MMA_DISPATCH_D(D, dstorch::launch_flash_bwd_dq, q, k, v, dout, lse, delta, dq,
                         B, Tq, Tk, H, scale, causal, st)
}

// Same inputs -> dk, dv [B, Tk, H, D] bf16.
extern "C" int dstorch_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, int B,
                                          int Tq, int Tk, int H, int D, float scale,
                                          int causal, void* stream) {
  if (B == 0 || Tk == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_MMA_DISPATCH_D(D, dstorch::launch_flash_bwd_dkv, q, k, v, dout, lse, delta, dk,
                         dv, B, Tq, Tk, H, scale, causal, st)
}

// K1's kernels as compiled: kernel 0 = flash_fwd, 1 = flash_bwd_dq, 2 =
// flash_bwd_dkv, at head dim D; out [6] int32 = registers per thread, local
// (spill) bytes per thread, static and dynamic shared bytes per block,
// threads per block, resident blocks per SM. Returns a cudaError_t, -1 for
// an unknown kernel or head dim.
extern "C" int dstorch_flash_kernel_attrs(int kernel, int D, void* out) {
  int* o = static_cast<int*>(out);
  if (kernel == 0) return dstorch::flash_fwd_attributes(D, o);
  if (kernel != 1 && kernel != 2) return -1;
  DSTORCH_MMA_DISPATCH_D(D, dstorch::bwd_attributes, kernel, o)
}
