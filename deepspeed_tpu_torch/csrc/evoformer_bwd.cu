// Evoformer pair-bias attention backward, bf16, sm_90a: three kernels.
//
// Replace deepspeed_tpu/ops/pallas/evoformer_attention.py:155
// _bwd_dq_kernel, :184 _bwd_dkv_kernel and :219 _bwd_dbias_kernel
// (launched by _bwd, :248). Inputs q, k, v, dO [L, S, H, D] bf16, the mask
// bias [L, S] f32 (or none), the pair bias [G, H, S, S] (bf16 or f32, PT),
// lse and delta = rowsum(dO * O) [L, H, S] f32 (delta from the caller, as
// the JAX package computes it outside Pallas, :256). The probabilities are
// recomputed from the saved lse with the forward's score order
// (evoformer_common.cuh), never from a new max and sum:
//   p = exp(s - lse),  dp = dO . v,  ds = p * (dp - delta) * scale
//   dq = sum_k ds k                 (evoformer_dq: block per (l, q-tile, h))
//   dv = sum_q p dO, dk = sum_q ds q (evoformer_dkv: block per (l, k-tile,
//                                     h); it owns its keys: no atomics)
//   dpair[g] = sum_{r < R} p * (dp - delta)   (evoformer_dbias: block per
//       (k-tile, q-tile, g * H + h), looping over the group's R rows with
//       the 64 x 64 f32 sum in registers, written once in the pair bias's
//       type: no atomics, deterministic. No scale factor: the bias enters
//       after the scaling.)
// p and ds are rounded to bf16 before their products, as the Pallas
// kernels cast them (:175, :203, :209).
//
// Bounds on the H100 at AlphaFold 2's MSA row attention (L = 512, S = 384,
// H = 8, D = 32, R = 512, 604 M pairs; each [L, S, H, D] bf16 tensor 100.7
// MB): dq reads q, k, v, dO and writes dq, 6*D flops a pair: 0.155 ms by
// bytes against 0.117 ms by operations; dk/dv reads four tensors and writes
// two, 8*D flops: 0.185 against 0.156 ms; d(pair) reads four, 4*D flops:
// 0.126 against 0.078 ms. Bytes bound all three.
//
// Design: K9's backward (block_sparse_bwd.cu) over every tile, with the two
// biases added to each recomputed score: 256 threads, 64 x 64 tiles staged
// from the [L, S, H, D] layout in shared memory with padded rows, f32 FMAs
// on CUDA cores (tile_common.cuh), tensor cores idle. dq and dk/dv run l
// fastest in the grid, as the forward, so one (tile, h)'s pair-bias strip
// serves many rows from L2. dk/dv computes its score tile query-major (the
// pair bias's row order, so its reads coalesce) and stores p and ds
// transposed for the key-major sums.
#include "evoformer_common.cuh"

namespace dstorch {

template <int D, typename PT>
__global__ void __launch_bounds__(kTileThreads)
evoformer_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ mask, const PT* __restrict__ pair,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int S, int H, int R, float scale) {
  using Sm = BwdSmem<D>;
  extern __shared__ __align__(16) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Sm::tile_bytes);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * Sm::tile_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * Sm::tile_bytes);
  float* dS = reinterpret_cast<float*>(smem + 4 * Sm::tile_bytes);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int l = blockIdx.x, h = blockIdx.z;
  const int r0 = blockIdx.y * kBQ, n_q = min(kBQ, S - r0);
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)l * S * H + h) * D;
  const size_t stat = ((size_t)l * H + h) * S + r0;
  const PT* pb = pair + ((size_t)(l / R) * H + h) * S * S + (size_t)r0 * S;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)l * S;

  stage_rows<D>(Qs, q + base + r0 * rs, rs, n_q);
  stage_rows<D>(dOs, dout + base + r0 * rs, rs, n_q);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    lse_r[r] = row < n_q ? lse[stat + row] : 0.f;
    delta_r[r] = row < n_q ? delta[stat + row] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[r][n] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    const int n_k = min(kBK, S - k0);
    __syncthreads();  // previous tile's readers are done
    stage_rows<D>(Ks, k + base + k0 * rs, rs, n_k);
    stage_rows<D>(Vs, v + base + k0 * rs, rs, n_k);
    float mk[4];
    load_key_mask(mrow, k0, n_k, mk);
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
        const bool ok = row < n_q && key < n_k;
        const float p =
            ok ? __expf(evo_score(s[r][c], scale, mk[c],
                                  to_f32(pb[(size_t)row * S + k0 + key])) - lse_r[r])
               : 0.f;
        dS[row * Sm::PS + key] = round_bf16(p * (dp[r][c] - delta_r[r]) * scale);
      }
    }
    __syncthreads();  // ds complete
    tile_accumulate<D>(dS, Ks, acc);
  }
  store_rows<D>(dq + base + r0 * rs, rs, n_q, acc);
}

template <int D, typename PT>
__global__ void __launch_bounds__(kTileThreads)
evoformer_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ mask, const PT* __restrict__ pair,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int R,
                     float scale) {
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
  const int l = blockIdx.x, h = blockIdx.z;
  const int k0 = blockIdx.y * kBK, n_k = min(kBK, S - k0);
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)l * S * H + h) * D;
  const size_t stat = ((size_t)l * H + h) * S;
  const PT* pb = pair + ((size_t)(l / R) * H + h) * S * S + k0;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)l * S;

  stage_rows<D>(Ks, k + base + k0 * rs, rs, n_k);
  stage_rows<D>(Vs, v + base + k0 * rs, rs, n_k);
  float mk[4];  // this block's keys tx + 16c
  load_key_mask(mrow, k0, n_k, mk);
  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc_k[r][n] = acc_v[r][n] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kBQ) {
    const int n_q = min(kBQ, S - q0);
    __syncthreads();  // previous tile's readers are done
    stage_rows<D>(Qs, q + base + q0 * rs, rs, n_q);
    stage_rows<D>(dOs, dout + base + q0 * rs, rs, n_q);
    if (tid < kBQ) {
      lse_s[tid] = tid < n_q ? lse[stat + q0 + tid] : 0.f;
      delta_s[tid] = tid < n_q ? delta[stat + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, s);    // s[r][c] = q[4ty + r] . k[tx + 16c]
    tile_dot<D>(dOs, Vs, dp);  // dp[r][c] = dO[4ty + r] . v[tx + 16c]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qr = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tx + 16 * c;
        const bool ok = qr < n_q && kc < n_k;
        const float p =
            ok ? __expf(evo_score(s[r][c], scale, mk[c],
                                  to_f32(pb[(size_t)(q0 + qr) * S + kc])) - lse_s[qr])
               : 0.f;
        Pt[kc * Sm::PS + qr] = round_bf16(p);
        dSt[kc * Sm::PS + qr] = round_bf16(p * (dp[r][c] - delta_s[qr]) * scale);
      }
    }
    __syncthreads();  // p and ds complete
    tile_accumulate<D>(Pt, dOs, acc_v);
    tile_accumulate<D>(dSt, Qs, acc_k);
  }
  store_rows<D>(dk + base + k0 * rs, rs, n_k, acc_k);
  store_rows<D>(dv + base + k0 * rs, rs, n_k, acc_v);
}

template <int D>
struct EvoDbiasSmem {
  using T = BwdSmem<D>;
  // Q, dO, K, V tiles + lse, delta
  static constexpr size_t bytes = 4 * T::tile_bytes + 2 * T::row_bytes;
};

template <int D, typename PT>
__global__ void __launch_bounds__(kTileThreads)
evoformer_dbias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ mask, const PT* __restrict__ pair,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       PT* __restrict__ dpair, int S, int H, int R, float scale) {
  using Sm = BwdSmem<D>;
  extern __shared__ __align__(16) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Sm::tile_bytes);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * Sm::tile_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * Sm::tile_bytes);
  float* lse_s = reinterpret_cast<float*>(smem + 4 * Sm::tile_bytes);
  float* delta_s = lse_s + kBQ;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kBK, n_k = min(kBK, S - k0);
  const int q0 = blockIdx.y * kBQ, n_q = min(kBQ, S - q0);
  const int gh = blockIdx.z, g = gh / H, h = gh - g * H;
  const size_t rs = (size_t)H * D;
  const size_t tile = (size_t)gh * S * S + (size_t)q0 * S + k0;

  // this thread's 16 pair-bias entries, and its 16 sums over the R rows
  float pb[4][4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = ty * 4 + r, key = tx + 16 * c;
      pb[r][c] = row < n_q && key < n_k ? to_f32(pair[tile + (size_t)row * S + key]) : 0.f;
      acc[r][c] = 0.f;
    }

  for (int rr = 0; rr < R; ++rr) {
    const int l = g * R + rr;
    const size_t base = ((size_t)l * S * H + h) * D;
    const size_t stat = ((size_t)l * H + h) * S + q0;
    __syncthreads();  // previous row's readers are done
    stage_rows<D>(Qs, q + base + q0 * rs, rs, n_q);
    stage_rows<D>(dOs, dout + base + q0 * rs, rs, n_q);
    stage_rows<D>(Ks, k + base + k0 * rs, rs, n_k);
    stage_rows<D>(Vs, v + base + k0 * rs, rs, n_k);
    if (tid < kBQ) {
      lse_s[tid] = tid < n_q ? lse[stat + tid] : 0.f;
      delta_s[tid] = tid < n_q ? delta[stat + tid] : 0.f;
    }
    float mk[4];
    load_key_mask(mask == nullptr ? nullptr : mask + (size_t)l * S, k0, n_k, mk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, s);
    tile_dot<D>(dOs, Vs, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = row < n_q && tx + 16 * c < n_k;
        const float p =
            ok ? __expf(evo_score(s[r][c], scale, mk[c], pb[r][c]) - lse_s[row]) : 0.f;
        acc[r][c] += p * (dp[r][c] - delta_s[row]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = ty * 4 + r, key = tx + 16 * c;
      if (row < n_q && key < n_k) store_f32(dpair + tile + (size_t)row * S + key, acc[r][c]);
    }
}

template <int D, typename PT>
int launch_evoformer_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* mask, const void* pair, const void* lse,
                        const void* delta, void* dq, int L, int S, int H, int R, float scale,
                        cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(evoformer_dq_kernel<D, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L, (S + kBQ - 1) / kBQ, H);
  evoformer_dq_kernel<D, PT><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(mask), static_cast<const PT*>(pair),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), S, H, R, scale);
  return (int)cudaGetLastError();
}

template <int D, typename PT>
int launch_evoformer_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* mask, const void* pair, const void* lse,
                         const void* delta, void* dk, void* dv, int L, int S, int H, int R,
                         float scale, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dkv_bytes;
  cudaError_t err = cudaFuncSetAttribute(evoformer_dkv_kernel<D, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L, (S + kBK - 1) / kBK, H);
  evoformer_dkv_kernel<D, PT><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(mask), static_cast<const PT*>(pair),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, R, scale);
  return (int)cudaGetLastError();
}

template <int D, typename PT>
int launch_evoformer_dbias(const void* q, const void* k, const void* v, const void* dout,
                           const void* mask, const void* pair, const void* lse,
                           const void* delta, void* dpair, int L, int S, int H, int R,
                           float scale, cudaStream_t stream) {
  const size_t smem = EvoDbiasSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(evoformer_dbias_kernel<D, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (S + kBQ - 1) / kBQ;
  dim3 grid(nt, nt, (L / R) * H);
  evoformer_dbias_kernel<D, PT><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(mask), static_cast<const PT*>(pair),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<PT*>(dpair), S, H, R, scale);
  return (int)cudaGetLastError();
}

}  // namespace dstorch

// q, k, v, dout [L, S, H, D] bf16; mask [L, S] f32 or null; pair
// [L / R, H, S, S] (f32 when pair_f32, else bf16); lse, delta [L, H, S] f32
// -> dq [L, S, H, D] bf16. Returns the launch's cudaError_t, -1 for an
// unsupported head dim.
extern "C" int dstorch_evoformer_dq_bf16(const void* q, const void* k, const void* v,
                                         const void* dout, const void* mask,
                                         const void* pair, const void* lse,
                                         const void* delta, void* dq, int L, int S, int H,
                                         int D, int R, float scale, int pair_f32,
                                         void* stream) {
  if (L == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pair_f32) {
    DSTORCH_K10_DISPATCH(D, float, dstorch::launch_evoformer_dq, q, k, v, dout, mask, pair,
                         lse, delta, dq, L, S, H, R, scale, st)
  }
  DSTORCH_K10_DISPATCH(D, dstorch::bf16, dstorch::launch_evoformer_dq, q, k, v, dout, mask,
                       pair, lse, delta, dq, L, S, H, R, scale, st)
}

// Same inputs -> dk, dv [L, S, H, D] bf16.
extern "C" int dstorch_evoformer_dkv_bf16(const void* q, const void* k, const void* v,
                                          const void* dout, const void* mask,
                                          const void* pair, const void* lse,
                                          const void* delta, void* dk, void* dv, int L,
                                          int S, int H, int D, int R, float scale,
                                          int pair_f32, void* stream) {
  if (L == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pair_f32) {
    DSTORCH_K10_DISPATCH(D, float, dstorch::launch_evoformer_dkv, q, k, v, dout, mask, pair,
                         lse, delta, dk, dv, L, S, H, R, scale, st)
  }
  DSTORCH_K10_DISPATCH(D, dstorch::bf16, dstorch::launch_evoformer_dkv, q, k, v, dout, mask,
                       pair, lse, delta, dk, dv, L, S, H, R, scale, st)
}

// Same inputs -> dpair [L / R, H, S, S] in the pair bias's type.
extern "C" int dstorch_evoformer_dbias_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* mask,
                                            const void* pair, const void* lse,
                                            const void* delta, void* dpair, int L, int S,
                                            int H, int D, int R, float scale, int pair_f32,
                                            void* stream) {
  if (L == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pair_f32) {
    DSTORCH_K10_DISPATCH(D, float, dstorch::launch_evoformer_dbias, q, k, v, dout, mask,
                         pair, lse, delta, dpair, L, S, H, R, scale, st)
  }
  DSTORCH_K10_DISPATCH(D, dstorch::bf16, dstorch::launch_evoformer_dbias, q, k, v, dout,
                       mask, pair, lse, delta, dpair, L, S, H, R, scale, st)
}
