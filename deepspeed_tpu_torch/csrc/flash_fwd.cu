// Flash attention forward with log-sum-exp (training), bf16, sm_90a.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:54 _fwd_kernel
// (launched by _fwd, :100): q [B, Tq, H, D], k/v [B, Tk, H, D] -> o
// [B, Tq, H, D] and lse [B, H, Tq] f32 (the backward's input). Causal
// masking is TOP-LEFT aligned, as in the Pallas kernel: query i sees key j
// iff j <= i, also when Tq != Tk. A row that sees no key gets o = 0 and
// lse = -1e30.
//
// Bound on the H100 at GPT-2 small's training shape (B = 8, H = 12, T =
// 1024, D = 64, causal): q, k, v and o are 12.6 MB each and lse 0.4 MB,
// 50.7 MB in all (15.1 us at 3.35 TB/s); the 50.4 M visible (query, key)
// pairs cost 4*D flops each, 12.9 GFLOP (13.0 us at 989 TFLOP/s bf16). So the
// bound is bytes, with operations close behind.
//
// Design (FlashAttention-2's forward on mma.sync; mma_common.cuh): grid
// (B*H, q-block), a block of kFwdWarps warps, each warp owning 16 query
// rows, reading the [B, T, H, D] layout directly (row stride H*D). Q is
// loaded once (cp.async, then ldmatrix into A fragments that stay in
// registers). K and V tiles of 64 keys stream through shared memory by
// cp.async, two stages deep, so tile j+1 loads while tile j computes; the
// tiles are XOR-swizzled for conflict-free ldmatrix. S = Q.K^T on the
// tensor cores into f32 registers; scale, mask and the online softmax run
// on the accumulator fragments (a quad of lanes shares a row and reduces
// with shuffles); P is packed to bf16 in registers as the A operand of
// O += P.V (V through ldmatrix.trans), so it never touches shared memory.
// Only tiles that cross the diagonal or the ragged edge evaluate the mask;
// tiles above the diagonal are not loaded; a warp whose rows all lie above
// a diagonal tile skips it. Q-blocks are issued last-first: later rows see
// more keys.
#include "mma_common.cuh"

namespace dstorch {

using mma::bf16;

// Warps per block, 16 query rows each. At GPT-2 small's training shape on
// an H100 80GB HBM3 (700 W), chip_smoke.py's check_flash timed 4 warps at
// 0.0705 ms and 8 at 0.0831.
constexpr int kFwdWarps = 4;
constexpr int kFwdBQ = 16 * kFwdWarps, kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdBK = 64;  // keys per tile

// Q, then two stages of K and V tiles
template <int D>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(kFwdBQ + 4 * kFwdBK) * D * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int H, float scale,
                 int causal) {
  constexpr int BQ = kFwdBQ, BK = kFwdBK, NT = BK / 8, THREADS = kFwdThreads;
  extern __shared__ __align__(128) char smem[];
  // Q, then stage 0's K and V tiles, then stage 1's
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  auto k_tile = [=](int s) { return Qs + (BQ + 2 * BK * s) * D; };
  auto v_tile = [=](int s) { return Qs + (BQ + 2 * BK * s + BK) * D; };

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
  const int wr0 = r0 + 16 * warp;  // the warp's first query row

  auto load_kv = [&](int j, int s) {
    const int k0 = j * BK, n = min(BK, n_keys - k0);
    mma::load_tile<D, BK, THREADS>(k_tile(s), kb + k0 * stride, stride, n, tid);
    mma::load_tile<D, BK, THREADS>(v_tile(s), vb + k0 * stride, stride, n, tid);
  };
  mma::load_tile<D, BQ, THREADS>(Qs, q + q_off, stride, n_q, tid);
  mma::cp_async_commit();
  if (n_tiles > 0) {
    load_kv(0, 0);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
  } else {
    mma::cp_async_wait<0>();
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) mma::ldsm_a<D>(qf[kc], Qs, 16 * warp, kc, lane);

  float acc[D / 8][4];
  mma::zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * mma::kLog2e;

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
      float sc[NT][4];
      mma::zero(sc);
      mma::gemm_abt<D, NT>(sc, qf, k_tile(s), lane);
      if ((causal && k0 + BK - 1 > wr0) || k0 + BK > Tk) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const int row = wr0 + g + 8 * (e >> 1);
            if (key >= Tk || (causal && key > row)) sc[n][e] = -INFINITY;
          }
      }
      float alpha[2];
      mma::online_softmax<NT>(sc, m, l, alpha, scale_log2);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      mma::gemm_pb<D, NT>(acc, sc, v_tile(s), lane);
    }
    __syncthreads();  // stage s is free for tile j + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = mma::quad_sum(l[i]);
    const int row = wr0 + g + 8 * i;
    if (row >= Tq) continue;
    const float inv = li > 0.f ? 1.f / li : 0.f;
    bf16* orow = o + (((size_t)b * Tq + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (t == 0)
      lse[(size_t)bh * Tq + row] = li > 0.f ? m[i] * scale + logf(li) : -1e30f;
  }
}

template <int D>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                     int B, int Tq, int Tk, int H, float scale, int causal,
                     cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + kFwdBQ - 1) / kFwdBQ);
  flash_fwd_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      Tq, Tk, H, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_attributes(int* out) {
  return mma::kernel_attributes(flash_fwd_kernel<D>, kFwdThreads, fwd_smem_bytes<D>(), out);
}

// attributes of the forward kernel at head dim D (mma::kernel_attributes);
// read through dstorch_flash_kernel_attrs (flash_bwd.cu)
int flash_fwd_attributes(int D, int* out) { DSTORCH_MMA_DISPATCH_D(D, fwd_attributes, out) }

}  // namespace dstorch

// q [B, Tq, H, D], k/v [B, Tk, H, D] bf16 -> o [B, Tq, H, D] bf16, lse
// [B, H, Tq] f32. D in {16, 32, 64, 128}. Returns the cudaError_t of the
// launch (0 = success), -1 for an unsupported head dim.
extern "C" int dstorch_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int Tq, int Tk,
                                      int H, int D, float scale, int causal,
                                      void* stream) {
  if (B == 0 || Tq == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_MMA_DISPATCH_D(D, dstorch::launch_flash_fwd, q, k, v, o, lse, B, Tq, Tk, H, scale,
                         causal, st)
}
