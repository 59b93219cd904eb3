// Block-sparse attention forward with log-sum-exp, bf16, sm_90a.
//
// Replaces deepspeed_tpu/ops/pallas/block_sparse_attention.py:96 _fwd_kernel
// (launched through _BSA._common, :249): q, k, v [B, H, S, D] -> o [B, H, S,
// D] and lse [B, H, S] f32, attention restricted to a static block layout.
// The caller (ops/kernels/block_sparse_attention.py) turns the layout into
// per-layout-head CSR tables over 64 x 64 tiles: row_ptr [Hl, nt + 1] and
// ent [nnz] = (k-tile, bits), bits holding the layout's own 16 x 16 pattern
// inside the tile (tile_common.cuh's fine_bit). Head h reads table h % Hl.
// Under causal the pair (query i, key j) also needs j <= i (top-left, as
// :81-83). A pair outside the pattern is excluded, not weighted by
// exp(-1e9): a row that sees no key gets o = 0 and lse = -1e30 (_safe_exp,
// :88). p is rounded to bf16 before the product with V, as the Pallas kernel
// casts it (:120); the row sum l adds the unrounded p.
//
// Bound on the H100 at BERT-large's attention geometry (B = 2, H = 16, S =
// 4096, D = 64) under DeepSpeed's documented fixed layout (26.2% of 16 x 16
// blocks active, 141 M visible pairs): 4*D flops a pair, 36 GFLOP = 36 us at
// 989 TFLOP/s, against q, k, v, o and lse read or written once, 68 MB = 20
// us. So operations bound it.
//
// Design: grid (B*H, 64-row q-tile), 256 threads. Each block walks its
// q-tile's list of active k-tiles, staging K and V in shared memory (padded
// rows, tile_common.cuh), with f32 FMAs on CUDA cores and online softmax in
// a half-warp per row, as K1's forward. A tile is computed whole: where the
// layout's 16-blocks are sparse inside it (the documented layout makes every
// 64-tile active), the kernel does up to 4x the useful work, and the tensor
// cores stay idle. Any S that the layout block divides is taken: the last
// tile's ragged edge is masked.
#include "tile_common.cuh"

namespace dstorch {

template <int D>
struct BsaFwdSmem {
  using T = BwdSmem<D>;
  // Q, K, V tiles + the f32 P tile
  static constexpr size_t bytes = 3 * T::tile_bytes + T::f32_tile_bytes;
};

template <int D>
__global__ void __launch_bounds__(kTileThreads)
block_sparse_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, const int* __restrict__ row_ptr,
                        const int2* __restrict__ ent, int H, int S, int Hl,
                        float scale, int causal) {
  using Sm = BwdSmem<D>;
  constexpr int ND = D / 16;
  extern __shared__ __align__(16) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Sm::tile_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * Sm::tile_bytes);
  float* Ps = reinterpret_cast<float*>(smem + 3 * Sm::tile_bytes);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, h = bh % H;
  const int nt = (S + kBQ - 1) / kBQ;
  const int it = blockIdx.y;
  const int r0 = it * kBQ, n_q = min(kBQ, S - r0);
  const size_t base = (size_t)bh * S * D;
  const int* tp = row_ptr + (size_t)(h % Hl) * (nt + 1);
  const int e0 = tp[it], e1 = tp[it + 1];

  stage_rows<D>(Qs, q + base + (size_t)r0 * D, D, n_q);
  float acc[4][ND], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[r][n] = 0.f;
  }

  for (int e = e0; e < e1; ++e) {
    const int2 en = ent[e];
    const int k0 = en.x * kBK, n_k = min(kBK, S - k0);
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(Ks, k + base + (size_t)k0 * D, D, n_k);
    stage_rows<D>(Vs, v + base + (size_t)k0 * D, D, n_k);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(Qs, Ks, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      bool ok[4];
      float mx = kNegBig;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = tx + 16 * c;
        ok[c] = row < n_q && key < n_k && fine_bit(en.y, row, key) &&
                (!causal || k0 + key <= r0 + row);
        s[r][c] = ok[c] ? s[r][c] * scale : kNegBig;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = __expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? __expf(s[r][c] - m_new) : 0.f;
        Ps[row * Sm::PS + tx + 16 * c] = round_bf16(p);
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[r][n] *= alpha;
    }
    __syncthreads();  // P complete
    tile_accumulate<D>(Ps, Vs, acc);
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= n_q) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* dst = o + base + (size_t)(r0 + row) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) dst[tx + 16 * n] = __float2bfloat16(acc[r][n] * inv);
    if (tx == 0) lse[(size_t)bh * S + r0 + row] = l[r] > 0.f ? m[r] + logf(l[r]) : kNegBig;
  }
}

template <int D>
int launch_block_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, const void* row_ptr, const void* ent, int B,
                            int H, int S, int Hl, float scale, int causal,
                            cudaStream_t stream) {
  const size_t smem = BsaFwdSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_sparse_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  block_sparse_fwd_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(row_ptr), static_cast<const int2*>(ent), H, S, Hl, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace dstorch

// q, k, v [B, H, S, D] bf16 -> o [B, H, S, D] bf16, lse [B, H, S] f32;
// row_ptr [Hl, nt + 1] and ent [nnz, 2] int32 (nt = ceil(S / 64)). D in
// {16, 32, 64, 128}. Returns the launch's cudaError_t (0 = success), -1 for
// an unsupported head dim.
extern "C" int dstorch_block_sparse_fwd_bf16(const void* q, const void* k, const void* v,
                                             void* o, void* lse, const void* row_ptr,
                                             const void* ent, int B, int H, int S, int D,
                                             int Hl, float scale, int causal,
                                             void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return dstorch::launch_block_sparse_fwd<16>(q, k, v, o, lse, row_ptr, ent, B, H, S, Hl, scale, causal, st);
    case 32: return dstorch::launch_block_sparse_fwd<32>(q, k, v, o, lse, row_ptr, ent, B, H, S, Hl, scale, causal, st);
    case 64: return dstorch::launch_block_sparse_fwd<64>(q, k, v, o, lse, row_ptr, ent, B, H, S, Hl, scale, causal, st);
    case 128: return dstorch::launch_block_sparse_fwd<128>(q, k, v, o, lse, row_ptr, ent, B, H, S, Hl, scale, causal, st);
    default: return -1;
  }
}
