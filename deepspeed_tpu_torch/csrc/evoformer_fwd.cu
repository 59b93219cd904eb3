// Evoformer pair-bias attention forward with log-sum-exp, bf16, sm_90a.
//
// Replaces deepspeed_tpu/ops/pallas/evoformer_attention.py:70 _fwd_kernel
// (launched by _fwd, :105): for every row l of L = G * R rows and head h,
//   o[l, :, h] = softmax((q k^T) * scale + mask[l] + pair[l / R, h]) v
// and lse [L, H, S] f32, the row's log-sum-exp of those scores (m + log l).
// Layouts, score order and fully masked rows: evoformer_common.cuh. p is
// rounded to bf16 before the product with V, as the Pallas kernel casts it
// (:94); the row sum l adds the unrounded p.
//
// Bound on the H100 at AlphaFold 2's MSA row attention (L = 512 rows, S =
// 384, H = 8, D = 32, one pair bias shared by all rows; 604 M (query, key)
// pairs): q, k, v and o are 100.7 MB each, so reading and writing each once
// moves 412 MB with the pair bias, mask and lse: 0.123 ms at 3.35 TB/s,
// against 4*D flops a pair, 77 GFLOP = 0.078 ms at 989 TFLOP/s. Bytes bound
// it.
//
// Design: K9's forward (block_sparse_fwd.cu) over every k-tile, with the
// two biases added to the score tile: grid (l, 64-row q-tile, h) with l
// fastest, 256 threads. Q, K and V are staged from the caller's [L, S, H,
// D] layout directly (row stride H * D; no transposed copies), 64 x 64
// tiles with f32 FMAs on CUDA cores and online softmax in a half-warp per
// row; the tensor cores stay idle. Each thread reads its 16 pair-bias
// entries straight from device memory (a half-warp reads 16 neighbouring
// keys of one row). l is the grid's fastest index, so the blocks that run
// together are one (q-tile, h) across many rows: they read the same strip
// of the pair bias (all of it is 2.4 MB at the MSA shape) while it sits in
// the 50 MB L2, and one head's K and V for every row (24.5 MB there) stay
// in L2 for the next q-tile. Any S is taken: the last tile's ragged edge
// is masked.
#include "evoformer_common.cuh"

namespace dstorch {

template <int D>
struct EvoFwdSmem {
  using T = BwdSmem<D>;
  // Q, K, V tiles + the f32 P tile
  static constexpr size_t bytes = 3 * T::tile_bytes + T::f32_tile_bytes;
};

template <int D, typename PT>
__global__ void __launch_bounds__(kTileThreads)
evoformer_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ mask,
                     const PT* __restrict__ pair, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int R, float scale) {
  using Sm = BwdSmem<D>;
  constexpr int ND = D / 16;
  extern __shared__ __align__(16) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Sm::tile_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * Sm::tile_bytes);
  float* Ps = reinterpret_cast<float*>(smem + 3 * Sm::tile_bytes);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int l = blockIdx.x, h = blockIdx.z;
  const int r0 = blockIdx.y * kBQ, n_q = min(kBQ, S - r0);
  const size_t rs = (size_t)H * D;                    // position stride
  const size_t base = ((size_t)l * S * H + h) * D;    // row (l, 0, h)
  const PT* pb = pair + ((size_t)(l / R) * H + h) * S * S + (size_t)r0 * S;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)l * S;

  stage_rows<D>(Qs, q + base + r0 * rs, rs, n_q);
  float acc[4][ND], m[4], lsum[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegBig;
    lsum[r] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[r][n] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBK) {
    const int n_k = min(kBK, S - k0);
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(Ks, k + base + k0 * rs, rs, n_k);
    stage_rows<D>(Vs, v + base + k0 * rs, rs, n_k);
    float mk[4];
    load_key_mask(mrow, k0, n_k, mk);
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
        ok[c] = row < n_q && key < n_k;
        s[r][c] = ok[c] ? evo_score(s[r][c], scale, mk[c],
                                    to_f32(pb[(size_t)row * S + k0 + key]))
                        : kNegBig;
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
      lsum[r] = lsum[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) acc[r][n] *= alpha;
    }
    __syncthreads();  // P complete
    tile_accumulate<D>(Ps, Vs, acc);
  }

  // with finite biases every row has lsum >= 1; the guard is the Pallas
  // kernel's safe_l (:100), which only a -inf bias on every key reaches
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= n_q) continue;
    const float safe_l = lsum[r] > 0.f ? lsum[r] : 1.f;
    bf16* dst = o + base + (size_t)(r0 + row) * rs;
#pragma unroll
    for (int n = 0; n < ND; ++n) dst[tx + 16 * n] = __float2bfloat16(acc[r][n] / safe_l);
    if (tx == 0) lse[((size_t)l * H + h) * S + r0 + row] = m[r] + logf(safe_l);
  }
}

template <int D, typename PT>
int launch_evoformer_fwd(const void* q, const void* k, const void* v, const void* mask,
                         const void* pair, void* o, void* lse, int L, int S, int H, int R,
                         float scale, cudaStream_t stream) {
  const size_t smem = EvoFwdSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(evoformer_fwd_kernel<D, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L, (S + kBQ - 1) / kBQ, H);
  evoformer_fwd_kernel<D, PT><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(mask),
      static_cast<const PT*>(pair), static_cast<bf16*>(o), static_cast<float*>(lse), S, H,
      R, scale);
  return (int)cudaGetLastError();
}

}  // namespace dstorch

// q, k, v [L, S, H, D] bf16; mask [L, S] f32 or null; pair [L / R, H, S, S]
// (f32 when pair_f32, else bf16) -> o [L, S, H, D] bf16, lse [L, H, S] f32.
// D in {16, 32, 64, 128}. Returns the launch's cudaError_t (0 = success),
// -1 for an unsupported head dim.
extern "C" int dstorch_evoformer_fwd_bf16(const void* q, const void* k, const void* v,
                                          const void* mask, const void* pair, void* o,
                                          void* lse, int L, int S, int H, int D, int R,
                                          float scale, int pair_f32, void* stream) {
  if (L == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pair_f32) {
    DSTORCH_K10_DISPATCH(D, float, dstorch::launch_evoformer_fwd, q, k, v, mask, pair, o,
                         lse, L, S, H, R, scale, st)
  }
  DSTORCH_K10_DISPATCH(D, dstorch::bf16, dstorch::launch_evoformer_fwd, q, k, v, mask, pair,
                       o, lse, L, S, H, R, scale, st)
}
