// Block-sparse attention forward with log-sum-exp, bf16, sm_90a.
//
// Replaces deepspeed_tpu/ops/pallas/block_sparse_attention.py:96 _fwd_kernel
// (launched through _BSA._common, :249): q, k, v [B, H, S, D] -> o [B, H, S,
// D] and lse [B, H, S] f32, attention restricted to a static block layout.
// The caller (ops/kernels/block_sparse_attention.py) turns the layout into
// per-layout-head CSR tables over 64 x 64 tiles: row_ptr [Hl, nt + 1] and
// ent [nnz] = (k-tile, bits), bits holding the layout's own 16 x 16 pattern
// inside the tile (bit (row / 16) * 4 + key / 16). Head h reads table h %
// Hl. Under causal the pair (query i, key j) also needs j <= i (top-left,
// as :81-83). A pair outside the pattern is excluded, not weighted by
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
// Design: K1's forward (flash_fwd.cu) on the tensor cores (mma_common.cuh),
// its key loop driven by the tile list as block_sparse_bwd.cu's dq. Grid
// (B*H, 64-row q-tile), 4 warps; warp w owns query band w, its Q A
// fragments in registers. The block reads its q-tile's entries into
// shared memory and walks them, one barrier an entry; K and V tiles stream
// through a cp.async ring, and only the 16-key chunks that some band of
// the entry uses are copied (the documented layout lists every k-tile for
// its global key column, whose one chunk is all most bands read). The
// 16-block skip: warp w reads bits (bits >> 4w) & 0xF and computes only
// those chunks: S = Q.K^T on the tensor cores, then ONE online-softmax step
// over the tile's active chunks (a rescale per k-tile, not per chunk) on
// the accumulator fragments, then O += P.V with P packed to bf16 in
// registers and V through ldmatrix.trans. A warp with no bits in a tile
// skips its products and takes part in the barriers. BigBird's global
// rows leave one warp of their q-tile with 4 chunks an entry and the others
// idle; splitting such a band among the warps (partials merged in warp
// order) was tried on an H100 and dropped: it did not speed up layout C,
// whose steps cost their barrier and copy more than their chunks, and its
// registers spilled at D = 64 (PERF.md §6). The layout block is a
// multiple of 16 that divides S, so an active chunk lies inside S and
// inside the pattern: the only mask left is causal's, on the chunks that
// straddle the diagonal. Under causal the last q-tiles, whose lists are the
// longest, are issued first.
#include "mma_common.cuh"

namespace dstorch {

using mma::bf16;

constexpr int kBsfThreads = 128;  // 4 warps, a 16-row query band each
constexpr int kBsfTile = 64;      // q- and k-tiles of the tables

// A warp's work on an entry is often one 16 x 16 chunk, so the step's
// latency, not its arithmetic, sets the time: 4 resident blocks an SM at D =
// 64 (128 registers, 2 stages) beat 3 (155 registers, 4 stages) on an H100
// at phase 7's layout A, and a deeper ring alone did not help (PERF.md §6)
template <int D>
struct BsfCfg {
  static constexpr int stages = D == 128 ? 3 : 2;                       // of the K/V ring
  static constexpr int min_blocks = D == 128 ? 2 : D == 64 ? 4 : 5;     // resident an SM
  // Q, then the stages of K and V (then the q-tile's entries, sized at launch)
  static constexpr size_t bytes = (size_t)(1 + 2 * stages) * kBsfTile * D * sizeof(bf16);
};

// the 16-row chunks c of a [64][D] tile whose bit (chunks >> c) & 1 is set,
// rows at src + r * D, by cp.async
template <int D>
__device__ __forceinline__ void load_chunks(bf16* tile, const bf16* src, int chunks, int tid) {
  constexpr int C = D / 8, N = kBsfTile * C;  // 16-byte pieces, a multiple of 128
#pragma unroll
  for (int j = 0; j < N / kBsfThreads; ++j) {
    const int i = tid + j * kBsfThreads;
    const int r = i / C, c = i - (i / C) * C;
    if ((chunks >> (r >> 4)) & 1)
      mma::cp_async16(tile + mma::swz<D>(r, c), src + r * D + c * 8, true);
  }
}

// One entry's step for a warp: the chunks `chunks` (bit c = keys 16c..16c +
// 15 of the k-tile at k0) of the warp's 16 query rows starting at `row0`,
// whose A fragments are qf: S = Q.K^T, one online-softmax step over those
// chunks (mma::online_softmax restricted to them: one rescale a k-tile),
// then O += P.V.
template <int D>
__device__ __forceinline__ void bsf_step(float (&acc)[D / 8][4], float (&m)[2], float (&l)[2],
                                         const uint32_t (&qf)[D / 16][4], const bf16* kt,
                                         const bf16* vt, int chunks, int k0, int row0,
                                         bool causal, float scale_log2, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float sc[4][2][4];  // chunk, n8 tile, element
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!((chunks >> c) & 1)) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[c][n][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t b[4];
      mma::ldsm_b<D>(b, kt, 16 * c, kc, lane);
      mma::mma16816(sc[c][0], qf[kc], b[0], b[1]);
      mma::mma16816(sc[c][1], qf[kc], b[2], b[3]);
    }
    const bool diag = causal && k0 + 16 * c == row0;  // straddles the diagonal
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (diag && 8 * n + 2 * t + (i & 1) > g + 8 * (i >> 1)) sc[c][n][i] = -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[c][n][i]);
      }
  }
  float mb[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = mma::quad_max(mx[i]);
    mb[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;
    alpha[i] = mma::exp2_approx(m[i] * scale_log2 - mb[i]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!((chunks >> c) & 1)) continue;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[c][n][i] = mma::exp2_approx(fmaf(sc[c][n][i], scale_log2, -mb[i >> 1]));
        sum[i >> 1] += sc[c][n][i];
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l[i] * alpha[i] + sum[i];
    m[i] = mx[i];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!((chunks >> c) & 1)) continue;
    uint32_t a[4];
    mma::acc_to_a<2>(a, sc[c], 0);
#pragma unroll
    for (int nc = 0; nc < D / 16; ++nc) {
      uint32_t b[4];
      mma::ldsm_bt<D>(b, vt, 16 * c, nc, lane);
      mma::mma16816(acc[2 * nc], a, b[0], b[1]);
      mma::mma16816(acc[2 * nc + 1], a, b[2], b[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBsfThreads, BsfCfg<D>::min_blocks)
block_sparse_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, const int* __restrict__ row_ptr,
                        const int2* __restrict__ ent, int H, int S, int Hl,
                        float scale, int causal) {
  constexpr int T = kBsfTile, KC = D / 16, NS = BsfCfg<D>::stages;
  extern __shared__ __align__(128) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  auto k_tile = [=](int s) { return Qs + (T + 2 * T * s) * D; };
  auto v_tile = [=](int s) { return k_tile(s) + T * D; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, h = bh % H;
  const int nt = (S + T - 1) / T;
  const int it = causal ? nt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int r0 = it * T, n_q = min(T, S - r0);
  const size_t base = (size_t)bh * S * D;
  const int* tp = row_ptr + (size_t)(h % Hl) * (nt + 1);
  const int e0 = tp[it], n_ent = tp[it + 1] - e0;
  // the q-tile's entries, read once (every step reads one, and one ahead)
  int2* ents = reinterpret_cast<int2*>(smem + BsfCfg<D>::bytes);
  for (int i = tid; i < n_ent; i += kBsfThreads) ents[i] = ent[e0 + i];
  mma::load_tile<D, T, kBsfThreads>(Qs, q + base + (size_t)r0 * D, D, n_q, tid);
  __syncthreads();

  const float scale_log2 = scale * mma::kLog2e;
  auto load_kv = [&](int e, int s) {
    const int2 en = ents[e];
    const int b = en.y, used = (b | (b >> 4) | (b >> 8) | (b >> 12)) & 0xF;
    const size_t off = base + (size_t)en.x * T * D;
    load_chunks<D>(k_tile(s), k + off, used, tid);
    load_chunks<D>(v_tile(s), v + off, used, tid);
  };
  // one commit group an entry (empty past the last): NS - 1 in flight
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_ent) load_kv(j, j);
    mma::cp_async_commit();
  }
  float acc[D / 8][4];
  mma::zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[KC][4];
  for (int e = 0; e < n_ent; ++e) {
    const int s = e % NS;
    const int2 en = ents[e];
    mma::cp_async_wait<NS - 2>();  // entry e (and Q, with the first) has landed
    __syncthreads();               // ... for every thread; entry e - 1's stage is free
    if (e + NS - 1 < n_ent) load_kv(e + NS - 1, (e + NS - 1) % NS);
    mma::cp_async_commit();
    if (e == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) mma::ldsm_a<D>(qf[kc], Qs, 16 * warp, kc, lane);
    }
    const int chunks = (en.y >> (4 * warp)) & 0xF;  // the warp's active key chunks
    if (chunks != 0)
      bsf_step<D>(acc, m, l, qf, k_tile(s), v_tile(s), chunks, en.x * T, r0 + 16 * warp,
                  causal, scale_log2, lane);
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = mma::quad_sum(l[i]);
    const int row = r0 + 16 * warp + g + 8 * i;
    if (row >= S) continue;
    const float inv = li > 0.f ? 1.f / li : 0.f;
    bf16* orow = o + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (t == 0) lse[(size_t)bh * S + row] = li > 0.f ? m[i] * scale + logf(li) : -1e30f;
  }
}

template <int D>
int launch_block_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, const void* row_ptr, const void* ent, int B,
                            int H, int S, int Hl, float scale, int causal,
                            cudaStream_t stream) {
  const int nt = (S + kBsfTile - 1) / kBsfTile;  // a q-tile lists at most nt entries
  const size_t smem = BsfCfg<D>::bytes + nt * sizeof(int2);
  cudaError_t err = cudaFuncSetAttribute(
      block_sparse_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, nt);
  block_sparse_fwd_kernel<D><<<grid, kBsfThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(row_ptr), static_cast<const int2*>(ent), H, S, Hl, scale,
      causal);
  return (int)cudaGetLastError();
}

// at S = 4096 (64 entries at most)
template <int D>
int bsf_attributes(int* out) {
  return mma::kernel_attributes(block_sparse_fwd_kernel<D>, kBsfThreads,
                                BsfCfg<D>::bytes + 64 * sizeof(int2), out);
}

}  // namespace dstorch

// q, k, v [B, H, S, D] bf16 -> o [B, H, S, D] bf16, lse [B, H, S] f32;
// row_ptr [Hl, nt + 1] and ent [nnz, 2] int32 (nt = ceil(S / 64)). D in
// {16, 32, 64, 128}; S a multiple of 16 (the layout block, a multiple of
// 16, divides it). Returns the launch's cudaError_t (0 = success), -1 for
// an unsupported head dim or S.
extern "C" int dstorch_block_sparse_fwd_bf16(const void* q, const void* k, const void* v,
                                             void* o, void* lse, const void* row_ptr,
                                             const void* ent, int B, int H, int S, int D,
                                             int Hl, float scale, int causal,
                                             void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (S % 16 != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_MMA_DISPATCH_D(D, dstorch::launch_block_sparse_fwd, q, k, v, o, lse, row_ptr, ent,
                         B, H, S, Hl, scale, causal, st)
}

// K9's forward kernel as compiled at head dim D; out [6] int32 as
// dstorch_flash_kernel_attrs gives them. Returns a cudaError_t, -1 for an
// unknown head dim.
extern "C" int dstorch_block_sparse_fwd_attrs(int D, void* out) {
  int* o = static_cast<int*>(out);
  DSTORCH_MMA_DISPATCH_D(D, dstorch::bsf_attributes, o)
}
