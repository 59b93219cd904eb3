// Evoformer pair-bias attention forward with log-sum-exp, bf16, sm_90a.
//
// Replaces deepspeed_tpu/ops/pallas/evoformer_attention.py:70 _fwd_kernel
// (launched by _fwd, :105): for every row l of L = G * R rows and head h,
//   o[l, :, h] = softmax((q k^T) * scale + mask[l] + pair[l / R, h]) v
// and lse [L, H, S] f32, the row's log-sum-exp of those scores (m + log l,
// natural log). Layouts, score order and fully masked rows:
// evoformer_common.cuh. p is rounded to bf16 before the product with V, as
// the Pallas kernel casts it (:94); the row sum l adds the unrounded f32 p.
//
// Bound on the H100 at AlphaFold 2's MSA row attention (L = 512 rows, S =
// 384, H = 8, D = 32, one pair bias shared by all rows; 604 M (query, key)
// pairs): q, k, v and o are 100.7 MB each, so reading and writing each once
// moves 412 MB with the pair bias, mask and lse: 0.123 ms at 3.35 TB/s,
// against 4*D flops a pair, 77 GFLOP = 0.078 ms at 989 TFLOP/s. Bytes bound
// it.
//
// Design: the dq kernel's walk (evoformer_bwd.cu) with one online-softmax
// step a k-tile, on the tensor cores (mma_common.cuh). Grid (l, 64-row
// q-tile, h) with l fastest, so the blocks that run together are one
// (q-tile, h) across many rows: they read the same strip of the pair bias
// (2.4 MB in all at the MSA shape) while it sits in the 50 MB L2. 4 warps a
// block, each owning 16 query rows: Q stays resident (its A fragments in
// registers at D <= 64, read through ldmatrix at D = 128); K, V, the 64 x
// 64 pair-bias tile and the keys' mask values stream through a 2-stage
// cp.async ring (zero-filled past S), one barrier a tile. S = Q.K^T on
// mma.sync m16n8k16, the biases added on the accumulator fragments in
// evo_score's order, online softmax on the fragments (s - m formed before
// log2(e) is applied), P packed from the accumulators into A fragments (the
// bf16 cast) and O += P.V with V read by ldmatrix.trans. Keys past S get p
// = 0 by index; the running max starts at -1e30 (the Pallas kernel's
// NEG_INF), so a key scored -inf gives p = 0, not NaN. The epilogue divides
// by l (safe_l, :100), stages each warp's 16 rows of o in its own rows of
// the Q tile and stores 16-byte rows; lse goes to [L, H, S].
#include "evoformer_common.cuh"

namespace dstorch {

constexpr float kEvoMaxInit = -1e30f;  // the running max's start (Pallas NEG_INF)

template <int D, typename PT>
struct EvoFwdCfg {
  static constexpr int stages = 2;
  static constexpr int PP = 72;  // pair tile pitch, as dq's
  static constexpr size_t tile = (size_t)kEvoTile * D * sizeof(bf16);
  static constexpr size_t pair = (size_t)kEvoTile * PP * sizeof(PT);
  // a stage: K, V, the pair-bias tile, the keys' mask values
  static constexpr size_t stage = 2 * tile + pair + kEvoTile * sizeof(float);
  // Q (then o), the stages
  static constexpr size_t bytes = tile + stages * stage;
};

template <int D, typename PT>
__global__ void __launch_bounds__(kEvoThreads)
evoformer_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ mask,
                     const PT* __restrict__ pair, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int R, float scale) {
  using Cfg = EvoFwdCfg<D, PT>;
  constexpr int T = kEvoTile, NT = T / 8, PP = Cfg::PP, NS = Cfg::stages;
  extern __shared__ __align__(128) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  char* ring = smem + Cfg::tile;
  auto k_tile = [=](int s) { return reinterpret_cast<bf16*>(ring + s * Cfg::stage); };
  auto v_tile = [=](int s) { return k_tile(s) + T * D; };
  auto p_tile = [=](int s) {
    return reinterpret_cast<PT*>(ring + s * Cfg::stage + 2 * Cfg::tile);
  };
  auto m_vec = [=](int s) {
    return reinterpret_cast<float*>(ring + s * Cfg::stage + 2 * Cfg::tile + Cfg::pair);
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int l = blockIdx.x, h = blockIdx.z;
  const int r0 = blockIdx.y * T, n_q = min(T, S - r0);
  const int n_tiles = (S + T - 1) / T;
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)l * S * H + h) * D;
  const PT* pb = pair + ((size_t)(l / R) * H + h) * S * S + (size_t)r0 * S;
  const float* mrow = mask == nullptr ? nullptr : mask + (size_t)l * S;
  const int pair_bytes = pair_copy_bytes(pair, S);

  auto load_kv = [&](int j, int s) {
    const int k0 = j * T, n = min(T, S - k0);
    mma::load_tile<D, T, kEvoThreads>(k_tile(s), k + base + k0 * rs, rs, n, tid);
    mma::load_tile<D, T, kEvoThreads>(v_tile(s), v + base + k0 * rs, rs, n, tid);
    load_pair<PT, T, PP>(p_tile(s), pb + k0, S, n_q, n, pair_bytes, tid);
    if (mrow != nullptr) mma::load_vec<T, kEvoThreads>(m_vec(s), mrow + k0, n, tid);
  };
  mma::load_tile<D, T, kEvoThreads>(Qs, q + base + r0 * rs, rs, n_q, tid);
  // one commit group a tile (empty past the last), Q in the first
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_tiles) load_kv(j, j);
    mma::cp_async_commit();
  }
  const int wq = 16 * warp;
  float acc[D / 8][4];
  mma::zero(acc);
  // the thread's rows g (i = 0) and g + 8 (i = 1): running max, and its
  // share of the running sum (added over the quad at the end)
  float m[2] = {kEvoMaxInit, kEvoMaxInit}, lsum[2] = {0.f, 0.f};
  uint32_t qf[D / 16][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS, k0 = j * T;
    mma::cp_async_wait<NS - 2>();  // tile j has landed
    __syncthreads();               // ... for every thread; tile j - 1's stage is free
    if (j + NS - 1 < n_tiles) load_kv(j + NS - 1, (j + NS - 1) % NS);
    mma::cp_async_commit();
    if constexpr (D <= 64) {
      if (j == 0) evo_frags<D>(qf, Qs, wq, lane);
    }
    float sc[NT][4];
    evo_abt<D, NT>(sc, qf, Qs, wq, k_tile(s), lane);  // S
    const PT* pt = p_tile(s);
    const float* mv = m_vec(s);
    const bool edge = k0 + T > S;
    float mx[2] = {kEvoMaxInit, kEvoMaxInit};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int kl = 8 * n + 2 * t;
      const float2 mk = mrow != nullptr ? *reinterpret_cast<const float2*>(mv + kl)
                                        : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 pr = to_f32x2(pt + (wq + g + 8 * i) * PP + kl);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = evo_score(sc[n][2 * i + e], scale, e ? mk.y : mk.x, e ? pr.y : pr.x);
          if (edge && k0 + kl + e >= S) x = kEvoMaxInit;
          sc[n][2 * i + e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], mma::quad_max(mx[i]));
      const float alpha = mma::exp2_approx(__fsub_rn(m[i], m_new) * mma::kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          float p = mma::exp2_approx(__fsub_rn(sc[n][e], m_new) * mma::kLog2e);
          if (edge && k0 + 8 * n + 2 * t + (e & 1) >= S) p = 0.f;
          sc[n][e] = p;
          sum += p;
        }
      lsum[i] = lsum[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }
    mma::gemm_pb<D, NT>(acc, sc, v_tile(s), lane);  // O += P.V
  }
  mma::cp_async_wait<0>();

  // with finite biases every row has l >= 1; the guard is the Pallas
  // kernel's safe_l (:100), which only a -inf bias on every key reaches
  float safe_l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_row = mma::quad_sum(lsum[i]);
    safe_l[i] = l_row > 0.f ? l_row : 1.f;
    const int row = r0 + wq + g + 8 * i;
    if (t == 0 && row < S) lse[((size_t)l * H + h) * S + row] = m[i] + logf(safe_l[i]);
  }
  // the warp's 16 rows of o into its own rows of the Q tile (no other warp
  // reads them), then 16-byte rows out
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<__nv_bfloat162*>(Qs + mma::swz<D>(wq + g + 8 * i, n) + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] / safe_l[i], acc[n][2 * i + 1] / safe_l[i]);
  __syncwarp();
  constexpr int C = D / 8;
#pragma unroll
  for (int idx = lane; idx < 16 * C; idx += 32) {
    const int r = idx / C, c = idx - r * C, row = r0 + wq + r;
    if (row < S)
      *reinterpret_cast<uint4*>(o + base + (size_t)row * rs + 8 * c) =
          *reinterpret_cast<const uint4*>(Qs + mma::swz<D>(wq + r, c));
  }
}

template <int D, typename PT>
int launch_evoformer_fwd(const void* q, const void* k, const void* v, const void* mask,
                         const void* pair, void* o, void* lse, int L, int S, int H, int R,
                         float scale, cudaStream_t stream) {
  const size_t smem = EvoFwdCfg<D, PT>::bytes;
  cudaError_t err = cudaFuncSetAttribute(evoformer_fwd_kernel<D, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L, (S + kEvoTile - 1) / kEvoTile, H);
  evoformer_fwd_kernel<D, PT><<<grid, kEvoThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(mask),
      static_cast<const PT*>(pair), static_cast<bf16*>(o), static_cast<float*>(lse), S, H,
      R, scale);
  return (int)cudaGetLastError();
}

template <int D, typename PT>
int evo_fwd_attributes(int* out) {
  return mma::kernel_attributes(evoformer_fwd_kernel<D, PT>, kEvoThreads,
                                EvoFwdCfg<D, PT>::bytes, out);
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

// evoformer_fwd_kernel as compiled at head dim D with an f32 (pair_f32) or
// bf16 pair bias: out [6] int32 as dstorch_flash_kernel_attrs gives them.
// Returns a cudaError_t, -1 for an unsupported head dim.
extern "C" int dstorch_evoformer_fwd_attrs(int D, int pair_f32, void* out) {
  int* o = static_cast<int*>(out);
  if (pair_f32) {
    DSTORCH_K10_DISPATCH(D, float, dstorch::evo_fwd_attributes, o)
  }
  DSTORCH_K10_DISPATCH(D, dstorch::bf16, dstorch::evo_fwd_attributes, o)
}
