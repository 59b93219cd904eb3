// Evoformer pair-bias attention backward, bf16, sm_90a: three kernels.
//
// Replace deepspeed_tpu/ops/pallas/evoformer_attention.py:155
// _bwd_dq_kernel, :184 _bwd_dkv_kernel and :219 _bwd_dbias_kernel
// (launched by _bwd, :248). Inputs q, k, v, dO [L, S, H, D] bf16, the mask
// bias [L, S] f32 (or none), the pair bias [G, H, S, S] (bf16 or f32, PT),
// lse and delta = rowsum(dO * O) [L, H, S] f32 (delta from the caller, as
// the JAX package computes it outside Pallas, :256). The probabilities are
// recomputed from the saved lse with the forward's score order
// (evoformer_common.cuh's evo_score on the f32 product), never from a new
// max and sum:
//   p = exp(s - lse),  dp = dO . v,  ds = p * (dp - delta) * scale
//   dq = sum_k ds k                 (evoformer_dq: block per (l, q-tile, h))
//   dv = sum_q p dO, dk = sum_q ds q (evoformer_dkv: block per (l, k-tile,
//                                     h); it owns its keys: no atomics)
//   dpair[g] = sum_{r < R} p * (dp - delta)   (evoformer_dbias, below)
// p and ds are rounded to bf16 before their products, as the Pallas
// kernels cast them (:175, :203, :209). s - lse is formed before log2(e)
// is applied (exp2): with a -1e9 mask the f32 spacing is 64, and a fully
// masked row's s and lse are equal only when subtracted first. Keys past S
// on a ragged edge get p = 0 by index.
//
// Bounds on the H100 at AlphaFold 2's MSA row attention (L = 512, S = 384,
// H = 8, D = 32, R = 512, 604 M pairs; each [L, S, H, D] bf16 tensor 100.7
// MB): dq reads q, k, v, dO and writes dq, 6*D flops a pair: 0.155 ms by
// bytes against 0.117 ms by operations; dk/dv reads four tensors and writes
// two, 8*D flops: 0.185 against 0.156 ms; d(pair) reads four, 4*D flops:
// 0.126 against 0.078 ms. Bytes bound all three.
//
// Design: K1's backward (flash_bwd.cu) on the tensor cores (mma_common.cuh)
// with the two biases added to each recomputed score. 4 warps a block, each
// warp owning 16 rows of every product, f32 accumulators in registers,
// operands through ldmatrix (.trans for those stored [k][n]), streamed
// tiles through cp.async rings (zero-filled past S).
// - dq: grid (l, q-tile, h), l fastest, so one (q-tile, h)'s pair-bias
//   strip serves many rows from L2. Q and dO stay resident (their A
//   fragments in registers at D <= 64); K, V, the 64 x 64 pair-bias tile
//   and the keys' mask values stream through a 2-stage ring, one barrier a
//   tile. S = Q.K^T and dP = dO.V^T on the tensor cores, ds on the
//   fragments, dQ += dS.K with dS packed from registers.
// - dk/dv: grid (l, k-tile, h). K and V stay resident; Q, dO, lse, delta
//   and the pair-bias tile stream through a 3-stage ring, in steps of BQ
//   queries (16 at D = 128, 32 at D = 32, 64 otherwise, as K1's dk/dv).
//   S^T = K.Q^T, dV += P^T.dO, dP^T = V.dO^T, dK += dS^T.Q. The fragments
//   need the pair bias transposed (a key row, a query column): the tile is
//   copied along the bias's own rows and read transposed from shared
//   memory, with a row pitch (72 bf16, 68 f32) that puts a warp's reads on
//   distinct banks.
// - d(pair): grid (k-tile, q-tile, (g * H + h) * C + chunk). A block loops
//   over one of C contiguous chunks of the group's R rows, in order, with
//   its 16 x 64 f32 sum and its pair-bias values (two a register in bf16)
//   in registers in fragment layout; each row's Q, dO, K, V, lse, delta and
//   mask values stream through a 3-stage ring (one barrier a row; row r + 2
//   loads while row r computes). S and dP come from the tensor cores, and
//   the sum adds p * (dp - delta) in f32 (no bf16 rounding, no scale: the
//   bias enters after the scaling). C (the caller's,
//   evoformer_attention.dbias_chunks) fills the card: one (k-tile, q-tile,
//   g, h) block a row group leaves 288 blocks at the MSA shape. Each chunk
//   writes its f32 partial, and evoformer_dbias_sum_kernel adds the
//   partials in chunk order and writes the sum once in the pair bias's
//   type. No atomics: dq, dk, dv and d(pair) are the same bits from run to
//   run.
#include "evoformer_common.cuh"

namespace dstorch {

// p = exp(s - lse) with s - lse formed first
__device__ __forceinline__ float evo_prob(float score, float lse) {
  return mma::exp2_approx(__fsub_rn(score, lse) * mma::kLog2e);
}

// ---- dq ------------------------------------------------------------------ //

template <int D, typename PT>
struct EvoDqCfg {
  // a 2-stage ring: a third stage costs dq a resident block an SM and ran
  // slower on an H100 at the MSA row shape (PERF.md §6)
  static constexpr int stages = 2;
  static constexpr int PP = 72;  // pair tile pitch: a warp's bf16x2 / float2 reads hit
                                 // distinct banks
  static constexpr size_t tile = (size_t)kEvoTile * D * sizeof(bf16);
  static constexpr size_t pair = (size_t)kEvoTile * PP * sizeof(PT);
  // a stage: K, V, the pair-bias tile, the keys' mask values
  static constexpr size_t stage = 2 * tile + pair + kEvoTile * sizeof(float);
  // Q, dO, the stages
  static constexpr size_t bytes = 2 * tile + stages * stage;
};

template <int D, typename PT>
__global__ void __launch_bounds__(kEvoThreads)
evoformer_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ mask, const PT* __restrict__ pair,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int S, int H, int R, float scale) {
  using Cfg = EvoDqCfg<D, PT>;
  constexpr int T = kEvoTile, NT = T / 8, PP = Cfg::PP, NS = Cfg::stages;
  extern __shared__ __align__(128) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + T * D;
  char* ring = smem + 2 * Cfg::tile;
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
  mma::load_tile<D, T, kEvoThreads>(dOs, dout + base + r0 * rs, rs, n_q, tid);
  // one commit group a tile (empty past the last), Q and dO in the first
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_tiles) load_kv(j, j);
    mma::cp_async_commit();
  }
  // the thread's rows g and g + 8
  const int wq = 16 * warp;
  float lse_r[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wq + g + 8 * i;
    const size_t at = ((size_t)l * H + h) * S + row;
    lse_r[i] = row < S ? lse[at] : 0.f;
    dlt[i] = row < S ? delta[at] : 0.f;
  }
  float acc[D / 8][4];
  mma::zero(acc);
  uint32_t qf[D / 16][4], df[D / 16][4];

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS, k0 = j * T;
    mma::cp_async_wait<NS - 2>();  // tile j has landed
    __syncthreads();               // ... for every thread; tile j - 1's stage is free
    if (j + NS - 1 < n_tiles) load_kv(j + NS - 1, (j + NS - 1) % NS);
    mma::cp_async_commit();
    if constexpr (D <= 64) {
      if (j == 0) {
        evo_frags<D>(qf, Qs, wq, lane);
        evo_frags<D>(df, dOs, wq, lane);
      }
    }
    float sc[NT][4], dp[NT][4];
    evo_abt<D, NT>(sc, qf, Qs, wq, k_tile(s), lane);   // S
    evo_abt<D, NT>(dp, df, dOs, wq, v_tile(s), lane);  // dP
    const PT* pt = p_tile(s);
    const float* mv = m_vec(s);
    const bool edge = k0 + T > S;
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
          float p = evo_prob(evo_score(sc[n][2 * i + e], scale, e ? mk.y : mk.x,
                                       e ? pr.y : pr.x),
                             lse_r[i]);
          if (edge && k0 + kl + e >= S) p = 0.f;
          dp[n][2 * i + e] = p * (dp[n][2 * i + e] - dlt[i]) * scale;
        }
      }
    }
    mma::gemm_pb<D, NT>(acc, dp, k_tile(s), lane);  // dQ += dS.K
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wq + g + 8 * i;
    if (row >= S) continue;
    bf16* out = dq + base + (size_t)row * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---- dk/dv --------------------------------------------------------------- //

template <int D, typename PT>
struct EvoDkvCfg {
  // queries a step: K1's dk/dv steps (flash_bwd.cu), which keep dK, dV and
  // the step's P^T and dS^T in registers without a spill
  static constexpr int BQ = D == 128 ? 16 : D == 32 ? 32 : 64;
  // pair tile pitch: a warp's transposed reads (key g + 8i, query 2t + e)
  // hit distinct banks (bf16: 72 / 2 words a row, f32: 68)
  static constexpr int PP = sizeof(PT) == 4 ? 68 : 72;
  // a 3-stage ring: with 2 and this loop's one barrier a step, a step's
  // copy starts only after the step before it, and dk/dv ran slower on an
  // H100 at the MSA row shape (PERF.md §6)
  static constexpr int stages = 3;
  static constexpr size_t tile = (size_t)kEvoTile * D * sizeof(bf16);
  static constexpr size_t qtile = (size_t)BQ * D * sizeof(bf16);
  static constexpr size_t pair = (size_t)BQ * PP * sizeof(PT);
  // a stage: Q, dO, the pair-bias tile, lse, delta
  static constexpr size_t stage = 2 * qtile + pair + 2 * BQ * sizeof(float);
  // K, V, the stages
  static constexpr size_t bytes = 2 * tile + stages * stage;
};

template <int D, typename PT>
__global__ void __launch_bounds__(kEvoThreads)
evoformer_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ mask, const PT* __restrict__ pair,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int R,
                     float scale) {
  using Cfg = EvoDkvCfg<D, PT>;
  constexpr int T = kEvoTile, BQ = Cfg::BQ, NT = BQ / 8, PP = Cfg::PP, NS = Cfg::stages;
  extern __shared__ __align__(128) char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + T * D;
  char* ring = smem + 2 * Cfg::tile;
  auto q_tile = [=](int s) { return reinterpret_cast<bf16*>(ring + s * Cfg::stage); };
  auto do_tile = [=](int s) { return q_tile(s) + BQ * D; };
  auto p_tile = [=](int s) {
    return reinterpret_cast<PT*>(ring + s * Cfg::stage + 2 * Cfg::qtile);
  };
  auto lse_vec = [=](int s) {
    return reinterpret_cast<float*>(ring + s * Cfg::stage + 2 * Cfg::qtile + Cfg::pair);
  };
  auto delta_vec = [=](int s) { return lse_vec(s) + BQ; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int l = blockIdx.x, h = blockIdx.z;
  const int k0 = blockIdx.y * T, n_k = min(T, S - k0);
  const int n_steps = (S + BQ - 1) / BQ;
  const size_t rs = (size_t)H * D;
  const size_t base = ((size_t)l * S * H + h) * D;
  const size_t stat = ((size_t)l * H + h) * S;
  const PT* pb = pair + ((size_t)(l / R) * H + h) * S * S + k0;
  const int pair_bytes = pair_copy_bytes(pair, S);
  const int wk = 16 * warp;  // the warp's first key in the tile

  auto load_q = [&](int it, int s) {
    const int q0 = it * BQ, n = min(BQ, S - q0);
    mma::load_tile<D, BQ, kEvoThreads>(q_tile(s), q + base + q0 * rs, rs, n, tid);
    mma::load_tile<D, BQ, kEvoThreads>(do_tile(s), dout + base + q0 * rs, rs, n, tid);
    load_pair<PT, BQ, PP>(p_tile(s), pb + (size_t)q0 * S, S, n, n_k, pair_bytes, tid);
    mma::load_vec<BQ, kEvoThreads>(lse_vec(s), lse + stat + q0, n, tid);
    mma::load_vec<BQ, kEvoThreads>(delta_vec(s), delta + stat + q0, n, tid);
  };
  mma::load_tile<D, T, kEvoThreads>(Ks, k + base + k0 * rs, rs, n_k, tid);
  mma::load_tile<D, T, kEvoThreads>(Vs, v + base + k0 * rs, rs, n_k, tid);
  // one commit group a step (empty past the last), K and V in the first
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_steps) load_q(j, j);
    mma::cp_async_commit();
  }
  // the mask values of the thread's keys g and g + 8
  float mk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + wk + g + 8 * i;
    mk[i] = mask != nullptr && key < S ? mask[(size_t)l * S + key] : 0.f;
  }
  float acc_k[D / 8][4], acc_v[D / 8][4];
  mma::zero(acc_k);
  mma::zero(acc_v);
  uint32_t kf[D / 16][4], vf[D / 16][4];

  for (int it = 0; it < n_steps; ++it) {
    const int s = it % NS, q0 = it * BQ;
    mma::cp_async_wait<NS - 2>();  // step it has landed
    __syncthreads();               // ... for every thread; step it - 1's stage is free
    if (it + NS - 1 < n_steps) load_q(it + NS - 1, (it + NS - 1) % NS);
    mma::cp_async_commit();
    if constexpr (D <= 64) {
      if (it == 0) {
        evo_frags<D>(kf, Ks, wk, lane);
        evo_frags<D>(vf, Vs, wk, lane);
      }
    }
    const PT* pt = p_tile(s);
    const float* ls = lse_vec(s);
    const float* dls = delta_vec(s);
    const bool edge = q0 + BQ > S || k0 + T > S;
    float p[NT][4], ds[NT][4];
    evo_abt<D, NT>(p, kf, Ks, wk, q_tile(s), lane);  // S^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * n + 2 * t + (e & 1), kr = wk + g + 8 * (e >> 1);
        float x = evo_prob(evo_score(p[n][e], scale, mk[e >> 1], to_f32(pt[qi * PP + kr])),
                           ls[qi]);
        if (edge && (q0 + qi >= S || k0 + kr >= S)) x = 0.f;
        p[n][e] = x;
      }
    mma::gemm_pb<D, NT>(acc_v, p, do_tile(s), lane);  // dV += P^T.dO
    evo_abt<D, NT>(ds, vf, Vs, wk, do_tile(s), lane);  // dP^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * n + 2 * t + (e & 1);
        ds[n][e] = p[n][e] * (ds[n][e] - dls[qi]) * scale;
      }
    mma::gemm_pb<D, NT>(acc_k, ds, q_tile(s), lane);  // dK += dS^T.Q
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + wk + g + 8 * i;
    if (key >= S) continue;
    const size_t off = base + (size_t)key * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

// ---- d(pair) ------------------------------------------------------------- //

template <int D>
struct EvoDbiasCfg {
  static constexpr int stages = 3;
  static constexpr size_t tile = (size_t)kEvoTile * D * sizeof(bf16);
  // a stage: one row's Q, dO (q-tile), K, V (k-tile); lse, delta (q-tile)
  // and the mask values (k-tile)
  static constexpr size_t stage = 4 * tile + 3 * kEvoTile * sizeof(float);
  static constexpr size_t bytes = stages * stage;
};

template <int D, typename PT>
__global__ void __launch_bounds__(kEvoThreads)
evoformer_dbias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ mask, const PT* __restrict__ pair,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ partials, int S, int H, int R, int n_chunks,
                       float scale) {
  using Cfg = EvoDbiasCfg<D>;
  constexpr int T = kEvoTile, NT = T / 8, NS = Cfg::stages;
  extern __shared__ __align__(128) char smem[];
  auto q_tile = [=](int s) { return reinterpret_cast<bf16*>(smem + s * Cfg::stage); };
  auto do_tile = [=](int s) { return q_tile(s) + T * D; };
  auto k_tile = [=](int s) { return q_tile(s) + 2 * T * D; };
  auto v_tile = [=](int s) { return q_tile(s) + 3 * T * D; };
  auto lse_vec = [=](int s) {
    return reinterpret_cast<float*>(smem + s * Cfg::stage + 4 * Cfg::tile);
  };
  auto delta_vec = [=](int s) { return lse_vec(s) + T; };
  auto m_vec = [=](int s) { return lse_vec(s) + 2 * T; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * T, n_k = min(T, S - k0);
  const int q0 = blockIdx.y * T, n_q = min(T, S - q0);
  const int gh = (int)blockIdx.z / n_chunks, chunk = (int)blockIdx.z - gh * n_chunks;
  const int grp = gh / H, h = gh - grp * H;
  const int row0 = (int)((long long)R * chunk / n_chunks);
  const int n_rows = (int)((long long)R * (chunk + 1) / n_chunks) - row0;
  const size_t rs = (size_t)H * D;
  const size_t tile = (size_t)gh * S * S + (size_t)q0 * S + k0;
  const int wq = 16 * warp;

  auto load_row = [&](int r, int s) {
    const int l = grp * R + row0 + r;
    const size_t base = ((size_t)l * S * H + h) * D;
    const size_t stat = ((size_t)l * H + h) * S + q0;
    mma::load_tile<D, T, kEvoThreads>(q_tile(s), q + base + q0 * rs, rs, n_q, tid);
    mma::load_tile<D, T, kEvoThreads>(do_tile(s), dout + base + q0 * rs, rs, n_q, tid);
    mma::load_tile<D, T, kEvoThreads>(k_tile(s), k + base + k0 * rs, rs, n_k, tid);
    mma::load_tile<D, T, kEvoThreads>(v_tile(s), v + base + k0 * rs, rs, n_k, tid);
    mma::load_vec<T, kEvoThreads>(lse_vec(s), lse + stat, n_q, tid);
    mma::load_vec<T, kEvoThreads>(delta_vec(s), delta + stat, n_q, tid);
    if (mask != nullptr)
      mma::load_vec<T, kEvoThreads>(m_vec(s), mask + (size_t)l * S + k0, n_k, tid);
  };
  // one commit group a row (empty past the last): NS - 1 rows in flight
#pragma unroll
  for (int r = 0; r < NS - 1; ++r) {
    if (r < n_rows) load_row(r, r);
    mma::cp_async_commit();
  }

  // the thread's sums, in fragment layout (rows wq + g + 8i, keys 8n + 2t +
  // e at [n][2i + e]), and its pair-bias values in the bias's own type,
  // keys 8n + 2t and 8n + 2t + 1 of row wq + g + 8i at [n][i]
  float acc[NT][4];
  typename Pair2<PT>::T pbv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wq + g + 8 * i, key = 8 * n + 2 * t;
      const PT* src = pair + tile + (size_t)row * S + key;
      pbv[n][i] = Pair2<PT>::make(row < n_q && key < n_k ? src[0] : PT(0.f),
                                  row < n_q && key + 1 < n_k ? src[1] : PT(0.f));
      acc[n][2 * i] = acc[n][2 * i + 1] = 0.f;
    }
  const bool edge = q0 + T > S || k0 + T > S;

  for (int r = 0; r < n_rows; ++r) {
    const int s = r % NS;
    mma::cp_async_wait<NS - 2>();  // row r has landed
    __syncthreads();               // ... for every thread; row r - 1's stage is free
    if (r + NS - 1 < n_rows) load_row(r + NS - 1, (r + NS - 1) % NS);
    mma::cp_async_commit();
    float sc[NT][4], dp[NT][4];
    mma::zero(sc);
    mma::gemm_abt<D, NT>(sc, q_tile(s), wq, k_tile(s), lane);  // S
    mma::zero(dp);
    mma::gemm_abt<D, NT>(dp, do_tile(s), wq, v_tile(s), lane);  // dP
    const float* ls = lse_vec(s);
    const float* dls = delta_vec(s);
    const float* mv = m_vec(s);
    float lse_r[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lse_r[i] = ls[wq + g + 8 * i];
      dlt[i] = dls[wq + g + 8 * i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int kl = 8 * n + 2 * t;
      const float2 mk = mask != nullptr ? *reinterpret_cast<const float2*>(mv + kl)
                                        : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 pr = Pair2<PT>::f32(pbv[n][i]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = evo_prob(evo_score(sc[n][2 * i + e], scale, e ? mk.y : mk.x,
                                       e ? pr.y : pr.x),
                             lse_r[i]);
          if (edge && (q0 + wq + g + 8 * i >= S || k0 + kl + e >= S)) p = 0.f;
          acc[n][2 * i + e] += p * (dp[n][2 * i + e] - dlt[i]);
        }
      }
    }
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wq + g + 8 * (e >> 1), key = 8 * n + 2 * t + (e & 1);
      // [C][G * H][S][S]: this chunk's slab, then the tile's element
      if (row < n_q && key < n_k)
        partials[(size_t)chunk * (gridDim.z / n_chunks) * S * S + tile + (size_t)row * S + key] =
            acc[n][e];
    }
}

// dpair[i] = the C chunks' partials at i added in chunk order, in the pair
// bias's type
template <typename PT>
__global__ void __launch_bounds__(256)
evoformer_dbias_sum_kernel(const float* __restrict__ partials, PT* __restrict__ dpair,
                           size_t n, int n_chunks) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float x = partials[i];
    for (int c = 1; c < n_chunks; ++c) x += partials[(size_t)c * n + i];
    store_f32(dpair + i, x);
  }
}

// ---- launches ------------------------------------------------------------- //

template <typename Kernel>
cudaError_t evo_smem(Kernel* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D, typename PT>
int launch_evoformer_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* mask, const void* pair, const void* lse,
                        const void* delta, void* dq, int L, int S, int H, int R, float scale,
                        cudaStream_t stream) {
  const size_t smem = EvoDqCfg<D, PT>::bytes;
  cudaError_t err = evo_smem(evoformer_dq_kernel<D, PT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L, (S + kEvoTile - 1) / kEvoTile, H);
  evoformer_dq_kernel<D, PT><<<grid, kEvoThreads, smem, stream>>>(
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
  const size_t smem = EvoDkvCfg<D, PT>::bytes;
  cudaError_t err = evo_smem(evoformer_dkv_kernel<D, PT>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(L, (S + kEvoTile - 1) / kEvoTile, H);
  evoformer_dkv_kernel<D, PT><<<grid, kEvoThreads, smem, stream>>>(
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
                           const void* delta, void* dpair, void* partials, int L, int S,
                           int H, int R, int n_chunks, float scale, cudaStream_t stream) {
  if (n_chunks < 1 || n_chunks > R || partials == nullptr) return -1;
  const size_t smem = EvoDbiasCfg<D>::bytes;
  cudaError_t err = evo_smem(evoformer_dbias_kernel<D, PT>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (S + kEvoTile - 1) / kEvoTile;
  const int GH = (L / R) * H;
  dim3 grid(nt, nt, GH * n_chunks);
  evoformer_dbias_kernel<D, PT><<<grid, kEvoThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(mask), static_cast<const PT*>(pair),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(partials), S, H, R, n_chunks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)GH * S * S;
  const size_t want = (n + 255) / 256;
  const int blocks = want < 4096 ? (int)want : 4096;
  evoformer_dbias_sum_kernel<PT><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<PT*>(dpair), n, n_chunks);
  return (int)cudaGetLastError();
}

template <int D, typename PT>
int evo_bwd_attributes(int kernel, int* out) {
  if (kernel == 1)
    return mma::kernel_attributes(evoformer_dq_kernel<D, PT>, kEvoThreads,
                                  EvoDqCfg<D, PT>::bytes, out);
  if (kernel == 2)
    return mma::kernel_attributes(evoformer_dkv_kernel<D, PT>, kEvoThreads,
                                  EvoDkvCfg<D, PT>::bytes, out);
  if (kernel == 3)
    return mma::kernel_attributes(evoformer_dbias_kernel<D, PT>, kEvoThreads,
                                  EvoDbiasCfg<D>::bytes, out);
  return -1;
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

// Same inputs -> dpair [L / R, H, S, S] in the pair bias's type, each
// group's R rows summed in n_chunks contiguous chunks (1 <= n_chunks <= R)
// into `partials`, f32 scratch of n_chunks * (L / R) * H * S * S, which a
// second kernel on the same stream adds in chunk order.
extern "C" int dstorch_evoformer_dbias_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* mask,
                                            const void* pair, const void* lse,
                                            const void* delta, void* dpair, void* partials,
                                            int L, int S, int H, int D, int R, int n_chunks,
                                            float scale, int pair_f32, void* stream) {
  if (L == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pair_f32) {
    DSTORCH_K10_DISPATCH(D, float, dstorch::launch_evoformer_dbias, q, k, v, dout, mask,
                         pair, lse, delta, dpair, partials, L, S, H, R, n_chunks, scale, st)
  }
  DSTORCH_K10_DISPATCH(D, dstorch::bf16, dstorch::launch_evoformer_dbias, q, k, v, dout,
                       mask, pair, lse, delta, dpair, partials, L, S, H, R, n_chunks, scale,
                       st)
}

// K10's backward kernels as compiled: kernel 1 = dq, 2 = dk/dv, 3 = d(pair),
// at head dim D with an f32 (pair_f32) or bf16 pair bias; out [6] int32 as
// dstorch_flash_kernel_attrs gives them. Returns a cudaError_t, -1 for an
// unknown kernel or head dim.
extern "C" int dstorch_evoformer_bwd_attrs(int kernel, int D, int pair_f32, void* out) {
  int* o = static_cast<int*>(out);
  if (pair_f32) {
    DSTORCH_K10_DISPATCH(D, float, dstorch::evo_bwd_attributes, kernel, o)
  }
  DSTORCH_K10_DISPATCH(D, dstorch::bf16, dstorch::evo_bwd_attributes, kernel, o)
}
