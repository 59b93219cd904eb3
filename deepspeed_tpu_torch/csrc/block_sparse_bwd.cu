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
// row that sees no key (lse = -1e30) gets zero gradients. Causal is top-left
// (key <= query).
//
// Bounds on the H100 at phase 7's documented fixed layout (B = 2, H = 16,
// S = 4096, D = 64, 141 M visible pairs): dq does three products a pair,
// 6*D flops, 54 GFLOP = 55 us at 989 TFLOP/s, against 85 MB (25 us); dk/dv
// four products, 8*D flops, 72 GFLOP = 73 us, against 101 MB (30 us). Both
// are bound by operations.
//
// Design: K1's backward (flash_bwd.cu) on the tensor cores (mma_common.cuh),
// with its key or query loop driven by the tile list. 4 warps a block, each
// warp computing 16 x 16 chunks of every product, f32 accumulators in
// registers, operands through ldmatrix (.trans for the [k][n] ones), tiles
// streamed through 2-stage cp.async rings.
// - The 16-block skip: the tile's fine pattern has one bit per 16 x 16
//   chunk, and only chunks whose bit is set are computed, each a whole
//   step (scores, probabilities, score gradients and their products into
//   the accumulators). In dq a block takes a 64-row q-tile and warp w its
//   16-row band, walking the chunks c with bit 4w + c of each k-tile in the
//   list; a warp with no bits in a tile idles through the block's barriers.
// - dk/dv is cut finer, because its skip left warps idle: a layout's
//   global key columns are seen by every q-tile through one 16-key chunk
//   of the k-tile, so a block of 64 keys had one working warp for most of
//   its list. A block takes one 16-key chunk, and its warps share the
//   chunk's (q-tile, band) items in turn, each streaming its own bands and
//   adding its partial dK, dV at the end in warp order (deterministic).
// - The layout block is a multiple of 16 and divides S, so a chunk is
//   wholly inside the pattern and inside S, or has no bit: the only mask
//   left is causal's, on the 16 x 16 chunks that straddle the diagonal.
//   There dq sums dP on the CUDA cores in the plain version's order
//   (chunk_abt_fma): a sequence's first row sees one key, and its gradient
//   is rounding alone.
// - dq keeps the block's 64 Q and dO rows in shared memory and streams K
//   and V tiles; dk/dv keeps its 16 K and V rows and streams 16-row bands of
//   Q and dO with their lse and delta. A chunk step holds 16 x 16 scores,
//   so no head dim needs a shorter step (K1's dk/dv needs 16-query steps at
//   D = 128, where its 16 x 64 step spilled). At D <= 64 a warp also keeps
//   its A fragments of Q and dO (dq) or K and V (dk/dv) in registers.
#include "mma_common.cuh"

namespace dstorch {

using mma::bf16;

constexpr int kBsbThreads = 128;  // 4 warps of 16 rows
constexpr int kBsbTile = 64;      // q- and k-tiles of the tables

template <int D>
struct BsbCfg {
  // dq: Q, dO, then two stages of K and V
  static constexpr size_t dq_bytes = (size_t)6 * kBsbTile * D * sizeof(bf16);
  // a warp's 16-row A fragments of the block's resident tiles in registers
  static constexpr bool frags_in_regs = D <= 64;
};

// the A fragments of rows [r0, r0 + 16) of a resident [64][D] tile
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&f)[D / 16][4], const bf16* tile, int r0,
                                           int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) mma::ldsm_a<D>(f[kc], tile, r0, kc, lane);
}

// acc [16 x 16] += A . B^T over D: A = the warp's 16 rows of a resident tile
// (from `frags` or, at D = 128, through ldmatrix from `a_tile`), B = rows
// [b0, b0 + 16) of a [*][D] tile
template <int D>
__device__ __forceinline__ void chunk_abt(float (&acc)[2][4], const uint32_t (&frags)[D / 16][4],
                                          const bf16* a_tile, int a_r0, const bf16* b_tile,
                                          int b0, int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4], b[4];
    if constexpr (BsbCfg<D>::frags_in_regs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = frags[kc][i];
    } else {
      mma::ldsm_a<D>(a, a_tile, a_r0, kc, lane);
    }
    mma::ldsm_b<D>(b, b_tile, b0, kc, lane);
    mma::mma16816(acc[0], a, b[0], b[1]);
    mma::mma16816(acc[1], a, b[2], b[3]);
  }
}

// The same product (into zeroed acc) on the CUDA cores: each element an f32
// FMA chain over d in index order, the order of the plain version's f32
// product. Used for dP on the chunks that straddle the causal diagonal: a
// sequence's first row sees one key, so its dp - delta is rounding alone
// (exactly 0 unrounded), and the tensor cores' summation order left it a
// few ulps from the plain version's: most of that row's tiny gradient.
template <int D>
__device__ __forceinline__ void chunk_abt_fma(float (&acc)[2][4], const bf16* a_tile, int a_r0,
                                              const bf16* b_tile, int b0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D / 8; ++c) {
    // 16-byte chunk c of the thread's two A rows and four B rows
    uint4 ar[2], br[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ar[h] = *reinterpret_cast<const uint4*>(a_tile + mma::swz<D>(a_r0 + g + 8 * h, c));
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        br[n][e] = *reinterpret_cast<const uint4*>(
            b_tile + mma::swz<D>(b0 + 8 * n + 2 * t + e, c));
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(&ar[i >> 1])[w]);
          const float2 y = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(&br[n][i & 1])[w]);
          acc[n][i] = fmaf(x.y, y.y, fmaf(x.x, y.x, acc[n][i]));
        }
  }
}

// acc [16 x D] += X . B: X a 16 x 16 accumulator (packed to bf16 A
// fragments), B = rows [b0, b0 + 16) of a [*][D] tile
template <int D>
__device__ __forceinline__ void chunk_pb(float (&acc)[D / 8][4], const float (&x)[2][4],
                                         const bf16* b_tile, int b0, int lane) {
  uint32_t a[4];
  mma::acc_to_a<2>(a, x, 0);
#pragma unroll
  for (int nc = 0; nc < D / 16; ++nc) {
    uint32_t b[4];
    mma::ldsm_bt<D>(b, b_tile, b0, nc, lane);
    mma::mma16816(acc[2 * nc], a, b[0], b[1]);
    mma::mma16816(acc[2 * nc + 1], a, b[2], b[3]);
  }
}

// CAUSAL is a template flag here (the diagonal's dP path would cost the
// unmasked kernel registers and occupancy)
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kBsbThreads)
block_sparse_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, const int* __restrict__ row_ptr,
                       const int2* __restrict__ ent, int H, int S, int Hl, float scale) {
  constexpr int T = kBsbTile, KC = D / 16;
  extern __shared__ __align__(128) char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + T * D;
  auto k_tile = [=](int s) { return Qs + (2 * T + 2 * T * s) * D; };
  auto v_tile = [=](int s) { return Qs + (2 * T + 2 * T * s + T) * D; };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, h = bh % H;
  const int nt = (S + T - 1) / T;
  // under causal the last q-tiles have the longest lists: start them first
  const int it = nt - 1 - (int)blockIdx.y;
  const int r0 = it * T, n_q = min(T, S - r0);
  const int wr0 = r0 + 16 * warp;  // the warp's band
  const size_t base = (size_t)bh * S * D;
  const int* tp = row_ptr + (size_t)(h % Hl) * (nt + 1);
  const int e0 = tp[it], n_ent = tp[it + 1] - e0;

  auto load_kv = [&](int e, int s) {
    const int k0 = ent[e0 + e].x * T, n = min(T, S - k0);
    mma::load_tile<D, T, kBsbThreads>(k_tile(s), k + base + (size_t)k0 * D, D, n, tid);
    mma::load_tile<D, T, kBsbThreads>(v_tile(s), v + base + (size_t)k0 * D, D, n, tid);
  };
  mma::load_tile<D, T, kBsbThreads>(Qs, q + base + (size_t)r0 * D, D, n_q, tid);
  mma::load_tile<D, T, kBsbThreads>(dOs, dout + base + (size_t)r0 * D, D, n_q, tid);
  if (n_ent > 0) load_kv(0, 0);
  mma::cp_async_commit();
  // the thread's rows g and g + 8: lse (in log2 units) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    lse2[i] = row < S ? lse[(size_t)bh * S + row] * mma::kLog2e : 0.f;
    dlt[i] = row < S ? delta[(size_t)bh * S + row] : 0.f;
  }
  const float scale_log2 = scale * mma::kLog2e;
  float acc[D / 8][4];
  mma::zero(acc);
  uint32_t qf[KC][4], df[KC][4];

  for (int e = 0; e < n_ent; ++e) {
    const int s = e & 1;
    const int2 en = ent[e0 + e];
    if (e + 1 < n_ent) {
      load_kv(e + 1, s ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (BsbCfg<D>::frags_in_regs) {
      if (e == 0) {
        load_frags<D>(qf, Qs, 16 * warp, lane);
        load_frags<D>(df, dOs, 16 * warp, lane);
      }
    }
    const int k0 = en.x * T;
    const int band = (en.y >> (4 * warp)) & 0xF;  // the warp's active key chunks
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!((band >> c) & 1)) continue;
      float p[2][4], ds[2][4];
      mma::zero(p);
      chunk_abt<D>(p, qf, Qs, 16 * warp, k_tile(s), 16 * c, lane);  // S
      const bool diag = CAUSAL && k0 + 16 * c == wr0;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = mma::exp2_approx(fmaf(p[n][i], scale_log2, -lse2[i >> 1]));
          if (diag && 8 * n + 2 * t + (i & 1) > g + 8 * (i >> 1)) x = 0.f;
          p[n][i] = x;
        }
      if (diag) {
        chunk_abt_fma<D>(ds, dOs, 16 * warp, v_tile(s), 16 * c, lane);  // dP
      } else {
        mma::zero(ds);
        chunk_abt<D>(ds, df, dOs, 16 * warp, v_tile(s), 16 * c, lane);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[n][i] = p[n][i] * (ds[n][i] - dlt[i >> 1]) * scale;
      chunk_pb<D>(acc, ds, k_tile(s), 16 * c, lane);  // dQ += dS.K
    }
    __syncthreads();  // stage s is free for entry e + 2
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    if (row >= S) continue;
    bf16* o = dq + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// dk/dv: a block owns one 16-key chunk (its K and V rows resident) and its
// 4 warps share the chunk's items, the (q-tile, 16-query band) pairs whose
// bit is set, in turn: item i goes to warp i % 4, which streams that band's
// Q, dO, lse and delta through its own 2-stage cp.async ring and keeps
// partial dK and dV in registers. At the end warps 1-3 hand their partials
// over through shared memory and warp 0 adds them in warp order, so the
// result is the same bits every run.
template <int D>
struct DkvCfg {
  static constexpr int band = 16 * D;                   // bf16 elements of a 16-row tile
  static constexpr int item_bytes = 4 * band + 2 * 16 * sizeof(float);  // Q, dO; lse, delta
  // a warp's ring (4 stages ran no faster on an H100 at layout A, D = 64)
  static constexpr int stages = 2;
  // K, V, the warps' rings, then each ring's first queries
  static constexpr int ring_bytes = 4 * stages * item_bytes;
  static constexpr size_t bytes = (size_t)4 * band + ring_bytes + 4 * stages * sizeof(int);
  // warps 1-3's dK and dV partials, over the rings at the end
  static_assert(3 * 2 * 16 * D * sizeof(float) <= ring_bytes, "reduction buffer");
};

template <int D>
__global__ void __launch_bounds__(kBsbThreads)
block_sparse_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        const int* __restrict__ col_ptr, const int2* __restrict__ tent,
                        int H, int S, int Hl, float scale, int causal) {
  using Cfg = DkvCfg<D>;
  constexpr int T = kBsbTile, KC = D / 16;
  extern __shared__ __align__(128) char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Cfg::band;
  char* rings = smem + 4 * Cfg::band;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, h = bh % H;
  const int nt = (S + T - 1) / T;
  // under causal the first keys have the longest lists: start them first
  const int jt = blockIdx.y >> 2, c = blockIdx.y & 3;  // k-tile, chunk in it
  const int kc0 = jt * T + 16 * c;                      // the block's first key
  const size_t base = (size_t)bh * S * D;
  const float* lb = lse + (size_t)bh * S;
  const float* deb = delta + (size_t)bh * S;
  const int* tp = col_ptr + (size_t)(h % Hl) * (nt + 1);
  const int e0 = tp[jt], n_ent = tp[jt + 1] - e0;
  constexpr int NS = Cfg::stages;
  auto item = [=](int s) { return rings + (NS * warp + s) * Cfg::item_bytes; };
  int* q_of = reinterpret_cast<int*>(rings + Cfg::ring_bytes) + NS * warp;  // per stage
  auto q_band = [=](int s) { return reinterpret_cast<bf16*>(item(s)); };
  auto do_band = [=](int s) { return reinterpret_cast<bf16*>(item(s)) + Cfg::band; };
  auto lse_band = [=](int s) { return reinterpret_cast<float*>(item(s) + 4 * Cfg::band); };
  auto delta_band = [=](int s) { return lse_band(s) + 16; };

  mma::load_tile<D, 16, kBsbThreads>(Ks, k + base + (size_t)kc0 * D, D, 16, tid);
  mma::load_tile<D, 16, kBsbThreads>(Vs, v + base + (size_t)kc0 * D, D, 16, tid);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[KC][4], vf[KC][4];
  if constexpr (BsbCfg<D>::frags_in_regs) {
    load_frags<D>(kf, Ks, 0, lane);
    load_frags<D>(vf, Vs, 0, lane);
  }

  // the warp's items: of the list's (entry, band r) pairs with bit 4r + c,
  // in list order, every 4th from the warp's own
  int e = -1, bands = 0, seen = 0;
  auto next = [&](int& q0) -> bool {  // the next item's first query
    for (;;) {
      while (bands == 0) {
        if (++e >= n_ent) return false;
        const int bits = tent[e0 + e].y >> c;
        bands = (bits & 1) | ((bits >> 3) & 2) | ((bits >> 6) & 4) | ((bits >> 9) & 8);
      }
      const int r = __ffs(bands) - 1;
      bands &= bands - 1;
      if ((seen++ & 3) == warp) {
        q0 = tent[e0 + e].x * T + 16 * r;
        return true;
      }
    }
  };
  auto load_item = [&](int q0, int s) {
    mma::load_tile<D, 16, 32>(q_band(s), q + base + (size_t)q0 * D, D, 16, lane);
    mma::load_tile<D, 16, 32>(do_band(s), dout + base + (size_t)q0 * D, D, 16, lane);
    mma::load_vec<16, 32>(lse_band(s), lb + q0, 16, lane);
    mma::load_vec<16, 32>(delta_band(s), deb + q0, 16, lane);
  };

  const float scale_log2 = scale * mma::kLog2e;
  float acc_k[D / 8][4], acc_v[D / 8][4];
  mma::zero(acc_k);
  mma::zero(acc_v);
  // one commit group an item (empty past the last): NS - 1 items in flight
  int queued = 0;
  bool more = true;
  auto prefetch = [&]() {
    int q0;
    if (more && (more = next(q0))) {
      load_item(q0, queued % NS);
      q_of[queued % NS] = q0;
      ++queued;
    }
    mma::cp_async_commit();
  };
  for (int j = 0; j < NS - 1; ++j) prefetch();
  for (int it = 0; it < queued; ++it) {
    prefetch();
    mma::cp_async_wait<NS - 1>();  // item it has landed
    __syncwarp();
    const int s = it % NS, q_cur = q_of[s];
    const float* ls = lse_band(s);
    const float* dls = delta_band(s);
    float p[2][4], ds[2][4];
    mma::zero(p);
    chunk_abt<D>(p, kf, Ks, 0, q_band(s), 0, lane);  // S^T
    const bool diag = causal && q_cur == kc0;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = 8 * n + 2 * t + (i & 1);
        float x = mma::exp2_approx(fmaf(p[n][i], scale_log2, -ls[qi] * mma::kLog2e));
        if (diag && g + 8 * (i >> 1) > qi) x = 0.f;
        p[n][i] = x;
      }
    chunk_pb<D>(acc_v, p, do_band(s), 0, lane);  // dV += P^T.dO
    mma::zero(ds);
    chunk_abt<D>(ds, vf, Vs, 0, do_band(s), 0, lane);  // dP^T
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[n][i] = p[n][i] * (ds[n][i] - dls[8 * n + 2 * t + (i & 1)]) * scale;
    chunk_pb<D>(acc_k, ds, q_band(s), 0, lane);  // dK += dS^T.Q
    __syncwarp();  // stage s is free for item it + NS
  }
  mma::cp_async_wait<0>();

  // warps 1-3's partials to shared memory (fragment order, lane fastest),
  // added by warp 0 in warp order
  __syncthreads();
  float* red = reinterpret_cast<float*>(rings);
  auto slot = [&](int w, int kind, int n, int i) {
    return red + ((((w - 1) * 2 + kind) * (D / 8) + n) * 4 + i) * 32 + lane;
  };
  if (warp > 0) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *slot(warp, 0, n, i) = acc_k[n][i];
        *slot(warp, 1, n, i) = acc_v[n][i];
      }
  }
  __syncthreads();
  if (warp > 0) return;
  for (int w = 1; w < 4; ++w)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_k[n][i] += *slot(w, 0, n, i);
        acc_v[n][i] += *slot(w, 1, n, i);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t off = base + (size_t)(kc0 + g + 8 * i) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(acc_k[n][2 * i], acc_k[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

template <int D, bool CAUSAL>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, const void* row_ptr, const void* ent, int B, int H,
              int S, int Hl, float scale, cudaStream_t stream) {
  const size_t smem = BsbCfg<D>::dq_bytes;
  cudaError_t err = cudaFuncSetAttribute(block_sparse_dq_kernel<D, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + kBsbTile - 1) / kBsbTile);
  block_sparse_dq_kernel<D, CAUSAL><<<grid, kBsbThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<const int*>(row_ptr),
      static_cast<const int2*>(ent), H, S, Hl, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_block_sparse_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq,
                           const void* row_ptr, const void* ent, int B, int H, int S,
                           int Hl, float scale, int causal, cudaStream_t stream) {
  if (causal)
    return launch_dq<D, true>(q, k, v, dout, lse, delta, dq, row_ptr, ent, B, H, S, Hl, scale,
                              stream);
  return launch_dq<D, false>(q, k, v, dout, lse, delta, dq, row_ptr, ent, B, H, S, Hl, scale,
                             stream);
}

template <int D>
int launch_block_sparse_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv,
                            const void* col_ptr, const void* tent, int B, int H, int S,
                            int Hl, float scale, int causal, cudaStream_t stream) {
  const size_t smem = DkvCfg<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      block_sparse_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, S / 16);
  block_sparse_dkv_kernel<D><<<grid, kBsbThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<const int*>(col_ptr),
      static_cast<const int2*>(tent), H, S, Hl, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int bsb_attributes(int kernel, int* out) {
  if (kernel == 1)
    return mma::kernel_attributes(block_sparse_dq_kernel<D, false>, kBsbThreads,
                                  BsbCfg<D>::dq_bytes, out);
  if (kernel == 3)
    return mma::kernel_attributes(block_sparse_dq_kernel<D, true>, kBsbThreads,
                                  BsbCfg<D>::dq_bytes, out);
  return mma::kernel_attributes(block_sparse_dkv_kernel<D>, kBsbThreads, DkvCfg<D>::bytes,
                                out);
}

}  // namespace dstorch

// q, k, v, dout [B, H, S, D] bf16; lse, delta [B, H, S] f32; the forward's
// tables row_ptr [Hl, nt + 1], ent [nnz, 2] int32 -> dq [B, H, S, D] bf16.
// S must be a multiple of 16 (the layout block, a multiple of 16, divides
// it). Returns the launch's cudaError_t, -1 for an unsupported head dim or S.
extern "C" int dstorch_block_sparse_dq_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dq,
                                            const void* row_ptr, const void* ent, int B,
                                            int H, int S, int D, int Hl, float scale,
                                            int causal, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  if (S % 16 != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_MMA_DISPATCH_D(D, dstorch::launch_block_sparse_dq, q, k, v, dout, lse, delta, dq,
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
  if (S % 16 != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_MMA_DISPATCH_D(D, dstorch::launch_block_sparse_dkv, q, k, v, dout, lse, delta, dk,
                         dv, col_ptr, tent, B, H, S, Hl, scale, causal, st)
}

// K9's backward kernels as compiled: kernel 1 = dq, 2 = dk/dv, 3 = dq under
// causal, at head dim D; out [6] int32 as dstorch_flash_kernel_attrs gives
// them. Returns a cudaError_t, -1 for an unknown kernel or head dim.
extern "C" int dstorch_block_sparse_bwd_attrs(int kernel, int D, void* out) {
  if (kernel < 1 || kernel > 3) return -1;
  int* o = static_cast<int*>(out);
  DSTORCH_MMA_DISPATCH_D(D, dstorch::bsb_attributes, kernel, o)
}
