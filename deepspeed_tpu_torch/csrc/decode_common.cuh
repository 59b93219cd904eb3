// Shared device code of the paged decode kernels (paged_decode.cu, and the
// split-K partials of paged_splitk.cu): one query token per sequence, one
// block of 128 threads per (sequence [, split], kv head).
//
// decode_attend<G, LPR, KV, SIDE> walks page tokens [t_lo, t_hi) of one
// sequence, then (optionally) side rows c_lo <= cc <= j of its slab (a
// sliding window sets t_lo and c_lo; pages and side rows outside those
// ranges are neither read nor computed), and leaves the
// block's merged online-softmax state in shared memory: per query head g of
// the kv head's group, the max m, the sum l and the unnormalised
// accumulator acc[D]. The caller's epilogue normalises it.
//
// Layout: a row group of LPR lanes (LPR = D/8 rounded up to a power of two)
// owns one token at a time; each lane holds 8 consecutive dims of the
// token's K and V rows, the q.k dot reduces over the row group with xor
// shuffles, and the group keeps its own running (m, l, acc) — no barrier in
// the token loop. Each group issues U tokens' loads before using them, to
// keep enough bytes in flight. At the end the groups merge: by shuffles
// inside a warp, then across the four warps through shared memory.
//
// Element types: KV is the page type, bf16 or int8_t (int8 pages come with
// f32 scale tiles [NB, R8, 128], flat index kv*Hkv*bs + h*bs + t per page);
// SIDE is the side rows' type, bf16 for a bf16 pool and f32 for an int8
// one (the side rows of an int8 pool hold kv_write_dequant values, which a
// bf16 copy would round away from what the pages store). For int8 pages
// each token's K scale multiplies its score and its V scale its p before
// the p.V update (the fold of the JAX package's _colscale_pages), in f32.
//
// ALiBi (slopes != null): each token's score for query head g gets
// slopes[hk * G + g] * pos added after the scale (and the K scale), before
// the running max; pos is the token's absolute position: t for page
// tokens, side_pos0 + cc for side row cc. Without slopes the slope is 0,
// and fmaf(0, pos, score) leaves every score bit for bit as it was. Tokens
// outside the walked ranges are neither read nor biased.
#pragma once

#include "attn_common.cuh"

namespace dstorch {

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;

// 8 consecutive elements of a row, as loaded (before conversion)
template <typename T> struct Raw8;
template <> struct Raw8<bf16> { uint4 u; };
template <> struct Raw8<int8_t> { uint2 u; };
template <> struct Raw8<float> { float4 a, b; };

template <typename T>
__device__ __forceinline__ Raw8<T> zero8() {
  Raw8<T> r;
  if constexpr (std::is_same<T, float>::value) {
    r.a = make_float4(0.f, 0.f, 0.f, 0.f);
    r.b = r.a;
  } else if constexpr (std::is_same<T, int8_t>::value) {
    r.u = make_uint2(0, 0);
  } else {
    r.u = make_uint4(0, 0, 0, 0);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ Raw8<T> load8(const T* p) {
  Raw8<T> r;
  if constexpr (std::is_same<T, float>::value) {
    r.a = *reinterpret_cast<const float4*>(p);
    r.b = *reinterpret_cast<const float4*>(p + 4);
  } else if constexpr (std::is_same<T, int8_t>::value) {
    r.u = *reinterpret_cast<const uint2*>(p);
  } else {
    r.u = load16(p);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void to_float8(const Raw8<T>& r, float (&f)[8]) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
    f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
  } else if constexpr (std::is_same<T, int8_t>::value) {
    const char4 lo = *reinterpret_cast<const char4*>(&r.u.x);
    const char4 hi = *reinterpret_cast<const char4*>(&r.u.y);
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
  } else {
    bf16x8_to_float(r.u, f);
  }
}

// one token into the row group's running state; ks/vs are the token's
// dequant scales (1 for bf16 and f32 rows), sl[g] * pos its ALiBi bias
template <int G, int LPR, typename T>
__device__ __forceinline__ void decode_update(const float (&qf)[G][8], const Raw8<T>& kr,
                                              const Raw8<T>& vr, float ks, float vs,
                                              bool ok, const float (&sl)[G], float pos,
                                              float (&m)[G], float (&l)[G],
                                              float (&acc)[G][8]) {
  float kf[8], vf[8];
  to_float8<T>(kr, kf);
  to_float8<T>(vr, vf);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float sc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sc = fmaf(qf[g][i], kf[i], sc);
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      sc += __shfl_xor_sync(0xffffffffu, sc, off);
    sc = fmaf(sl[g], pos, sc * ks);
    if (ok) {
      const float m_new = fmaxf(m[g], sc);
      const float alpha = __expf(m[g] - m_new);
      const float p = __expf(sc - m_new);
      const float pv = p * vs;
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(acc[g][i], alpha, pv * vf[i]);
      m[g] = m_new;
    }
  }
}

// Shared-memory state the epilogue reads: for query head g and dim d,
// m = sm_m[w][g], l = sm_l[w][g], acc = sm_acc[w][g][d] over the warps w,
// merged by decode_final.
template <int G>
__host__ __device__ constexpr size_t decode_smem_bytes(int D) {
  return ((size_t)kDecWarps * G * D + 2 * kDecWarps * G) * sizeof(float);
}

struct DecodePage {
  const void* kv;      // [NB, 2, Hkv, bs, D] of KV
  const float* sc;     // [NB, R8, 128] scale tiles (int8 pages) or null
  int r8;              // scale-tile rows per page
  const int* btr;      // this sequence's block-table row
  int Hkv, bs, D;
};

// q row `qrow` [G*D] (the kv head's query heads) is pre-scaled by `scale`;
// `slopes` [H] (ALiBi) or null, side row cc at position side_pos0 + cc.
template <int G, int LPR, typename KV, typename SIDE>
__device__ __forceinline__ void decode_attend(const bf16* __restrict__ qrow,
                                              const DecodePage pg, int hk, int t_lo,
                                              int t_hi, const SIDE* __restrict__ side_k,
                                              const SIDE* __restrict__ side_v,
                                              int n_side, float scale, char* smem,
                                              int c_lo, const float* __restrict__ slopes,
                                              int side_pos0) {
  constexpr int NGROUP = kDecThreads / LPR;
  constexpr int U = G <= 2 ? 4 : 2;
  constexpr bool I8 = std::is_same<KV, int8_t>::value;
  const int tid = threadIdx.x;
  const int lane_in_group = tid & (LPR - 1);
  const int grp = tid / LPR;
  const int D = pg.D, Hkv = pg.Hkv, bs = pg.bs;
  const int d0 = lane_in_group * 8;
  const bool act = d0 < D;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float qf[G][8], m[G], l[G], acc[G][8], sl[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    sl[g] = slopes != nullptr ? __ldg(slopes + hk * G + g) : 0.f;
    const uint4 u = act ? load16(qrow + (size_t)g * D + d0) : zero;
    bf16x8_to_float(u, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qf[g][i] *= scale;
      acc[g][i] = 0.f;
    }
    m[g] = kNegBig;
    l[g] = 0.f;
  }

  // pages: tokens [t_lo, t_hi)
  const KV* kv = static_cast<const KV*>(pg.kv);
  const size_t page_elems = (size_t)2 * Hkv * bs * D;
  const size_t koff = (size_t)hk * bs * D + d0;
  const size_t voff = (size_t)(Hkv + hk) * bs * D + d0;
  for (int t0 = t_lo; t0 < t_hi; t0 += NGROUP * U) {
    Raw8<KV> kr[U], vr[U];
    float ks[U], vs[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NGROUP + grp;
      ok[u] = t < t_hi;
      kr[u] = zero8<KV>();
      vr[u] = zero8<KV>();
      ks[u] = 1.f;
      vs[u] = 1.f;
      if (ok[u]) {
        const int pi = t / bs;
        const int slot = t - pi * bs;
        const int page_id = __ldg(pg.btr + pi);
        if (act) {
          const KV* page = kv + (size_t)page_id * page_elems + (size_t)slot * D;
          kr[u] = load8<KV>(page + koff);
          vr[u] = load8<KV>(page + voff);
        }
        if constexpr (I8) {
          const float* ps = pg.sc + (size_t)page_id * pg.r8 * 128;
          ks[u] = __ldg(ps + hk * bs + slot);
          vs[u] = __ldg(ps + (Hkv + hk) * bs + slot);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      decode_update<G, LPR, KV>(qf, kr[u], vr[u], ks[u], vs[u], ok[u], sl,
                                (float)(t0 + u * NGROUP + grp), m, l, acc);
  }

  // side rows c_lo <= cc < n_side (row cc*Hkv + hk of this sequence's slab)
  for (int c0 = c_lo; c0 < n_side; c0 += NGROUP) {
    const int cc = c0 + grp;
    const bool ok = cc < n_side;
    Raw8<SIDE> kr = zero8<SIDE>(), vr = zero8<SIDE>();
    if (ok && act) {
      const size_t row = (size_t)cc * Hkv + hk;
      kr = load8<SIDE>(side_k + row * D + d0);
      vr = load8<SIDE>(side_v + row * D + d0);
    }
    decode_update<G, LPR, SIDE>(qf, kr, vr, 1.f, 1.f, ok, sl, (float)(side_pos0 + cc), m,
                                l, acc);
  }

  // merge the row groups of each warp (same lane_in_group, xor over groups)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float m_new = fmaxf(m[g], mo);
      const float a = __expf(m[g] - m_new), b = __expf(mo - m_new);
      l[g] = l[g] * a + lo * b;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * b;
      }
      m[g] = m_new;
    }
  }

  // the warps' states into shared memory
  float* sm_acc = reinterpret_cast<float*>(smem);          // [W][G][D]
  float* sm_m = sm_acc + (size_t)kDecWarps * G * D;        // [W][G]
  float* sm_l = sm_m + kDecWarps * G;                      // [W][G]
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (act)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (d0 + i < D) sm_acc[((size_t)warp * G + g) * D + d0 + i] = acc[g][i];
      if (lane == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
    }
  }
  __syncthreads();
}

// Merge the warps' states of query head g at dim d: (M, L, A) with
// out = A / L (0 when L == 0) and lse = M + log L.
template <int G>
__device__ __forceinline__ void decode_final(const char* smem, int D, int g, int d,
                                             float& M, float& L, float& A) {
  const float* sm_acc = reinterpret_cast<const float*>(smem);
  const float* sm_m = sm_acc + (size_t)kDecWarps * G * D;
  const float* sm_l = sm_m + kDecWarps * G;
  M = kNegBig;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, sm_m[w * G + g]);
  L = 0.f;
  A = 0.f;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) {
    const float e = __expf(sm_m[w * G + g] - M);
    L += sm_l[w * G + g] * e;
    A += sm_acc[((size_t)w * G + g) * D + d] * e;
  }
}

// lanes per row for head dim D: D/8 rounded up to a power of two (>= 2)
inline int decode_lpr(int D) {
  int lpr = 2;
  while (lpr * 8 < D) lpr <<= 1;
  return lpr;
}

}  // namespace dstorch
