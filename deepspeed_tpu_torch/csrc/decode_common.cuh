// Shared device code of the paged decode kernels (paged_decode.cu, and the
// split-K partials of paged_splitk.cu): one query token per sequence, one
// block of 128 threads (4 warps) per (sequence, piece of its visible range,
// kv head), on the tensor cores (sm_90a, bf16 products, f32 accumulate).
//
// decode_pages<DP, KV> walks page tokens [lo, hi) of one sequence and
// leaves each warp's online-softmax state in shared memory; decode_side
// adds the side rows c_lo <= cc < n_side of the sequence's slab as one more
// state; decode_merge merges the states in a fixed order into the block's
// (m, l, acc) per query head. The caller's epilogue normalises it (K7) or
// merges the blocks of a cluster first (the decode kernel). The caller cuts
// the range: a sliding window sets lo, and tokens outside [lo, hi) are
// neither read nor computed.
//
// Products: the S^T = K . Q^T layout. The G <= 8 query heads of a kv head
// are the n = 8 columns of an m16n8k16 product whose 16 rows are tokens, so
// no row of a tile is padding: S^T [16 tokens x 8 heads] takes DP / 16
// products with K's rows as the A operand (ldmatrix) and Q^T as B (held in
// registers for the whole walk). Online softmax runs per column (a head)
// on the accumulator fragments; the probabilities, rounded to bf16 and
// transposed by movmatrix, are the B operand of O^T += V^T . P^T, whose A
// operand is V's rows read transposed (ldmatrix.trans). O^T [DP x 8] lives
// in DP / 4 registers a thread. Scores are kept in log2 units (the softmax
// scale times log2 e); lse = (m + log2 l) ln 2.
//
// Memory: the walk is bound by bytes (each visible token's K and V row is
// read once; ~1 flop a byte). The sequence's block-table slice is staged in
// shared memory before the loop, so no load in the loop waits on another.
// Tokens stream through a ring of kDecStages = 3 stages of kDecChunk = 64
// tokens (K and V tiles, swizzled as mma_common.cuh's tiles): each thread
// issues 16-byte cp.async copies of the rows of stage i + 2 while the warps
// compute stage i, one barrier a stage (a 5-stage ring over int8 pages
// measured slower: it costs a resident block an SM). Warp w takes rows
// [16w, 16w + 16) of a stage. Rows past hi are zero-filled, never copied,
// and masked.
//
// int8 pages (KV = int8_t, with f32 scale tiles [NB, R8, 128], flat index
// kv*Hkv*bs + h*bs + t per page): the stage holds the int8 rows and each
// token's K and V scale; each warp converts its 16 K rows to bf16 (exact
// for |b| <= 127) into its own scratch tile for S^T, then its V rows into
// the same tile for O^T (one tile, not two, keeps three blocks an SM at D =
// 128), and runs the same products. The K
// scale multiplies the token's f32 score, the V scale its p before p is
// rounded to bf16 (the fold of the JAX package's _colscale_pages); l sums
// the unscaled p.
//
// Side rows (decode_side) run on the CUDA cores in f32: SIDE is bf16 for a
// bf16 pool and f32 for an int8 one (kv_write_dequant values, which a bf16
// copy would round away from what the pages store). Warp w takes query
// heads w and w + 4; a lane holds dims lane + 32i.
//
// ALiBi (slopes != null): the score of query head g for a key at absolute
// position pos gets slopes[hk * G + g] * pos added after the scale (and the
// K scale), before the running max: pos = t for page token t, side_pos0 +
// cc for side row cc.
#pragma once

#include <cooperative_groups.h>

#include "attn_common.cuh"
#include "mma_common.cuh"

namespace dstorch {

// The kernels declare __launch_bounds__(kDecThreads, 1): without a minimum
// of blocks an SM, ptxas spilled a few bytes at 56-168 registers.
constexpr int kDecWarps = 4;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecWarpRows = 16;                      // tokens a warp takes of a stage
constexpr int kDecChunk = kDecWarps * kDecWarpRows;   // tokens a stage
constexpr int kDecStages = 3;                         // two in flight, one computed
constexpr int kDecHeads = 8;                          // the product's n: G <= 8
constexpr int kDecSlots = kDecWarps + 1;              // the warps' states + the side rows'
constexpr float kDecLog2e = 1.4426950408889634f;
constexpr float kDecLn2 = 0.6931471805599453f;

struct DecodePage {
  const void* kv;      // [NB, 2, Hkv, bs, D] of KV
  const float* sc;     // [NB, R8, 128] scale tiles (int8 pages) or null
  int r8;              // scale-tile rows per page
  const int* btr;      // this sequence's block-table row
  int Hkv, bs, D;
};

// the padded head dim the kernels are built for: D (any multiple of 8 up to
// 256) rounded up to one of 16, 32, 64, 80, 96, 128, 256; dims past D are
// zero-filled in the tiles and in Q
inline int decode_dp(int D) {
  const int dims[] = {16, 32, 64, 80, 96, 128, 256};
  for (int dp : dims)
    if (D <= dp) return dp;
  return -1;
}

// Piece `p` of `n` of the range [lo, hi): [lo + p c, min(lo + (p + 1) c, hi))
// with c = ceil((hi - lo) / n); empty when the range is.
__device__ __forceinline__ void decode_piece(int lo, int hi, int n, int p, int& b_lo,
                                             int& b_hi) {
  const int len = max(hi - lo, 0);
  const int c = (len + n - 1) / n;
  b_lo = min(lo + p * c, lo + len);
  b_hi = min(b_lo + c, lo + len);
}

// block-table entries a block stages for a piece of at most `tokens` tokens
__host__ __device__ inline int decode_table_cap(int MB, int tokens, int bs) {
  return tokens / bs + 2 < MB ? tokens / bs + 2 : MB;
}

// Shared memory of one block: the block-table slice, then the body: the
// ring (and the int8 scratch tiles) during the walk, the states after it.
template <int DP, typename KV>
struct DecodeSmem {
  static constexpr bool kI8 = std::is_same<KV, int8_t>::value;
  static constexpr int kTile = kDecChunk * DP * (int)sizeof(KV);
  static constexpr int kStage = 2 * kTile + (kI8 ? 2 * kDecChunk * 4 : 0);
  // int8: each warp's 16 rows in bf16, K's and then V's
  static constexpr int kScratch = kI8 ? kDecWarps * kDecWarpRows * DP * 2 : 0;
  static constexpr int kLoop = kDecStages * kStage + kScratch;
  // st_acc [slots][8][DP], st_m, st_l [slots][8]; fin_acc [8][DP], fin_m, fin_l [8]
  static constexpr int kStates = ((kDecSlots + 1) * kDecHeads * DP
                                  + 2 * (kDecSlots + 1) * kDecHeads) * 4;
  static constexpr int kBody = kLoop > kStates ? kLoop : kStates;
  __host__ __device__ static int table_bytes(int cap) { return (cap * 4 + 127) / 128 * 128; }
  __host__ __device__ static size_t bytes(int cap) { return (size_t)table_bytes(cap) + kBody; }
};

template <int DP>
struct DecodeStates {
  float *st_acc, *st_m, *st_l, *fin_acc, *fin_m, *fin_l;
  __device__ explicit DecodeStates(char* body) {
    st_acc = reinterpret_cast<float*>(body);
    st_m = st_acc + kDecSlots * kDecHeads * DP;
    st_l = st_m + kDecSlots * kDecHeads;
    fin_acc = st_l + kDecSlots * kDecHeads;
    fin_m = fin_acc + kDecHeads * DP;
    fin_l = fin_m + kDecHeads;
  }
};

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// A fragment of V^T: dims [16 mt, 16 mt + 16) x tokens [r0, r0 + 16) of a
// [rows][DP] tile of V rows
template <int DP>
__device__ __forceinline__ void ldsm_vt(uint32_t (&a)[4], const bf16* tile, int r0, int mt,
                                        int lane) {
  mma::ldsm_x4_trans(a, tile + mma::swz<DP>(r0 + (lane & 7) + ((lane >> 4) << 3),
                                            2 * mt + ((lane >> 3) & 1)));
}

// bytes 2 HALF and 2 HALF + 1 of `u` (int8 values + 128, as unsigned) as a
// bf16 pair, low half first: through f32 2^23 + (b + 128); exact
template <int HALF>
__device__ __forceinline__ uint32_t dec_i8x2_to_bf16x2(uint32_t u) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + 2 * HALF));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + 2 * HALF));
  return mma::pack_bf16(f0 - 8388736.f, f1 - 8388736.f);
}

// 16 int8 values -> 16 bf16 (two 16-byte chunks)
__device__ __forceinline__ void dec_i8x16_to_bf16(const uint4& u, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                         u.w ^ 0x80808080u};
  lo = make_uint4(dec_i8x2_to_bf16x2<0>(w[0]), dec_i8x2_to_bf16x2<1>(w[0]),
                  dec_i8x2_to_bf16x2<0>(w[1]), dec_i8x2_to_bf16x2<1>(w[1]));
  hi = make_uint4(dec_i8x2_to_bf16x2<0>(w[2]), dec_i8x2_to_bf16x2<1>(w[2]),
                  dec_i8x2_to_bf16x2<0>(w[3]), dec_i8x2_to_bf16x2<1>(w[3]));
}

// t / bs for 0 <= t < 2^22 from a float estimate (within one of the
// quotient), corrected: no integer division in the copy loop
__device__ __forceinline__ int dec_page_of(int t, int bs, float inv_bs) {
  int pi = __float2int_rz(__int2float_rn(t) * inv_bs);
  pi += (pi + 1) * bs <= t;
  pi -= pi * bs > t;
  return pi;
}

// Copy tokens [t0, t0 + kDecChunk) ∩ [.., hi) of kv head hk into a stage:
// K and V rows as swizzled tiles (int8: plain rows), and for int8 pages
// each token's K and V scale. Thread tid owns 16-byte chunk tid % CPRP of
// rows tid / CPRP + k RPP (CPRP = chunks a row, rounded up to a power of
// two).
template <int DP, typename KV>
__device__ __forceinline__ void decode_issue(char* stage, const DecodePage& pg, int hk,
                                             const int* tbl, int p0, int t0, int hi,
                                             float inv_bs) {
  constexpr bool I8 = std::is_same<KV, int8_t>::value;
  constexpr int EPC = 16 / (int)sizeof(KV);          // elements a chunk
  constexpr int CPR = DP / EPC;                      // chunks a row
  constexpr int CPRP = CPR <= 2 ? 2 : CPR <= 4 ? 4 : CPR <= 8 ? 8 : CPR <= 16 ? 16 : 32;
  constexpr int RPP = kDecThreads / CPRP;            // rows a pass
  const int tid = threadIdx.x;
  const int c = tid % CPRP, r_first = tid / CPRP;
  const int D = pg.D, Hkv = pg.Hkv, bs = pg.bs;
  const KV* kv = static_cast<const KV*>(pg.kv);
  const size_t page_elems = (size_t)2 * Hkv * bs * D;
  const size_t koff = (size_t)hk * bs * D + c * EPC;
  const size_t voff = (size_t)(Hkv + hk) * bs * D + c * EPC;
  KV* ktile = reinterpret_cast<KV*>(stage);
  KV* vtile = ktile + kDecChunk * DP;
  const bool col_ok = c < CPR && c * EPC < D;
  if (c < CPR) {
#pragma unroll
    for (int k = 0; k < kDecChunk / RPP; ++k) {
      const int r = r_first + k * RPP;
      const int t = t0 + r;
      const bool ok = t < hi && col_ok;
      const KV* ksrc = kv;
      const KV* vsrc = kv;
      if (ok) {
        const int pi = dec_page_of(t, bs, inv_bs);
        const size_t row = (size_t)tbl[pi - p0] * page_elems + (size_t)(t - pi * bs) * D;
        ksrc = kv + row + koff;
        vsrc = kv + row + voff;
      }
      int dst;
      if constexpr (I8) {
        dst = r * DP + c * EPC;
      } else {
        dst = mma::swz<DP>(r, c);
      }
      mma::cp_async16(ktile + dst, ksrc, ok);
      mma::cp_async16(vtile + dst, vsrc, ok);
    }
  }
  if constexpr (I8) {
    // thread r < 64: K scale of row r; 64 <= r < 128: V scale of row r - 64
    float* scales = reinterpret_cast<float*>(stage + 2 * kDecChunk * DP);
    const int r = tid % kDecChunk, is_v = tid / kDecChunk;
    const int tt = t0 + r;
    const bool ok = tt < hi;
    const float* src = pg.sc;
    if (ok) {
      const int pj = dec_page_of(tt, bs, inv_bs);
      src = pg.sc + (size_t)tbl[pj - p0] * pg.r8 * 128 + (size_t)(is_v * Hkv + hk) * bs
            + (tt - pj * bs);
    }
    mma::cp_async4(scales + tid, src, ok);
  }
}

// One warp's 16 tokens [tok0, tok0 + 16) (rows [r0, r0 + 16) of the K and V
// tiles; ks/vs their scales, int8 pages only) into its state; fill_v() runs
// after the K rows are read and before the V rows are.
template <int DP, bool I8, typename FillV>
__device__ __forceinline__ void decode_step(const bf16* ktile, const bf16* vtile, int r0,
                                            const float* ks, const float* vs, int tok0,
                                            int hi, const uint32_t (&qb)[DP / 16][2],
                                            float scale_log2, const float (&sl)[2],
                                            float (&m)[2], float (&l)[2],
                                            float (&o)[DP / 16][4], int lane, FillV fill_v) {
  const int g = lane >> 2;
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    uint32_t a[4];
    mma::ldsm_a<DP>(a, ktile, r0, kc, lane);
    if (kc & 1)
      mma::mma16816(s1, a, qb[kc][0], qb[kc][1]);
    else
      mma::mma16816(s0, a, qb[kc][0], qb[kc][1]);
  }
  // thread (g, t): tokens tok0 + g (x[0], x[1]) and tok0 + g + 8 (x[2],
  // x[3]) for heads 2t (x[0], x[2]) and 2t + 1 (x[1], x[3])
  const int ta = tok0 + g, tb = ta + 8;
  const bool va = ta < hi, vb = tb < hi;
  float ca = scale_log2, cb = scale_log2;
  if constexpr (I8) {
    ca *= ks[r0 + g];
    cb *= ks[r0 + g + 8];
  }
  float x[4];
  x[0] = va ? fmaf(s0[0] + s1[0], ca, sl[0] * (float)ta) : -INFINITY;
  x[1] = va ? fmaf(s0[1] + s1[1], ca, sl[1] * (float)ta) : -INFINITY;
  x[2] = vb ? fmaf(s0[2] + s1[2], cb, sl[0] * (float)tb) : -INFINITY;
  x[3] = vb ? fmaf(s0[3] + s1[3], cb, sl[1] * (float)tb) : -INFINITY;
  float mx[2] = {fmaxf(x[0], x[2]), fmaxf(x[1], x[3])};
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
    mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
  }
  float alpha[2], base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], mx[i]);
    base[i] = mn == -INFINITY ? 0.f : mn;
    alpha[i] = mma::exp2_approx(m[i] - base[i]);
    m[i] = mn;
  }
  float p[4];
  p[0] = mma::exp2_approx(x[0] - base[0]);
  p[1] = mma::exp2_approx(x[1] - base[1]);
  p[2] = mma::exp2_approx(x[2] - base[0]);
  p[3] = mma::exp2_approx(x[3] - base[1]);
  l[0] = l[0] * alpha[0] + (p[0] + p[2]);
  l[1] = l[1] * alpha[1] + (p[1] + p[3]);
  if constexpr (I8) {
    const float va_s = vs[r0 + g], vb_s = vs[r0 + g + 8];
    p[0] *= va_s;
    p[1] *= va_s;
    p[2] *= vb_s;
    p[3] *= vb_s;
  }
  // P^T's B fragments: tokens 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of head g
  const uint32_t b0 = movmatrix_trans(mma::pack_bf16(p[0], p[1]));
  const uint32_t b1 = movmatrix_trans(mma::pack_bf16(p[2], p[3]));
  fill_v();
#pragma unroll
  for (int mt = 0; mt < DP / 16; ++mt) {
    o[mt][0] *= alpha[0];
    o[mt][1] *= alpha[1];
    o[mt][2] *= alpha[0];
    o[mt][3] *= alpha[1];
    uint32_t a[4];
    ldsm_vt<DP>(a, vtile, r0, mt, lane);
    mma::mma16816(o[mt], a, b0, b1);
  }
}

// Page tokens [lo, hi) of kv head hk (qrow: its G query heads [G, D] bf16;
// slopes [H] or null), each warp's state into slot `warp` of the body.
// Every thread of the block calls it; tbl_cap >= the pages [lo, hi) spans.
template <int DP, typename KV>
__device__ __forceinline__ void decode_pages(const bf16* __restrict__ qrow, int G,
                                             const DecodePage& pg, int hk, int lo, int hi,
                                             float scale_log2,
                                             const float* __restrict__ slopes, char* smem,
                                             int tbl_cap) {
  using L = DecodeSmem<DP, KV>;
  constexpr bool I8 = L::kI8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int D = pg.D, bs = pg.bs;
  int* tbl = reinterpret_cast<int*>(smem);
  char* body = smem + L::table_bytes(tbl_cap);

  const int n = max(hi - lo, 0);
  const int p0 = lo / bs;
  const int n_pages = n > 0 ? min((hi - 1) / bs - p0 + 1, tbl_cap) : 0;
  hi = n > 0 ? min(hi, (p0 + n_pages) * bs) : lo;
  for (int i = tid; i < n_pages; i += kDecThreads) tbl[i] = __ldg(pg.btr + p0 + i);

  // Q^T's B fragments: head g, dims 16 kc + 2t (+1) and 16 kc + 2t + 8 (+9)
  uint32_t qb[DP / 16][2];
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * kc + 2 * t + 8 * h;
      qb[kc][h] = g < G && d < D
                      ? *reinterpret_cast<const uint32_t*>(qrow + (size_t)g * D + d)
                      : 0u;
    }
  float sl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    sl[i] = slopes != nullptr && 2 * t + i < G ? __ldg(slopes + hk * G + 2 * t + i) * kDecLog2e
                                               : 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DP / 16][4];
  mma::zero(o);
  __syncthreads();   // the table slice

  const int n_stages = (hi - lo + kDecChunk - 1) / kDecChunk;
  const float inv_bs = 1.f / (float)bs;
#pragma unroll
  for (int st = 0; st < kDecStages - 1; ++st) {
    if (st < n_stages)
      decode_issue<DP, KV>(body + st * L::kStage, pg, hk, tbl, p0, lo + st * kDecChunk, hi,
                           inv_bs);
    mma::cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    mma::cp_async_wait<kDecStages - 2>();
    __syncthreads();
    const int nx = i + kDecStages - 1;
    if (nx < n_stages)
      decode_issue<DP, KV>(body + (nx % kDecStages) * L::kStage, pg, hk, tbl, p0,
                           lo + nx * kDecChunk, hi, inv_bs);
    mma::cp_async_commit();
    char* stage = body + (i % kDecStages) * L::kStage;
    const int tok0 = lo + i * kDecChunk + warp * kDecWarpRows;
    if constexpr (I8) {
      // this warp's 16 int8 K rows, then V rows -> bf16 in its scratch tile
      const int8_t* k8 = reinterpret_cast<const int8_t*>(stage) + warp * kDecWarpRows * DP;
      const int8_t* v8 = k8 + kDecChunk * DP;
      bf16* tile = reinterpret_cast<bf16*>(body + kDecStages * L::kStage)
                   + warp * kDecWarpRows * DP;
      auto convert = [&](const int8_t* rows) {
        constexpr int CPR8 = DP / 16;
        __syncwarp();
#pragma unroll
        for (int k = lane; k < kDecWarpRows * CPR8; k += 32) {
          const int r = k / CPR8, c = k % CPR8;
          uint4 lo8, hi8;
          dec_i8x16_to_bf16(*reinterpret_cast<const uint4*>(rows + r * DP + c * 16), lo8,
                            hi8);
          *reinterpret_cast<uint4*>(tile + mma::swz<DP>(r, 2 * c)) = lo8;
          *reinterpret_cast<uint4*>(tile + mma::swz<DP>(r, 2 * c + 1)) = hi8;
        }
        __syncwarp();
      };
      convert(k8);
      const float* scales = reinterpret_cast<const float*>(stage + 2 * kDecChunk * DP);
      decode_step<DP, true>(tile, tile, 0, scales + warp * kDecWarpRows,
                            scales + kDecChunk + warp * kDecWarpRows, tok0, hi, qb,
                            scale_log2, sl, m, l, o, lane, [&] { convert(v8); });
    } else {
      const bf16* ktile = reinterpret_cast<const bf16*>(stage);
      decode_step<DP, false>(ktile, ktile + kDecChunk * DP, warp * kDecWarpRows, nullptr,
                             nullptr, tok0, hi, qb, scale_log2, sl, m, l, o, lane, [] {});
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();   // the ring is free: the states take its place

  // this warp's state: l summed over the 8 lanes of a column
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
  }
  DecodeStates<DP> sts(body);
  float* acc = sts.st_acc + (size_t)warp * kDecHeads * DP;
#pragma unroll
  for (int mt = 0; mt < DP / 16; ++mt) {
    const int d = 16 * mt + g;
    acc[(2 * t) * DP + d] = o[mt][0];
    acc[(2 * t + 1) * DP + d] = o[mt][1];
    acc[(2 * t) * DP + d + 8] = o[mt][2];
    acc[(2 * t + 1) * DP + d + 8] = o[mt][3];
  }
  if (g == 0) {
    sts.st_m[warp * kDecHeads + 2 * t] = m[0];
    sts.st_m[warp * kDecHeads + 2 * t + 1] = m[1];
    sts.st_l[warp * kDecHeads + 2 * t] = l[0];
    sts.st_l[warp * kDecHeads + 2 * t + 1] = l[1];
  }
}

__device__ __forceinline__ float dec_float(float x) { return x; }
__device__ __forceinline__ float dec_float(bf16 x) { return __bfloat162float(x); }

// Side rows c_lo <= cc < n_side (row cc * Hkv + hk of the sequence's slab
// side_k/side_v [C * Hkv, D]) at positions side_pos0 + cc, in f32, into
// state slot kDecWarps. Call after decode_pages, before decode_merge.
template <int DP, typename SIDE>
__device__ __forceinline__ void decode_side(const bf16* __restrict__ qrow, int G, int D,
                                            const SIDE* __restrict__ side_k,
                                            const SIDE* __restrict__ side_v, int Hkv,
                                            int hk, int c_lo, int n_side, int side_pos0,
                                            float scale_log2,
                                            const float* __restrict__ slopes, char* body) {
  constexpr int NI = (DP + 31) / 32;   // dims a lane
  constexpr int RB = 8;                // side rows a batch
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  DecodeStates<DP> sts(body);
  for (int h = warp; h < kDecHeads; h += kDecWarps) {
    float qv[NI], acc[NI];
    const bool hv = h < G;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      qv[i] = hv && d < D ? __bfloat162float(qrow[(size_t)h * D + d]) : 0.f;
      acc[i] = 0.f;
    }
    const float sl = hv && slopes != nullptr ? __ldg(slopes + hk * G + h) * kDecLog2e : 0.f;
    float m = -INFINITY, l = 0.f;
    for (int c0 = hv ? c_lo : n_side; c0 < n_side; c0 += RB) {
      float kx[RB][NI], vx[RB][NI], sc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const bool ok = c0 + r < n_side;
        const size_t row = ((size_t)(c0 + r) * Hkv + hk) * D;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d = lane + 32 * i;
          const bool in = ok && d < D;
          kx[r][i] = in ? dec_float(side_k[row + d]) : 0.f;
          vx[r][i] = in ? dec_float(side_v[row + d]) : 0.f;
        }
        sc[r] = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) sc[r] = fmaf(qv[i], kx[r][i], sc[r]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < RB; ++r) sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
      float x[RB], mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        x[r] = c0 + r < n_side ? fmaf(sc[r], scale_log2, sl * (float)(side_pos0 + c0 + r))
                               : -INFINITY;
        mx = fmaxf(mx, x[r]);
      }
      const float mn = fmaxf(m, mx);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float alpha = mma::exp2_approx(m - base);
      m = mn;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[i] *= alpha;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float p = mma::exp2_approx(x[r] - base);
        l += p;
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[i] = fmaf(p, vx[r][i], acc[i]);
      }
    }
    float* out = sts.st_acc + ((size_t)kDecWarps * kDecHeads + h) * DP;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = lane + 32 * i;
      if (d < DP) out[d] = acc[i];
    }
    if (lane == 0) {
      sts.st_m[kDecWarps * kDecHeads + h] = m;
      sts.st_l[kDecWarps * kDecHeads + h] = l;
    }
  }
}

// Merge state slots [0, n_slots) in order into fin (per head h < 8 and dim
// d < DP: fin_acc = sum_s w_s acc_s, fin_l = sum_s w_s l_s, fin_m = max_s
// m_s, w_s = 2^(m_s - fin_m), 0 for an empty slot). Ends on a barrier.
template <int DP>
__device__ __forceinline__ void decode_merge(char* body, int n_slots) {
  __syncthreads();
  DecodeStates<DP> sts(body);
  for (int idx = threadIdx.x; idx < kDecHeads * DP; idx += kDecThreads) {
    const int h = idx / DP, d = idx - (idx / DP) * DP;
    float M = -INFINITY;
    for (int s = 0; s < n_slots; ++s) M = fmaxf(M, sts.st_m[s * kDecHeads + h]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_slots; ++s) {
      const float ls = sts.st_l[s * kDecHeads + h];
      const float w = ls > 0.f ? mma::exp2_approx(sts.st_m[s * kDecHeads + h] - M) : 0.f;
      L = fmaf(ls, w, L);
      A = fmaf(sts.st_acc[((size_t)s * kDecHeads + h) * DP + d], w, A);
    }
    sts.fin_acc[idx] = A;
    if (d == 0) {
      sts.fin_m[h] = M;
      sts.fin_l[h] = L;
    }
  }
  __syncthreads();
}

// The visible range of sequence s's query: page tokens [lo, len) and side
// rows cc >= c_lo (window > 0: the sliding window; with side rows the query
// sits at len + j)
__device__ __forceinline__ void decode_visible(int len, bool side, int j, int window,
                                               int& lo, int& c_lo) {
  lo = 0;
  c_lo = 0;
  if (window > 0) {
    lo = max(side ? len + j + 1 - window : len - window, 0);
    c_lo = max(j + 1 - window, 0);
  }
}

}  // namespace dstorch
