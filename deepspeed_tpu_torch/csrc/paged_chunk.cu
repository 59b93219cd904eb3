// Batched prompt-chunk attention over paged KV, bf16, sm_90a, on the
// tensor cores.
//
// Replaces deepspeed_tpu/ops/pallas/paged_attention.py:1534
// paged_chunk_attention_batched (kernel body _chunk_kernel_batched, :1443):
// several prompt chunks per launch, each slot with its own block-table row,
// q_start and ctx; query row r of slot sl sits at position q_start + r and
// sees keys k_pos <= q_pos with k_pos < ctx. An empty slot (ctx 0) gives
// zeros. Pages are [NB, 2, Hkv, bs, D] (K = 0, V = 1), one layer's view.
//
// Sliding window (window > 0; the Pallas kernel's window, :1466-1478):
// keys also need k_pos > q_pos - window. Masking is by logical position, so
// block tables that repeat physical pages (the scheduler's page ring) read
// the right tokens. window = 0 is the unwindowed kernel.
//
// ALiBi (slopes != null; the Pallas kernel's alibi, :1493-1498): each
// visible score of q-head h (kv head * G + g) gets slopes[h] * k_pos, the
// key's absolute position, added in f32 after the scale and before the
// running max. Masked keys are never biased.
//
// int8 pages (the kv_quant pool; replaces _chunk_kernel_batched_quant,
// :1528): int8 pages and their f32 scale tiles [NB, R8, 128] (flat index
// kv*Hkv*bs + h*bs + t per page). Each key's K scale multiplies its score
// column and its V scale its p column (_chunk_head_scale, :1422), in f32;
// l sums the unscaled p. The window and ALiBi branches are the bf16 ones.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the continuation
// shapes of Llama-2-7B (6 slots x 128 rows, 32 heads, D = 128, ctx
// 2048/1536/1000/300/128/0) the pages read once are 82 MB and q/out 13 MB
// (28 us), against ~10 GFLOP of 4*D flops per visible (row, head, key)
// (10 us): bytes. Long windowed chunks (Mistral-7B's 64 slots of 128 rows
// over a 4096-token window) are bound by operations.
//
// Design (K2's structure, flash_packed.cu, on mma_common.cuh): one block
// of 4 warps per (q-tile, kv head, slot). The block's 64 mma M rows are 64
// consecutive (row, head) pairs of the slot, pair i = r * G + g (row r,
// query head hk * G + g), so every K and V tile a block reads serves all G
// query heads of its kv head; each warp owns 16 pairs. Q's rows are
// gathered by cp.async into a swizzled tile and held in A fragments (read
// from shared memory each tile at D = 256). S = Q.K^T on mma.sync m16n8k16
// in f32, scaled into log2 units with the ALiBi bias and, over int8 pages,
// the K scale folded in; online softmax on the fragments; P packed to bf16
// in registers as the A operand of O += P.V (ldmatrix.trans).
// K and V come in the decode walk's way (decode_common.cuh): the slot's
// block-table slice for the block's key range is staged in shared memory
// (decode_table_cap entries under a window), and each key row is one or
// more 16-byte cp.async copies from its own page address, so a tile may
// straddle pages at any bs; keys past the range are zero-filled, never
// copied. Tiles of 64 keys (16 at D = 256) go through a 3-stage ring, one
// barrier a tile (two over int8 pages).
// The block's key range is [k_lo, k_hi): k_hi = min(ctx, last row's
// position + 1), k_lo = its first row's window start (0 without a window),
// so key tiles that no row of the q-tile sees are not loaded, nor their
// pages' scales. Each warp also skips the tiles above its own rows'
// diagonal and below its own window start, and masks only edge tiles (the
// diagonal, the window's edge, ctx): there a hidden score is -inf and its p
// exactly 0, and the zero-filled K/V rows keep that p from meeting NaN.
// Over int8 pages the ring holds the bytes and each key's scales; after a
// tile arrives the whole block converts it once to bf16 (exact, through
// dec_i8x16_to_bf16) into one shared K and V tile for all its warps and G
// heads. Q-tiles are issued last-first within a (kv head, slot), so the
// longest ones start first. No atomics: reruns give the same bits.
//
// Head dims: bf16 pages D 16, 32, 64, 80, 96, 128 and 256 (80 and 96
// through mma_common's in-row swizzles); int8 pages 128 and 256.
#include "decode_common.cuh"

namespace dstorch {

constexpr int kChWarps = 4;
constexpr int kChRows = 16 * kChWarps;   // (row, head) pairs a block: the mma M rows
constexpr int kChThreads = 32 * kChWarps;

// keys a tile: 16 at D = 256, where the f32 O accumulator alone takes 128
// registers a thread (tiles of 32 spilled 40 bytes under ALiBi on the H100)
template <int D>
constexpr int kChBK = D > 128 ? 16 : 64;
// ring stages: tiles j + 1 .. j + kChStages - 1 are in flight while tile j
// is computed
constexpr int kChStages = 3;

// block-table entries a block stages: its key range spans at most window +
// kChRows - 1 keys under a window, every page of the row without one
__host__ __device__ inline int chunk_table_cap(int MB, int bs, int window) {
  return window > 0 ? decode_table_cap(MB, window + kChRows, bs) : MB;
}

// Shared memory of one block: the table slice; the Q tile; the ring's
// stages (bf16: the K and V tiles; int8: the K and V bytes, then the keys'
// K and V scales); over int8 pages the converted bf16 K and V tiles and a
// copy of the scales, which the warps read while the ring refills.
template <int D, bool I8>
struct ChunkSmem {
  static constexpr int BK = kChBK<D>;
  static constexpr int kQ = kChRows * D * 2;
  static constexpr int kTile = BK * D * 2;   // one bf16 K or V tile
  static constexpr int kStage = I8 ? 2 * BK * D + 2 * BK * 4 : 2 * kTile;
  static constexpr int kConv = I8 ? 2 * kTile + 2 * BK * 4 : 0;
  static constexpr int kBody = kQ + kChStages * kStage + kConv;
  __host__ __device__ static int table_bytes(int cap) { return (cap * 4 + 127) / 128 * 128; }
  __host__ __device__ static size_t bytes(int cap) { return (size_t)table_bytes(cap) + kBody; }
};

// Copy keys [k0, k0 + BK) ∩ [.., k_hi) of kv head hk into a ring stage:
// bf16 rows as swizzled tiles, int8 rows as plain rows plus each key's K
// and V scale. Thread tid owns 16-byte chunk tid % CPRP of rows tid / CPRP
// + k RPP (CPRP = chunks a row, rounded up to a power of two).
template <int D, typename KV>
__device__ __forceinline__ void chunk_issue(char* stage, const KV* __restrict__ kv,
                                            const float* __restrict__ sc, int r8,
                                            const int* tbl, int p0, int k0, int k_hi, int hk,
                                            int Hkv, int bs, float inv_bs) {
  constexpr bool I8 = std::is_same<KV, int8_t>::value;
  constexpr int BK = kChBK<D>;
  constexpr int EPC = 16 / (int)sizeof(KV);   // elements a chunk
  constexpr int CPR = D / EPC;                // chunks a row
  constexpr int CPRP = CPR <= 2 ? 2 : CPR <= 4 ? 4 : CPR <= 8 ? 8 : CPR <= 16 ? 16 : 32;
  constexpr int RPP = kChThreads / CPRP;      // rows a pass
  static_assert(BK % RPP == 0, "a pass of rows must divide the tile");
  const int tid = threadIdx.x;
  const int c = tid % CPRP, r_first = tid / CPRP;
  const size_t page_elems = (size_t)2 * Hkv * bs * D;
  const size_t koff = (size_t)hk * bs * D + c * EPC;
  const size_t voff = (size_t)(Hkv + hk) * bs * D + c * EPC;
  KV* ktile = reinterpret_cast<KV*>(stage);
  KV* vtile = ktile + BK * D;
  if (c < CPR) {
#pragma unroll
    for (int k = 0; k < BK / RPP; ++k) {
      const int r = r_first + k * RPP;
      const int key = k0 + r;
      const bool ok = key < k_hi;
      const KV* ksrc = kv;
      const KV* vsrc = kv;
      if (ok) {
        const int pi = dec_page_of(key, bs, inv_bs);
        const size_t row = (size_t)tbl[pi - p0] * page_elems + (size_t)(key - pi * bs) * D;
        ksrc = kv + row + koff;
        vsrc = kv + row + voff;
      }
      int dst;
      if constexpr (I8) {
        dst = r * D + c * EPC;
      } else {
        dst = mma::swz<D>(r, c);
      }
      mma::cp_async16(ktile + dst, ksrc, ok);
      mma::cp_async16(vtile + dst, vsrc, ok);
    }
  }
  if constexpr (I8) {
    // thread r < BK: K scale of key k0 + r; BK <= r < 2 BK: V scale of key k0 + r - BK
    float* scales = reinterpret_cast<float*>(stage + 2 * BK * D);
    if (tid < 2 * BK) {
      const int r = tid % BK, is_v = tid / BK;
      const int key = k0 + r;
      const bool ok = key < k_hi;
      const float* src = sc;
      if (ok) {
        const int pi = dec_page_of(key, bs, inv_bs);
        src = sc + (size_t)tbl[pi - p0] * r8 * 128 + (size_t)(is_v * Hkv + hk) * bs
              + (key - pi * bs);
      }
      mma::cp_async4(scales + tid, src, ok);
    }
  }
}

// The whole block converts an int8 stage (K and V bytes, their scales) to
// the bf16 K and V tiles and the scale copy `conv`.
template <int D>
__device__ __forceinline__ void chunk_convert(const char* stage, char* conv) {
  constexpr int BK = kChBK<D>, CPR8 = D / 16;
  const int tid = threadIdx.x;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    const int8_t* raw = reinterpret_cast<const int8_t*>(stage) + kv * BK * D;
    bf16* tile = reinterpret_cast<bf16*>(conv) + kv * BK * D;
#pragma unroll
    for (int k = tid; k < BK * CPR8; k += kChThreads) {
      const int r = k / CPR8, c = k % CPR8;
      uint4 lo, hi;
      dec_i8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + r * D + c * 16), lo, hi);
      *reinterpret_cast<uint4*>(tile + mma::swz<D>(r, 2 * c)) = lo;
      *reinterpret_cast<uint4*>(tile + mma::swz<D>(r, 2 * c + 1)) = hi;
    }
  }
  if (tid < 2 * BK)
    reinterpret_cast<float*>(conv + 2 * BK * D * 2)[tid] =
        reinterpret_cast<const float*>(stage + 2 * BK * D)[tid];
}

// KV = bf16 (pages) or int8_t (pages + scale tiles `sc`, R8 rows per page);
// ALIBI reads the q heads' slopes [H]. grid (q-tiles, Hkv, NC).
template <int D, typename KV, bool ALIBI>
__global__ void __launch_bounds__(kChThreads, 1)
paged_chunk_kernel(const bf16* __restrict__ q, const KV* __restrict__ kv,
                   const float* __restrict__ sc, int r8, const int* __restrict__ bt,
                   const int* __restrict__ q_starts, const int* __restrict__ ctx_lens,
                   const float* __restrict__ slopes, bf16* __restrict__ out, int Cs,
                   int H, int Hkv, int bs, int MB, int window, float scale, int tbl_cap) {
  constexpr bool I8 = std::is_same<KV, int8_t>::value;
  using L = ChunkSmem<D, I8>;
  constexpr int BK = L::BK, NT = BK / 8, CQ = D / 8;
  constexpr bool kQRegs = D <= 128;
  extern __shared__ __align__(128) char smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::table_bytes(tbl_cap));
  char* ring = reinterpret_cast<char*>(Qs) + L::kQ;
  char* conv = ring + kChStages * L::kStage;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = H / Hkv, hk = blockIdx.y, sl = blockIdx.z;
  const int n_pairs = Cs * G;
  const int i0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kChRows;
  const int q0 = __ldg(q_starts + sl), ctx = __ldg(ctx_lens + sl);
  const int r_first = i0 / G, r_last = (min(i0 + kChRows, n_pairs) - 1) / G;
  const int k_lo = window > 0 ? max(0, q0 + r_first - window + 1) : 0;
  int k_hi = min(ctx, q0 + r_last + 1);
  const size_t row0 = (size_t)sl * Cs;

  // Q: pair i0 + m is row (i0 + m) / G, head hk * G + (i0 + m) % G
  for (int idx = tid; idx < kChRows * CQ; idx += kChThreads) {
    const int m = idx / CQ, c = idx - (idx / CQ) * CQ;
    const int i = i0 + m;
    const bool ok = i < n_pairs;
    const bf16* src = q;
    if (ok) {
      const int r = i / G;
      src = q + ((row0 + r) * H + hk * G + (i - r * G)) * D + c * 8;
    }
    mma::cp_async16(Qs + mma::swz<D>(m, c), src, ok);
  }
  mma::cp_async_commit();

  const int p0 = k_lo / bs;
  const int n_pages = k_hi > k_lo ? min((k_hi - 1) / bs - p0 + 1, tbl_cap) : 0;
  k_hi = k_hi > k_lo ? min(k_hi, (p0 + n_pages) * bs) : k_lo;
  for (int i = tid; i < n_pages; i += kChThreads) tbl[i] = __ldg(bt + (size_t)sl * MB + p0 + i);
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;
  const float inv_bs = 1.f / (float)bs;
  __syncthreads();   // the table slice
  auto issue = [&](int j) {
    chunk_issue<D, KV>(ring + (j % kChStages) * L::kStage, kv, sc, r8, tbl, p0, k_lo + j * BK,
                       k_hi, hk, Hkv, bs, inv_bs);
  };
#pragma unroll
  for (int j = 0; j < kChStages - 1; ++j) {
    if (j < n_tiles) issue(j);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<kChStages - 1>();
  __syncthreads();   // Q

  uint32_t qf[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) mma::ldsm_a<D>(qf[kc], Qs, 16 * warp, kc, lane);
  }
  // the warp's pairs and this thread's two rows (g, g + 8 of the warp's 16)
  const int wi0 = i0 + 16 * warp;
  const bool live = wi0 < n_pairs;
  const int w_qlo = q0 + wi0 / G;
  const int w_qhi = q0 + (min(wi0 + 16, n_pairs) - 1) / G;
  const float scale_log2 = scale * mma::kLog2e;
  int qpos[2];
  float slope[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = wi0 + g + 8 * e;
    const int r = i / G;
    qpos[e] = q0 + r;
    slope[e] = ALIBI && i < n_pairs ? __ldg(slopes + hk * G + (i - r * G)) * mma::kLog2e : 0.f;
  }

  float acc[D / 8][4];
  mma::zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_lo + j * BK;
    char* stage = ring + (j % kChStages) * L::kStage;
    mma::cp_async_wait<kChStages - 2>();
    __syncthreads();   // tile j is in; every warp is done with tile j - 1
    // the stage refilled held tile j - 1, computed (int8: converted) by now
    if (j + kChStages - 1 < n_tiles) issue(j + kChStages - 1);
    mma::cp_async_commit();
    const bf16* ktile;
    const float* kscale = nullptr;
    if constexpr (I8) {
      chunk_convert<D>(stage, conv);
      __syncthreads();   // the bf16 tiles
      ktile = reinterpret_cast<const bf16*>(conv);
      kscale = reinterpret_cast<const float*>(conv + 2 * L::kTile);
    } else {
      ktile = reinterpret_cast<const bf16*>(stage);
    }
    const bf16* vtile = ktile + BK * D;
    if (live && k0 <= w_qhi && !(window > 0 && k0 + BK - 1 <= w_qlo - window)) {
      float x[NT][4];
      mma::zero(x);
      if constexpr (kQRegs)
        mma::gemm_abt<D, NT>(x, qf, ktile, lane);
      else
        mma::gemm_abt<D, NT>(x, Qs, 16 * warp, ktile, lane);
      const bool edge = k0 + BK - 1 > w_qlo || k0 + BK > ctx ||
                        (window > 0 && k0 <= w_qhi - window);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1), key = k0 + col;
          float v = x[n][e] * (I8 ? scale_log2 * kscale[col] : scale_log2);
          if constexpr (ALIBI) v = fmaf(slope[e >> 1], (float)key, v);
          if (edge) {
            const int qp = qpos[e >> 1];
            if (!(key <= qp && key < ctx && (window <= 0 || qp - key < window))) v = -INFINITY;
          }
          x[n][e] = v;
        }
      float alpha[2];
      mma::online_softmax<NT>(x, m, l, alpha, 1.f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      if constexpr (I8) {
        // the V scale folds into the p column (l sums the bare p)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[n][e] *= kscale[BK + 8 * n + 2 * t + (e & 1)];
      }
      mma::gemm_pb<D, NT>(acc, x, vtile, lane);
    }
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float li = mma::quad_sum(l[e]);
    const int i = wi0 + g + 8 * e;
    if (i >= n_pairs) continue;
    const int r = i / G;
    const float inv = li > 0.f ? 1.f / li : 0.f;
    bf16* orow = out + ((row0 + r) * H + hk * G + (i - r * G)) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * e] * inv, acc[n][2 * e + 1] * inv);
  }
}

template <int D, typename KV, bool ALIBI>
int launch_paged_chunk(const void* q, const void* kv, const void* sc, int r8,
                       const void* bt, const void* q_starts, const void* ctx_lens,
                       const void* slopes, void* out, int NC, int Cs, int H, int Hkv,
                       int bs, int MB, int window, float scale, cudaStream_t stream) {
  const int cap = chunk_table_cap(MB, bs, window);
  const size_t smem = ChunkSmem<D, std::is_same<KV, int8_t>::value>::bytes(cap);
  auto kern = paged_chunk_kernel<D, KV, ALIBI>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Cs * (H / Hkv) + kChRows - 1) / kChRows, Hkv, NC);
  kern<<<grid, kChThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(kv),
      static_cast<const float*>(sc), r8, static_cast<const int*>(bt),
      static_cast<const int*>(q_starts), static_cast<const int*>(ctx_lens),
      static_cast<const float*>(slopes), static_cast<bf16*>(out), Cs, H, Hkv, bs, MB,
      window, scale, cap);
  return (int)cudaGetLastError();
}

// ALIBI is a compile-time branch, picked here by slopes != null for either
// page type
template <int D, typename KV>
int launch_paged_chunk_any(const void* q, const void* kv, const void* sc, int r8,
                           const void* bt, const void* q_starts, const void* ctx_lens,
                           const void* slopes, void* out, int NC, int Cs, int H, int Hkv,
                           int bs, int MB, int window, float scale, cudaStream_t stream) {
  if (slopes != nullptr)
    return launch_paged_chunk<D, KV, true>(q, kv, sc, r8, bt, q_starts, ctx_lens, slopes,
                                           out, NC, Cs, H, Hkv, bs, MB, window, scale,
                                           stream);
  return launch_paged_chunk<D, KV, false>(q, kv, sc, r8, bt, q_starts, ctx_lens, nullptr,
                                          out, NC, Cs, H, Hkv, bs, MB, window, scale, stream);
}

template <int D>
int launch_paged_chunk_bf16(const void* q, const void* kv, const void* bt,
                            const void* q_starts, const void* ctx_lens, const void* slopes,
                            void* out, int NC, int Cs, int H, int Hkv, int bs, int MB,
                            int window, float scale, cudaStream_t stream) {
  return launch_paged_chunk_any<D, bf16>(q, kv, nullptr, 0, bt, q_starts, ctx_lens, slopes,
                                         out, NC, Cs, H, Hkv, bs, MB, window, scale, stream);
}

template <int D, typename KV, bool ALIBI>
int chunk_attrs(int cap, int* out) {
  return mma::kernel_attributes(paged_chunk_kernel<D, KV, ALIBI>, kChThreads,
                                ChunkSmem<D, std::is_same<KV, int8_t>::value>::bytes(cap),
                                out);
}

template <int D, typename KV>
int chunk_attrs_any(int alibi, int cap, int* out) {
  return alibi ? chunk_attrs<D, KV, true>(cap, out) : chunk_attrs<D, KV, false>(cap, out);
}

template <int D>
int chunk_attrs_bf16(int alibi, int cap, int* out) {
  return chunk_attrs_any<D, bf16>(alibi, cap, out);
}

}  // namespace dstorch

// q [NC, Cs, H, D] bf16; kv [NB, 2, Hkv, bs, D] bf16; bt [NC, MB],
// q_starts [NC], ctx_lens [NC] int32; slopes [H] f32 (ALiBi) or null;
// out [NC, Cs, H, D] bf16; window > 0 also hides keys at or below
// q_pos - window (0: no window).
// Returns the cudaError_t of the launch (0 = success), -1 for an
// unsupported head dim.
extern "C" int dstorch_paged_chunk_bf16(const void* q, const void* kv, const void* bt,
                                        const void* q_starts, const void* ctx_lens,
                                        const void* slopes, void* out, int NC, int Cs,
                                        int H, int Hkv, int D, int bs, int MB, int window,
                                        float scale, void* stream) {
  if (NC == 0 || Cs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_DISPATCH_D(D, dstorch::launch_paged_chunk_bf16, q, kv, bt, q_starts, ctx_lens,
                     slopes, out, NC, Cs, H, Hkv, bs, MB, window, scale, st)
}

// The same over int8 pages kv [NB, 2, Hkv, bs, D] with f32 scale tiles
// sc [NB, R8, 128], with the same slopes and window. Head dims 128 and 256
// (the kv_quant gate asks D % 128 == 0); -1 for any other.
extern "C" int dstorch_paged_chunk_int8(const void* q, const void* kv, const void* sc,
                                        const void* bt, const void* q_starts,
                                        const void* ctx_lens, const void* slopes, void* out,
                                        int NC, int Cs, int H, int Hkv, int D, int bs,
                                        int MB, int r8, int window, float scale,
                                        void* stream) {
  if (NC == 0 || Cs == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128:
      return dstorch::launch_paged_chunk_any<128, int8_t>(q, kv, sc, r8, bt, q_starts,
                                                          ctx_lens, slopes, out, NC, Cs, H,
                                                          Hkv, bs, MB, window, scale, st);
    case 256:
      return dstorch::launch_paged_chunk_any<256, int8_t>(q, kv, sc, r8, bt, q_starts,
                                                          ctx_lens, slopes, out, NC, Cs, H,
                                                          Hkv, bs, MB, window, scale, st);
    default:
      return -1;
  }
}

// K5's attributes (mma::kernel_attributes: registers, spill bytes, static
// and dynamic shared bytes, threads, blocks an SM) for one instance: int8
// pages or bf16, head dim D, ALiBi or not, a table slice of `cap` entries
// (chunk_table_cap); returns the cudaError_t, -1 for an unsupported D
extern "C" int dstorch_paged_chunk_attrs(int int8, int D, int alibi, int cap, int* out) {
  if (int8) {
    switch (D) {
      case 128: return dstorch::chunk_attrs_any<128, int8_t>(alibi, cap, out);
      case 256: return dstorch::chunk_attrs_any<256, int8_t>(alibi, cap, out);
      default: return -1;
    }
  }
  DSTORCH_DISPATCH_D(D, dstorch::chunk_attrs_bf16, alibi, cap, out)
}
