// Shared device code of the port's attention kernels (sm_90a, bf16 in,
// f32 accumulate, bf16 out).
//
// flash_block<D> is one thread block's flash-attention loop over 64 query
// rows of ONE head: Q, then 64-key tiles of K and V, staged in shared
// memory; scores and P.V on CUDA cores with FMAs in f32; online softmax
// (running max m, sum l, accumulator o) per row. The caller supplies where
// key rows live (kv_row) and which (row, key) pairs are visible (mask).
// Its user is the paged chunk kernel (rows gathered through a block
// table); the packed-prefill kernel runs on the tensor cores
// (flash_packed.cu on mma_common.cuh).
//
// Thread layout (256 threads): thread (ty = tid / 16, tx = tid % 16) owns
// query rows 4*ty .. 4*ty+3; for the scores it owns key columns tx + 16*c
// (c < 4), for the output the dims tx + 16*n (n < D/16). A row's 16 owner
// threads are one half-warp, so row max and row sum reduce with xor
// shuffles and no barrier.
//
// Shared memory: Q and K rows are stored with a stride of D + 2 bf16 (an odd
// number of 32-bit words), so the 16 threads reading 16 different K rows at
// the same depth hit 16 different banks. V (read row-broadcast) and P keep
// dense rows (P padded by one float).
//
// An optional per-key additive score bias (the Bias functor; ALiBi's
// slope * k_pos) is a compile-time flag: NoBias leaves the loop's
// arithmetic as it is, a biased block adds bias(key) to each visible
// scaled score in f32 before the running max (masked keys stay kNegBig).
//
// int8 pages (kv_row returns a KVRowPtrI8): K and V tiles stay int8 in
// shared memory (K rows padded to D + 4 bytes, again an odd word count)
// with each key's f32 K and V scales beside them. The K scale multiplies
// the key's score column and the V scale its p column before P.V (the
// fold of the JAX package's _colscale_pages / _chunk_head_scale), so no
// dequantized tile is stored and the arithmetic stays f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dstorch {

typedef __nv_bfloat16 bf16;

constexpr float kNegBig = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kTileThreads = 256;

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 16 bytes into a shared row whose start is only 4-byte aligned
__device__ __forceinline__ void store8_words(bf16* dst, const uint4& u) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  d[0] = u.x;
  d[1] = u.y;
  d[2] = u.z;
  d[3] = u.w;
}

struct KVRowPtr {
  const bf16* k;
  const bf16* v;
};

// a key of an int8 page: its K and V rows and their dequant scales
struct KVRowPtrI8 {
  const int8_t* k;
  const int8_t* v;
  float ks, vs;
};

// no score bias: flash_block's loop compiles as it does without the hook
struct NoBias {
  static constexpr bool kOn = false;
  __device__ __forceinline__ float operator()(int) const { return 0.f; }
};

// ALiBi: slope * k_pos, the key's absolute position (the -slope * q_pos
// term is constant along a softmax row and dropped, as in the JAX package)
struct AlibiBias {
  static constexpr bool kOn = true;
  float slope;
  __device__ __forceinline__ float operator()(int key) const {
    return slope * (float)key;
  }
};

template <int D, bool I8 = false>
struct FlashSmem {
  static constexpr int QS = D + 2;   // padded Q/K row, in bf16
  static constexpr int KS8 = D + 4;  // padded int8 K row, in bytes
  static constexpr int PS = kBK + 1; // padded P row, in floats
  static constexpr size_t q_bytes = (size_t)kBQ * QS * sizeof(bf16);
  static constexpr size_t k_bytes =
      I8 ? (size_t)kBK * KS8 : (size_t)kBK * QS * sizeof(bf16);
  static constexpr size_t v_bytes = (size_t)kBK * D * (I8 ? 1 : sizeof(bf16));
  static constexpr size_t p_bytes = (size_t)kBQ * PS * sizeof(float);
  static constexpr size_t s_bytes = I8 ? 2 * kBK * sizeof(float) : 0;
  static constexpr size_t bytes = q_bytes + k_bytes + v_bytes + p_bytes + s_bytes;
};

// q row r (r < n_q) starts at q_rows + r * row_stride, likewise the output.
// Keys are 0 .. n_keys-1; kv_row(key) gives their K and V rows;
// mask(r, key) says whether row r sees key (key < n_keys is implied).
// Rows that see no key get zeros. When lse_rows is given, row r's
// log-sum-exp of its scaled scores (m + log l) goes to lse_rows[r], and
// kNegBig for a row that sees no key. Keys below k_lo are neither read nor
// computed (a sliding window's start: no row of the block sees them); the
// key tiles start at k_lo. `bias` (Bias::kOn) adds bias(key) to every
// visible key's scaled score, score * scale + bias(key) in f32.
template <int D, typename KVRow, typename Mask, typename Bias = NoBias>
__device__ __forceinline__ void flash_block(const bf16* __restrict__ q_rows,
                                            bf16* __restrict__ o_rows,
                                            int row_stride, int n_q, int n_keys,
                                            KVRow kv_row, Mask mask,
                                            float scale, char* smem,
                                            float* __restrict__ lse_rows = nullptr,
                                            int k_lo = 0, Bias bias = Bias()) {
  static_assert(D % 16 == 0 && D <= 256, "head dim must be a multiple of 16, <= 256");
  constexpr bool I8 = std::is_same<decltype(kv_row(0)), KVRowPtrI8>::value;
  using S = FlashSmem<D, I8>;
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int ND = D / 16;  // output dims per thread
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + S::q_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::q_bytes + S::k_bytes);
  float* Ps = reinterpret_cast<float*>(smem + S::q_bytes + S::k_bytes + S::v_bytes);
  // int8 views of the K/V tiles and the keys' scales (unused for bf16)
  int8_t* Ks8 = reinterpret_cast<int8_t*>(smem + S::q_bytes);
  int8_t* Vs8 = reinterpret_cast<int8_t*>(smem + S::q_bytes + S::k_bytes);
  float* Kscl = reinterpret_cast<float*>(smem + S::q_bytes + S::k_bytes + S::v_bytes +
                                         S::p_bytes);
  float* Vscl = Kscl + kBK;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < kBQ * CH; i += kTileThreads) {
    const int r = i / CH, c = i - (i / CH) * CH;
    const uint4 u = r < n_q ? load16(q_rows + (size_t)r * row_stride + c * 8) : zero;
    store8_words(Qs + r * S::QS + c * 8, u);
  }

  float o[4][ND];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n) o[r][n] = 0.f;
  }

  for (int k0 = k_lo; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    if constexpr (I8) {
      constexpr int CH8 = D / 16;  // 16-byte chunks per int8 row
      for (int i = tid; i < kBK * CH8; i += kTileThreads) {
        const int kk = i / CH8, c = i - (i / CH8) * CH8;
        const int key = k0 + kk;
        uint4 uk = zero, uv = zero;
        float ks = 0.f, vs = 0.f;
        if (key < n_keys) {
          const KVRowPtrI8 p = kv_row(key);
          uk = *reinterpret_cast<const uint4*>(p.k + c * 16);
          uv = *reinterpret_cast<const uint4*>(p.v + c * 16);
          ks = p.ks;
          vs = p.vs;
        }
        store8_words(reinterpret_cast<bf16*>(Ks8 + kk * S::KS8 + c * 16), uk);
        *reinterpret_cast<uint4*>(Vs8 + kk * D + c * 16) = uv;
        if (c == 0) {
          Kscl[kk] = ks;
          Vscl[kk] = vs;
        }
      }
    } else {
      for (int i = tid; i < kBK * CH; i += kTileThreads) {
        const int kk = i / CH, c = i - (i / CH) * CH;
        const int key = k0 + kk;
        uint4 uk = zero, uv = zero;
        if (key < n_keys) {
          const KVRowPtr p = kv_row(key);
          uk = load16(p.k + c * 8);
          uv = load16(p.v + c * 8);
        }
        store8_words(Ks + kk * S::QS + c * 8, uk);
        *reinterpret_cast<uint4*>(Vs + kk * D + c * 8) = uv;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    if constexpr (I8) {
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float2 qa[4], qb[4];
        float kf[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const bf16* qr = Qs + (ty * 4 + r) * S::QS + d;
          qa[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr));
          qb[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + 2));
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const char4 k4 =
              *reinterpret_cast<const char4*>(Ks8 + (tx + 16 * c) * S::KS8 + d);
          kf[c][0] = (float)k4.x;
          kf[c][1] = (float)k4.y;
          kf[c][2] = (float)k4.z;
          kf[c][3] = (float)k4.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[r][c] = fmaf(qb[r].y, kf[c][3], fmaf(qb[r].x, kf[c][2],
                      fmaf(qa[r].y, kf[c][1], fmaf(qa[r].x, kf[c][0], s[r][c]))));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float ks = Kscl[tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) s[r][c] *= ks;
      }
    } else {
#pragma unroll 4
      for (int d = 0; d < D; d += 2) {
        float2 qv[4], kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          qv[r] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Qs + (ty * 4 + r) * S::QS + d));
#pragma unroll
        for (int c = 0; c < 4; ++c)
          kv[c] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Ks + (tx + 16 * c) * S::QS + d));
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[r][c] = fmaf(qv[r].y, kv[c].y, fmaf(qv[r].x, kv[c].x, s[r][c]));
      }
    }

    float kb[4];  // the keys' score bias (unused without one)
#pragma unroll
    for (int c = 0; c < 4; ++c) kb[c] = Bias::kOn ? bias(k0 + tx + 16 * c) : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      bool ok[4];
      float mx = kNegBig;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        ok[c] = row < n_q && key < n_keys && mask(row, key);
        if constexpr (Bias::kOn)
          s[r][c] = ok[c] ? fmaf(s[r][c], scale, kb[c]) : kNegBig;
        else
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
        // int8: the V scale folds into the p column (l sums the bare p)
        Ps[row * S::PS + tx + 16 * c] = I8 ? p * Vscl[tx + 16 * c] : p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) o[r][n] *= alpha;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = Ps[(ty * 4 + r) * S::PS + kk];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float vv = I8 ? (float)Vs8[kk * D + tx + 16 * n]
                            : __bfloat162float(Vs[kk * D + tx + 16 * n]);
#pragma unroll
        for (int r = 0; r < 4; ++r) o[r][n] = fmaf(pr[r], vv, o[r][n]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (row >= n_q) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* dst = o_rows + (size_t)row * row_stride;
#pragma unroll
    for (int n = 0; n < ND; ++n) dst[tx + 16 * n] = __float2bfloat16(o[r][n] * inv);
    if (lse_rows != nullptr && tx == 0)
      lse_rows[row] = l[r] > 0.f ? m[r] + logf(l[r]) : kNegBig;
  }
}

// Dispatch on the head dim (compile-time in flash_block): 80 and 96 are
// phi-2's and GPT-NeoX-20B's (FlashSmem's padded rows stay an odd number
// of words: 41 and 49).
#define DSTORCH_DISPATCH_D(D, FN, ...)      \
  switch (D) {                              \
    case 16: return FN<16>(__VA_ARGS__);    \
    case 32: return FN<32>(__VA_ARGS__);    \
    case 64: return FN<64>(__VA_ARGS__);    \
    case 80: return FN<80>(__VA_ARGS__);    \
    case 96: return FN<96>(__VA_ARGS__);    \
    case 128: return FN<128>(__VA_ARGS__);  \
    case 256: return FN<256>(__VA_ARGS__);  \
    default: return -1;                     \
  }

}  // namespace dstorch
