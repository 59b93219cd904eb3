// Paged decode attention, one query token per sequence, bf16, sm_90a.
//
// Replaces the shared decode body of deepspeed_tpu/ops/pallas/paged_attention.py
// (_decode_body, :280) in its three entry points:
//   - paged_decode_attention (:1088, K3): pages hold all ctx tokens;
//   - paged_decode_attention_step (:1249, K4): pages hold [0, ctx-1), the
//     current token's K/V comes from the caller (here: one side row, C = 1,
//     j = 0) and is written into its page by the caller afterwards;
//   - paged_decode_attention_sidebuf (:809, K6): a frozen prefix in pages
//     plus a side slab [S, C*Hkv, D] of fresh rows, row cc*Hkv + h; rows
//     cc <= j join the same online-softmax state.
// It also covers _paged_decode_smalld (:1053): any D that is a multiple of
// 8 up to 256 runs here.
//
// Bound on the H100: bytes. A decode step reads every visible token's K and
// V row once (2 * D * 2 bytes per kv head) and does 4*D flops per query
// head on it, ~1 flop per byte at MHA, two orders of magnitude below the
// ridge. At Llama-2-7B (Hkv = 32, D = 128) a sequence at ctx 2048 streams
// 32 MiB per layer.
//
// Design: one block (128 threads) per (sequence, kv head); its G = H/Hkv
// query heads share every page read. A row group of LPR lanes (LPR = D/8
// rounded up to a power of two) owns one token at a time: each lane loads
// 16 bytes of the token's K row and of its V row, the q.k dot reduces over
// the row group with xor shuffles, and the group keeps its own running
// (m, l, acc) — no barrier inside the token loop. Each group issues U
// tokens' loads before using them, to keep enough bytes in flight. At the
// end the groups merge: by shuffles inside a warp, then across the four
// warps through shared memory. A row that sees no token gives zeros.
// Not yet done: splitting a long context across blocks (split-K), which
// the card needs when S * Hkv is small.
#include "attn_common.cuh"

namespace dstorch {

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;

template <int G, int LPR>
__device__ __forceinline__ void decode_update(const float (&qf)[G][8], const uint4& kr,
                                              const uint4& vr, bool ok, float (&m)[G],
                                              float (&l)[G], float (&acc)[G][8]) {
  float kf[8], vf[8];
  bf16x8_to_float(kr, kf);
  bf16x8_to_float(vr, vf);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float sc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) sc = fmaf(qf[g][i], kf[i], sc);
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      sc += __shfl_xor_sync(0xffffffffu, sc, off);
    if (ok) {
      const float m_new = fmaxf(m[g], sc);
      const float alpha = __expf(m[g] - m_new);
      const float p = __expf(sc - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(acc[g][i], alpha, p * vf[i]);
      m[g] = m_new;
    }
  }
}

template <int G, int LPR>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                    const int* __restrict__ bt, const int* __restrict__ lens,
                    const bf16* __restrict__ side_k, const bf16* __restrict__ side_v,
                    int C, int j, bf16* __restrict__ out, int Hkv, int bs, int D, int MB,
                    float scale) {
  constexpr int NGROUP = kDecThreads / LPR;
  constexpr int U = G <= 2 ? 4 : 2;
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x, hk = blockIdx.y, tid = threadIdx.x;
  const int lane_in_group = tid & (LPR - 1);
  const int grp = tid / LPR;
  const int d0 = lane_in_group * 8;
  const bool act = d0 < D;
  const int H = Hkv * G;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float qf[G][8], m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 u = act ? load16(q + ((size_t)s * H + hk * G + g) * D + d0) : zero;
    bf16x8_to_float(u, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qf[g][i] *= scale;
      acc[g][i] = 0.f;
    }
    m[g] = kNegBig;
    l[g] = 0.f;
  }

  // pages: tokens [0, lens[s])
  const int n = lens[s];
  const int* btr = bt + (size_t)s * MB;
  const size_t page_elems = (size_t)2 * Hkv * bs * D;
  const size_t koff = (size_t)hk * bs * D + d0;
  const size_t voff = (size_t)(Hkv + hk) * bs * D + d0;
  for (int t0 = 0; t0 < n; t0 += NGROUP * U) {
    uint4 kr[U], vr[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NGROUP + grp;
      ok[u] = t < n;
      kr[u] = zero;
      vr[u] = zero;
      if (ok[u] && act) {
        const int pi = t / bs;
        const bf16* page = kv + (size_t)__ldg(btr + pi) * page_elems + (size_t)(t - pi * bs) * D;
        kr[u] = load16(page + koff);
        vr[u] = load16(page + voff);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) decode_update<G, LPR>(qf, kr[u], vr[u], ok[u], m, l, acc);
  }

  // side rows cc <= j (row cc*Hkv + hk of this sequence's slab)
  if (side_k != nullptr) {
    const int ns = j + 1;
    for (int c0 = 0; c0 < ns; c0 += NGROUP) {
      const int cc = c0 + grp;
      const bool ok = cc < ns;
      uint4 kr = zero, vr = zero;
      if (ok && act) {
        const size_t row = ((size_t)s * C + cc) * Hkv + hk;
        kr = load16(side_k + row * D + d0);
        vr = load16(side_v + row * D + d0);
      }
      decode_update<G, LPR>(qf, kr, vr, ok, m, l, acc);
    }
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

  // then the warps, through shared memory
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
  for (int idx = tid; idx < G * D; idx += kDecThreads) {
    const int g = idx / D, d = idx - (idx / D) * D;
    float M = kNegBig;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) M = fmaxf(M, sm_m[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float e = __expf(sm_m[w * G + g] - M);
      L += sm_l[w * G + g] * e;
      A += sm_acc[((size_t)w * G + g) * D + d] * e;
    }
    out[((size_t)s * H + hk * G + g) * D + d] = __float2bfloat16(L > 0.f ? A / L : 0.f);
  }
}

template <int G, int LPR>
int launch_paged_decode(const void* q, const void* kv, const void* bt, const void* lens,
                        const void* side_k, const void* side_v, int S, int Hkv, int D,
                        int bs, int MB, int C, int j, float scale, void* out,
                        cudaStream_t stream) {
  const size_t smem = ((size_t)kDecWarps * G * D + 2 * kDecWarps * G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<G, LPR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S, Hkv);
  paged_decode_kernel<G, LPR><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
      static_cast<const int*>(bt), static_cast<const int*>(lens),
      static_cast<const bf16*>(side_k), static_cast<const bf16*>(side_v), C, j,
      static_cast<bf16*>(out), Hkv, bs, D, MB, scale);
  return (int)cudaGetLastError();
}

template <int G>
int dispatch_lpr(int lpr, const void* q, const void* kv, const void* bt, const void* lens,
                 const void* side_k, const void* side_v, int S, int Hkv, int D, int bs,
                 int MB, int C, int j, float scale, void* out, cudaStream_t st) {
  switch (lpr) {
    case 2: return launch_paged_decode<G, 2>(q, kv, bt, lens, side_k, side_v, S, Hkv, D, bs, MB, C, j, scale, out, st);
    case 4: return launch_paged_decode<G, 4>(q, kv, bt, lens, side_k, side_v, S, Hkv, D, bs, MB, C, j, scale, out, st);
    case 8: return launch_paged_decode<G, 8>(q, kv, bt, lens, side_k, side_v, S, Hkv, D, bs, MB, C, j, scale, out, st);
    case 16: return launch_paged_decode<G, 16>(q, kv, bt, lens, side_k, side_v, S, Hkv, D, bs, MB, C, j, scale, out, st);
    case 32: return launch_paged_decode<G, 32>(q, kv, bt, lens, side_k, side_v, S, Hkv, D, bs, MB, C, j, scale, out, st);
    default: return -1;
  }
}

}  // namespace dstorch

// q [S, H, D] bf16; kv [NB, 2, Hkv, bs, D] bf16 (one layer); bt [S, MB] and
// lens [S] int32 (page tokens attended per sequence); side_k/side_v
// [S, C*Hkv, D] bf16 or null, rows cc <= j attended after the pages;
// out [S, H, D] bf16. Returns the cudaError_t of the launch (0 = success),
// -1 for an unsupported head dim or group size.
extern "C" int dstorch_paged_decode_bf16(const void* q, const void* kv, const void* bt,
                                         const void* lens, const void* side_k,
                                         const void* side_v, void* out, int S, int H,
                                         int Hkv, int D, int bs, int MB, int C, int j,
                                         float scale, void* stream) {
  if (S == 0) return 0;
  if (D % 8 != 0 || D > 256 || H % Hkv != 0) return -1;
  int lpr = 2;
  while (lpr * 8 < D) lpr <<= 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / Hkv) {
    case 1: return dstorch::dispatch_lpr<1>(lpr, q, kv, bt, lens, side_k, side_v, S, Hkv, D, bs, MB, C, j, scale, out, st);
    case 2: return dstorch::dispatch_lpr<2>(lpr, q, kv, bt, lens, side_k, side_v, S, Hkv, D, bs, MB, C, j, scale, out, st);
    case 4: return dstorch::dispatch_lpr<4>(lpr, q, kv, bt, lens, side_k, side_v, S, Hkv, D, bs, MB, C, j, scale, out, st);
    case 8: return dstorch::dispatch_lpr<8>(lpr, q, kv, bt, lens, side_k, side_v, S, Hkv, D, bs, MB, C, j, scale, out, st);
    default: return -1;
  }
}
