// Flash-decoding split-K paged decode attention (K7), bf16 or int8 pages,
// sm_90a: the partials kernel and the logsumexp merge.
//
// Replaces deepspeed_tpu/ops/pallas/paged_splitk.py
// paged_decode_attention_splitk_pallas (:499; kernels _splitk_kernel :485 and
// _splitk_kernel_quant :491, body _splitk_body :324). Each sequence's
// block-table range is cut into n_splits splits of ceil(MB / n_splits)
// pages; one block per (sequence x piece, kv head) walks only its split's
// tokens (decode_attend of decode_common.cuh) and writes an f32 partial
// (out = acc / l, lse = m + log l). A split past the sequence's context
// writes (0, -1e30), which the merge weights 0. With side rows (the decode
// step and the side buffer, paged_sidebuf_attention_splitk :725) one more
// piece per sequence attends the side rows cc <= j alone, so the merge
// combines n_splits + 1 pieces, as the JAX dispatcher does.
//
// Sliding window (window > 0; _splitk_body's window, :324-377): the splits
// still cut the whole [0, MB) page range; each walks only its tokens at or
// above the first visible one (max(ctx - window, 0), or max(prefix + j + 1
// - window, 0) with side rows, as the decode kernel), so a split wholly
// below the window start reads nothing and writes its empty partial (0,
// -1e30), which the merge drops. The side piece needs cc >= j + 1 -
// window. window = 0 is the unwindowed kernel.
//
// ALiBi (slopes != null; _splitk_body's alibi, :467-471, and the side-slab
// piece of paged_sidebuf_attention_splitk, :800-805): each split's partial
// biases its scores by slopes[h] * k_pos with k_pos the key's ABSOLUTE
// position (not its offset in the split), the side piece by prefix + cc,
// so every partial's lse carries the same row constant and the merge is
// unchanged.
//
// The merge (merge_splitk_partials :84, XLA outside Pallas in JAX) is the
// second kernel here: one block per (sequence, head) weighs the pieces by
// exp(lse_p - max lse) (0 for an empty piece) and writes the bf16 output,
// and optionally the merged lse.
//
// Bound on the H100: bytes, as for the decode kernel (every visible token's
// K and V row read once, plus the f32 partials written and read back:
// pieces x H x (D + 1) x 4 bytes per sequence, small beside the pages at
// long context). The point of the split: at S = 4 and 40 kv heads the
// decode kernel runs 160 blocks on 132 SMs, each walking the whole
// context; n_splits = 8 gives 1280 shorter blocks.
#include "decode_common.cuh"

namespace dstorch {

template <int G, int LPR, typename KV, typename SIDE>
__global__ void __launch_bounds__(kDecThreads)
paged_splitk_kernel(const bf16* __restrict__ q, DecodePage pg, const int* __restrict__ bt,
                    const int* __restrict__ lens, const SIDE* __restrict__ side_k,
                    const SIDE* __restrict__ side_v, int C, int j, int n_splits,
                    int split_tokens, const float* __restrict__ slopes,
                    float* __restrict__ out_p,
                    float* __restrict__ lse_p, int MB, int window, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int P = n_splits + (side_k != nullptr ? 1 : 0);
  const int s = blockIdx.x / P, piece = blockIdx.x - (blockIdx.x / P) * P;
  const int hk = blockIdx.y;
  const int D = pg.D, H = pg.Hkv * G;
  pg.btr = bt + (size_t)s * MB;
  const bf16* qrow = q + ((size_t)s * H + hk * G) * D;
  const int len = lens[s];
  int w_lo = 0, c_lo = 0;
  if (window > 0) {
    w_lo = max(side_k != nullptr ? len + j + 1 - window : len - window, 0);
    c_lo = max(j + 1 - window, 0);
  }
  if (piece < n_splits) {
    const int t_lo = max(piece * split_tokens, w_lo);
    const int t_hi = min(piece * split_tokens + split_tokens, len);
    decode_attend<G, LPR, KV, SIDE>(qrow, pg, hk, t_lo, t_hi, nullptr, nullptr, 0, scale,
                                    smem, 0, slopes, 0);
  } else {
    const size_t slab = (size_t)s * C * pg.Hkv * D;
    decode_attend<G, LPR, KV, SIDE>(qrow, pg, hk, 0, 0, side_k + slab, side_v + slab,
                                    j + 1, scale, smem, c_lo, slopes, len);
  }
  const size_t row0 = ((size_t)s * P + piece) * H + hk * G;
  for (int idx = threadIdx.x; idx < G * D; idx += kDecThreads) {
    const int g = idx / D, d = idx - (idx / D) * D;
    float M, L, A;
    decode_final<G>(smem, D, g, d, M, L, A);
    out_p[(row0 + g) * D + d] = L > 0.f ? A / L : 0.f;
    if (d == 0) lse_p[row0 + g] = L > 0.f ? M + logf(L) : kNegBig;
  }
}

// out_p [S, P, H, D], lse_p [S, P, H] -> out [S, H, D] bf16 (+ lse [S, H])
__global__ void __launch_bounds__(128)
splitk_merge_kernel(const float* __restrict__ out_p, const float* __restrict__ lse_p,
                    int P, int H, int D, bf16* __restrict__ out,
                    float* __restrict__ lse_out) {
  const int s = blockIdx.x, h = blockIdx.y;
  const float* lse = lse_p + (size_t)s * P * H + h;
  float M = kNegBig;
  for (int p = 0; p < P; ++p) M = fmaxf(M, lse[(size_t)p * H]);
  float den = 0.f;
  for (int p = 0; p < P; ++p) {
    const float lp = lse[(size_t)p * H];
    den += lp > 0.5f * kNegBig ? __expf(lp - M) : 0.f;
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < P; ++p) {
      const float lp = lse[(size_t)p * H];
      const float w = lp > 0.5f * kNegBig ? __expf(lp - M) : 0.f;
      acc = fmaf(w, out_p[(((size_t)s * P + p) * H + h) * D + d], acc);
    }
    out[((size_t)s * H + h) * D + d] = __float2bfloat16(acc * inv);
  }
  if (lse_out != nullptr && threadIdx.x == 0)
    lse_out[(size_t)s * H + h] = den > 0.f ? M + logf(den) : kNegBig;
}

struct SplitLaunch {
  const void *q, *bt, *lens, *side_k, *side_v, *slopes;
  float *out_p, *lse_p;
  DecodePage pg;
  int S, MB, C, j, n_splits, split_tokens, window;
  float scale;
};

template <typename KV, typename SIDE, int G, int LPR>
int launch_splitk(const SplitLaunch& a, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<G>(a.pg.D);
  auto kern = paged_splitk_kernel<G, LPR, KV, SIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int P = a.n_splits + (a.side_k != nullptr ? 1 : 0);
  dim3 grid(a.S * P, a.pg.Hkv);
  kern<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), a.pg, static_cast<const int*>(a.bt),
      static_cast<const int*>(a.lens), static_cast<const SIDE*>(a.side_k),
      static_cast<const SIDE*>(a.side_v), a.C, a.j, a.n_splits, a.split_tokens,
      static_cast<const float*>(a.slopes), a.out_p, a.lse_p, a.MB, a.window, a.scale);
  return (int)cudaGetLastError();
}

// lanes per row as the decode kernel picks them (decode_lpr); int8 pages
// need D % 128 == 0 (the kv_quant gate): 16 or 32 lanes
template <typename KV, typename SIDE, int G>
int dispatch_splitk_lpr(const SplitLaunch& a, cudaStream_t st) {
  switch (decode_lpr(a.pg.D)) {
    case 16: return launch_splitk<KV, SIDE, G, 16>(a, st);
    case 32: return launch_splitk<KV, SIDE, G, 32>(a, st);
    default: break;
  }
  if constexpr (std::is_same<KV, bf16>::value) {
    switch (decode_lpr(a.pg.D)) {
      case 2: return launch_splitk<KV, SIDE, G, 2>(a, st);
      case 4: return launch_splitk<KV, SIDE, G, 4>(a, st);
      case 8: return launch_splitk<KV, SIDE, G, 8>(a, st);
      default: break;
    }
  }
  return -1;
}

template <typename KV, typename SIDE>
int dispatch_splitk(int G, const SplitLaunch& a, cudaStream_t st) {
  switch (G) {
    case 1: return dispatch_splitk_lpr<KV, SIDE, 1>(a, st);
    case 2: return dispatch_splitk_lpr<KV, SIDE, 2>(a, st);
    case 4: return dispatch_splitk_lpr<KV, SIDE, 4>(a, st);
    case 8: return dispatch_splitk_lpr<KV, SIDE, 8>(a, st);
    default: return -1;
  }
}

}  // namespace dstorch

// q [S, H, D] bf16; kv [NB, 2, Hkv, bs, D] bf16; bt [S, MB], lens [S] int32;
// side_k/side_v [S, C*Hkv, D] bf16 or null (one more piece: rows cc <= j);
// out_p [S, P, H, D] and lse_p [S, P, H] f32 with P = n_splits (+ 1 with
// side rows); split p covers tokens [p * split_tokens, (p+1) * split_tokens);
// slopes [H] f32 (ALiBi) or null; window > 0 is the sliding window (0:
// none). Returns the launch's cudaError_t, -1 for an unsupported shape.
extern "C" int dstorch_paged_splitk_bf16(const void* q, const void* kv, const void* bt,
                                         const void* lens, const void* side_k,
                                         const void* side_v, const void* slopes,
                                         void* out_p, void* lse_p, int S, int H, int Hkv,
                                         int D, int bs, int MB, int C, int j, int n_splits,
                                         int split_tokens, int window, float scale,
                                         void* stream) {
  if (S == 0) return 0;
  if (D % 8 != 0 || D > 256 || H % Hkv != 0 || n_splits < 1) return -1;
  dstorch::SplitLaunch a{q, bt, lens, side_k, side_v, slopes,
                         static_cast<float*>(out_p), static_cast<float*>(lse_p),
                         {kv, nullptr, 0, nullptr, Hkv, bs, D},
                         S, MB, C, j, n_splits, split_tokens, window, scale};
  return dstorch::dispatch_splitk<dstorch::bf16, dstorch::bf16>(
      H / Hkv, a, static_cast<cudaStream_t>(stream));
}

// The same over int8 pages with f32 scale tiles sc [NB, R8, 128]; side rows
// are f32. slopes and window as for bf16 pages: under a window a split
// wholly below the first visible token reads no page and no scale and
// writes the empty partial, which the merge weighs 0.
extern "C" int dstorch_paged_splitk_int8(const void* q, const void* kv, const void* sc,
                                         const void* bt, const void* lens,
                                         const void* side_k, const void* side_v,
                                         const void* slopes, void* out_p, void* lse_p,
                                         int S, int H, int Hkv, int D, int bs, int MB,
                                         int r8, int C, int j, int n_splits,
                                         int split_tokens, int window, float scale,
                                         void* stream) {
  if (S == 0) return 0;
  if ((D != 128 && D != 256) || H % Hkv != 0 || n_splits < 1) return -1;
  dstorch::SplitLaunch a{q, bt, lens, side_k, side_v, slopes,
                         static_cast<float*>(out_p), static_cast<float*>(lse_p),
                         {kv, static_cast<const float*>(sc), r8, nullptr, Hkv, bs, D},
                         S, MB, C, j, n_splits, split_tokens, window, scale};
  return dstorch::dispatch_splitk<int8_t, float>(H / Hkv, a,
                                                 static_cast<cudaStream_t>(stream));
}

// out_p [S, P, H, D], lse_p [S, P, H] f32 -> out [S, H, D] bf16, and
// lse_out [S, H] f32 when not null.
extern "C" int dstorch_splitk_merge(const void* out_p, const void* lse_p, void* out,
                                    void* lse_out, int S, int P, int H, int D,
                                    void* stream) {
  if (S == 0) return 0;
  dim3 grid(S, H);
  dstorch::splitk_merge_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(out_p), static_cast<const float*>(lse_p), P, H, D,
      static_cast<dstorch::bf16*>(out), static_cast<float*>(lse_out));
  return (int)cudaGetLastError();
}
