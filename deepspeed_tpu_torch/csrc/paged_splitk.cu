// Flash-decoding split-K paged decode attention (K7), bf16 or int8 pages,
// sm_90a: the partials kernel and the logsumexp merge.
//
// Replaces deepspeed_tpu/ops/pallas/paged_splitk.py
// paged_decode_attention_splitk_pallas (:499; kernels _splitk_kernel :485 and
// _splitk_kernel_quant :491, body _splitk_body :324). Each sequence's
// VISIBLE page range [lo, len) (lo = 0, or the sliding window's first
// visible token: max(ctx - window, 0), or max(prefix + j + 1 - window, 0)
// with side rows, as the decode kernel) is cut on the device into n_splits
// pieces of ceil((len - lo) / n_splits) tokens (decode_piece); one block
// per (sequence x piece, kv head) walks its piece (decode_pages of
// decode_common.cuh: the table slice in shared memory, a 3-stage cp.async
// ring, mma.sync products) and writes an f32 partial (out = acc / l, lse =
// m + log l). An empty piece writes (0, -1e30), which the merge weights 0.
// With side rows (the decode step and the side buffer,
// paged_sidebuf_attention_splitk :725) one more piece per sequence attends
// the side rows cc <= j alone (cc >= j + 1 - window under a window), so the
// merge combines n_splits + 1 pieces, as the JAX dispatcher does.
//
// The JAX kernel cuts the table's width [0, MB) instead (its grid runs in
// order on one core); on the H100 the busiest block sets the time, so the
// cut follows each sequence's own range: a window of 4096 at 4 splits gives
// four blocks of 1024 tokens, not one of 3808 and one of 288. The merged
// output and lse do not depend on the cut beyond rounding.
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
// long context). The point of the split: at S = 4 and 40 kv heads one
// block per (sequence, kv head) gives 160 blocks on 132 SMs, each walking
// the whole context; n_splits = 8 gives 1280 shorter blocks.
#include "decode_common.cuh"

namespace dstorch {

template <int DP, typename KV, typename SIDE>
__global__ void __launch_bounds__(kDecThreads, 1)
paged_splitk_kernel(const bf16* __restrict__ q, DecodePage pg, const int* __restrict__ bt,
                    const int* __restrict__ lens, const SIDE* __restrict__ side_k,
                    const SIDE* __restrict__ side_v, int C, int j, int n_splits,
                    const float* __restrict__ slopes, float* __restrict__ out_p,
                    float* __restrict__ lse_p, int MB, int window, float scale, int G,
                    int tbl_cap) {
  extern __shared__ __align__(16) char smem[];
  const int P = n_splits + (side_k != nullptr ? 1 : 0);
  const int hk = blockIdx.y;
  const int D = pg.D, H = pg.Hkv * G;
  const int s = blockIdx.x / P, piece = blockIdx.x - (blockIdx.x / P) * P;
  pg.btr = bt + (size_t)s * MB;
  const int len = min(lens[s], MB * pg.bs);
  const bf16* qrow = q + ((size_t)s * H + hk * G) * D;
  int lo, c_lo, b_lo = 0, b_hi = 0;
  decode_visible(len, side_k != nullptr, j, window, lo, c_lo);
  if (piece < n_splits) decode_piece(lo, len, n_splits, piece, b_lo, b_hi);
  const float scale_log2 = scale * kDecLog2e;
  decode_pages<DP, KV>(qrow, G, pg, hk, b_lo, b_hi, scale_log2, slopes, smem, tbl_cap);
  char* body = smem + DecodeSmem<DP, KV>::table_bytes(tbl_cap);
  const bool side = piece == n_splits;
  if (side) {
    const size_t slab = (size_t)s * C * pg.Hkv * D;
    decode_side<DP, SIDE>(qrow, G, D, side_k + slab, side_v + slab, pg.Hkv, hk, c_lo, j + 1,
                          len, scale_log2, slopes, body);
  }
  decode_merge<DP>(body, side ? kDecSlots : kDecWarps);
  DecodeStates<DP> sts(body);
  const size_t row0 = ((size_t)s * P + piece) * H + hk * G;
  for (int idx = threadIdx.x; idx < G * D; idx += kDecThreads) {
    const int h = idx / D, d = idx - (idx / D) * D;
    const float L = sts.fin_l[h];
    out_p[(row0 + h) * D + d] = L > 0.f ? __fdividef(sts.fin_acc[h * DP + d], L) : 0.f;
    if (d == 0) lse_p[row0 + h] = L > 0.f ? (sts.fin_m[h] + __log2f(L)) * kDecLn2 : kNegBig;
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
  int S, G, MB, C, j, n_splits, split_tokens, window;
  float scale;
};

template <int DP, typename KV, typename SIDE>
int launch_splitk(const SplitLaunch& a, cudaStream_t stream) {
  const int cap = decode_table_cap(a.MB, a.split_tokens, a.pg.bs);
  const size_t smem = DecodeSmem<DP, KV>::bytes(cap);
  auto kern = paged_splitk_kernel<DP, KV, SIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int P = a.n_splits + (a.side_k != nullptr ? 1 : 0);
  dim3 grid(a.S * P, a.pg.Hkv);
  kern<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), a.pg, static_cast<const int*>(a.bt),
      static_cast<const int*>(a.lens), static_cast<const SIDE*>(a.side_k),
      static_cast<const SIDE*>(a.side_v), a.C, a.j, a.n_splits,
      static_cast<const float*>(a.slopes), a.out_p, a.lse_p, a.MB, a.window, a.scale, a.G,
      cap);
  return (int)cudaGetLastError();
}

// bf16 pages at the padded head dims (decode_dp); int8 pages at D 128 and
// 256 (the kv_quant gate)
template <typename KV, typename SIDE>
int dispatch_splitk(const SplitLaunch& a, cudaStream_t st) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    switch (a.pg.D) {
      case 128: return launch_splitk<128, KV, SIDE>(a, st);
      case 256: return launch_splitk<256, KV, SIDE>(a, st);
      default: return -1;
    }
  } else {
    switch (decode_dp(a.pg.D)) {
      case 16: return launch_splitk<16, KV, SIDE>(a, st);
      case 32: return launch_splitk<32, KV, SIDE>(a, st);
      case 64: return launch_splitk<64, KV, SIDE>(a, st);
      case 80: return launch_splitk<80, KV, SIDE>(a, st);
      case 96: return launch_splitk<96, KV, SIDE>(a, st);
      case 128: return launch_splitk<128, KV, SIDE>(a, st);
      case 256: return launch_splitk<256, KV, SIDE>(a, st);
      default: return -1;
    }
  }
}

template <int DP, typename KV, typename SIDE>
int splitk_attrs(int cap, int* out) {
  return mma::kernel_attributes(paged_splitk_kernel<DP, KV, SIDE>, kDecThreads,
                                DecodeSmem<DP, KV>::bytes(cap), out);
}

inline bool splitk_shape_ok(int H, int Hkv, int n_splits, int split_tokens) {
  return Hkv > 0 && H % Hkv == 0 && H / Hkv <= kDecHeads && n_splits >= 1
         && split_tokens >= 0;
}

}  // namespace dstorch

// q [S, H, D] bf16; kv [NB, 2, Hkv, bs, D] bf16; bt [S, MB], lens [S] int32;
// side_k/side_v [S, C*Hkv, D] bf16 or null (one more piece: rows cc <= j);
// out_p [S, P, H, D] and lse_p [S, P, H] f32 with P = n_splits (+ 1 with
// side rows); piece p of sequence s covers its visible tokens [lo + p c,
// min(lo + (p + 1) c, lens[s])), c = ceil((lens[s] - lo) / n_splits), cut
// on the device; split_tokens = ceil(MB / n_splits) * bs, the most tokens
// a piece can hold, sizes each block's staged block-table slice (a shape,
// so the launch's host scalars do not depend on lens); slopes [H] f32
// (ALiBi) or null; window > 0 is the sliding window (0: none). Returns the
// launch's cudaError_t, -1 for an unsupported shape.
extern "C" int dstorch_paged_splitk_bf16(const void* q, const void* kv, const void* bt,
                                         const void* lens, const void* side_k,
                                         const void* side_v, const void* slopes,
                                         void* out_p, void* lse_p, int S, int H, int Hkv,
                                         int D, int bs, int MB, int C, int j, int n_splits,
                                         int split_tokens, int window, float scale,
                                         void* stream) {
  if (D % 8 != 0 || D > 256 || !dstorch::splitk_shape_ok(H, Hkv, n_splits, split_tokens))
    return -1;
  if (S == 0) return 0;
  dstorch::SplitLaunch a{q, bt, lens, side_k, side_v, slopes,
                         static_cast<float*>(out_p), static_cast<float*>(lse_p),
                         {kv, nullptr, 0, nullptr, Hkv, bs, D},
                         S, H / Hkv, MB, C, j, n_splits, split_tokens, window, scale};
  return dstorch::dispatch_splitk<dstorch::bf16, dstorch::bf16>(
      a, static_cast<cudaStream_t>(stream));
}

// The same over int8 pages with f32 scale tiles sc [NB, R8, 128]; side rows
// are f32. slopes and window as for bf16 pages: under a window the pieces
// cut the visible range, so no page or scale below the first visible token
// is read.
extern "C" int dstorch_paged_splitk_int8(const void* q, const void* kv, const void* sc,
                                         const void* bt, const void* lens,
                                         const void* side_k, const void* side_v,
                                         const void* slopes, void* out_p, void* lse_p,
                                         int S, int H, int Hkv, int D, int bs, int MB,
                                         int r8, int C, int j, int n_splits,
                                         int split_tokens, int window, float scale,
                                         void* stream) {
  if ((D != 128 && D != 256) || !dstorch::splitk_shape_ok(H, Hkv, n_splits, split_tokens))
    return -1;
  if (S == 0) return 0;
  dstorch::SplitLaunch a{q, bt, lens, side_k, side_v, slopes,
                         static_cast<float*>(out_p), static_cast<float*>(lse_p),
                         {kv, static_cast<const float*>(sc), r8, nullptr, Hkv, bs, D},
                         S, H / Hkv, MB, C, j, n_splits, split_tokens, window, scale};
  return dstorch::dispatch_splitk<int8_t, float>(a, static_cast<cudaStream_t>(stream));
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

// Attributes of the partials kernel's instance for int8 pages (int8 != 0)
// or bf16 pages at head dim D, staging `cap` block-table entries: out[0..5]
// as mma::kernel_attributes. Returns the cudaError_t, -1 for no such
// instance.
extern "C" int dstorch_paged_splitk_attrs(int int8, int D, int cap, int* out) {
  using dstorch::bf16;
  if (int8) {
    switch (D) {
      case 128: return dstorch::splitk_attrs<128, int8_t, float>(cap, out);
      case 256: return dstorch::splitk_attrs<256, int8_t, float>(cap, out);
      default: return -1;
    }
  }
  switch (D) {
    case 16: return dstorch::splitk_attrs<16, bf16, bf16>(cap, out);
    case 32: return dstorch::splitk_attrs<32, bf16, bf16>(cap, out);
    case 64: return dstorch::splitk_attrs<64, bf16, bf16>(cap, out);
    case 80: return dstorch::splitk_attrs<80, bf16, bf16>(cap, out);
    case 96: return dstorch::splitk_attrs<96, bf16, bf16>(cap, out);
    case 128: return dstorch::splitk_attrs<128, bf16, bf16>(cap, out);
    case 256: return dstorch::splitk_attrs<256, bf16, bf16>(cap, out);
    default: return -1;
  }
}
