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
// Sliding window (window > 0; _decode_body's window, :303-349, and the
// side rows' mask, :487-488): without side rows the query sits at ctx - 1
// and sees page tokens from max(ctx - window, 0); with side rows it sits
// at prefix + j, so the first visible page token is max(prefix + j + 1 -
// window, 0) and the side rows need cc >= j + 1 - window. Pages outside
// [first visible token, ctx) are neither read nor computed. Tokens are
// addressed by logical position through the block table, so a table that
// repeats physical pages (the scheduler's page ring) reads the right
// tokens. window = 0 is the unwindowed kernel.
//
// ALiBi (slopes != null; _decode_body's alibi, :461-465 for pages, :493-496
// for side rows, :529-531 for the K4 step's current token; the small-D
// kernel's, :1028-1032): query head hk * G + g adds slopes[hk * G + g] *
// pos to each visible score, pos the key's absolute position: t for page
// token t, prefix + cc for side row cc (so the decode step's current token,
// one side row over a prefix of ctx - 1, sits at ctx - 1). A runtime flag:
// without slopes the kernel adds 0 * pos, leaving its scores as they were.
//
// Bound on the H100: bytes. A decode step reads every visible token's K and
// V row once (2 * D * 2 bytes per kv head) and does 4*D flops per query
// head on it, ~1 flop per byte at MHA, two orders of magnitude below the
// ridge. At Llama-2-7B (Hkv = 32, D = 128) a sequence at ctx 2048 streams
// 32 MiB per layer.
//
// Design: one block (128 threads) per (sequence, kv head); its G = H/Hkv
// query heads share every page read. The token loop is decode_attend of
// decode_common.cuh (a row group of lanes per token, no barrier in the
// loop, groups and warps merged at the end). A row that sees no token gives
// zeros. Splitting a long context across blocks is paged_splitk.cu (K7).
//
// int8 pages (the kv_quant pool; replaces _decode_kernel_quant :561,
// _decode_step_kernel_quant :1217, _decode_kernel_sidebuf_quant :772 and
// _sidebuf_batched_kernel_quant :792): the same kernel over int8 pages with
// f32 scale tiles, each token's scales folded into its score and p; the
// side rows are then f32 (kv_write_dequant values). Half the page bytes of
// bf16, so half the bound. The window and ALiBi branches are the same
// runtime arguments as over bf16 pages (the int8 bodies take window= and
// alibi= in the Pallas kernels too, e.g. :1134-1140).
#include "decode_common.cuh"

namespace dstorch {

template <int G, int LPR, typename KV, typename SIDE>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const bf16* __restrict__ q, DecodePage pg, const int* __restrict__ bt,
                    const int* __restrict__ lens, const SIDE* __restrict__ side_k,
                    const SIDE* __restrict__ side_v, int C, int j,
                    const float* __restrict__ slopes, bf16* __restrict__ out, int MB,
                    int window, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int s = blockIdx.x, hk = blockIdx.y;
  const int D = pg.D, H = pg.Hkv * G;
  pg.btr = bt + (size_t)s * MB;
  const size_t slab = (size_t)s * C * pg.Hkv * D;
  const int len = lens[s];
  int t_lo = 0, c_lo = 0;
  if (window > 0) {
    t_lo = max(side_k ? len + j + 1 - window : len - window, 0);
    c_lo = max(j + 1 - window, 0);
  }
  decode_attend<G, LPR, KV, SIDE>(q + ((size_t)s * H + hk * G) * D, pg, hk, t_lo, len,
                                  side_k ? side_k + slab : nullptr,
                                  side_v ? side_v + slab : nullptr,
                                  side_k ? j + 1 : 0, scale, smem, c_lo, slopes, len);
  for (int idx = threadIdx.x; idx < G * D; idx += kDecThreads) {
    const int g = idx / D, d = idx - (idx / D) * D;
    float M, L, A;
    decode_final<G>(smem, D, g, d, M, L, A);
    out[((size_t)s * H + hk * G + g) * D + d] = __float2bfloat16(L > 0.f ? A / L : 0.f);
  }
}

struct DecodeLaunch {
  const void *q, *bt, *lens, *side_k, *side_v, *slopes;
  void* out;
  DecodePage pg;
  int S, MB, C, j, window;
  float scale;
};

template <typename KV, typename SIDE, int G, int LPR>
int launch_paged_decode(const DecodeLaunch& a, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<G>(a.pg.D);
  auto kern = paged_decode_kernel<G, LPR, KV, SIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.S, a.pg.Hkv);
  kern<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), a.pg, static_cast<const int*>(a.bt),
      static_cast<const int*>(a.lens), static_cast<const SIDE*>(a.side_k),
      static_cast<const SIDE*>(a.side_v), a.C, a.j, static_cast<const float*>(a.slopes),
      static_cast<bf16*>(a.out), a.MB, a.window, a.scale);
  return (int)cudaGetLastError();
}

// int8 pages need D % 128 == 0 (the kv_quant gate): lanes per row 16 or 32
template <typename KV, typename SIDE, int G>
int dispatch_lpr(const DecodeLaunch& a, cudaStream_t st) {
  switch (decode_lpr(a.pg.D)) {
    case 16: return launch_paged_decode<KV, SIDE, G, 16>(a, st);
    case 32: return launch_paged_decode<KV, SIDE, G, 32>(a, st);
    default: break;
  }
  if constexpr (std::is_same<KV, bf16>::value) {
    switch (decode_lpr(a.pg.D)) {
      case 2: return launch_paged_decode<KV, SIDE, G, 2>(a, st);
      case 4: return launch_paged_decode<KV, SIDE, G, 4>(a, st);
      case 8: return launch_paged_decode<KV, SIDE, G, 8>(a, st);
      default: break;
    }
  }
  return -1;
}

template <typename KV, typename SIDE>
int dispatch_group(int G, const DecodeLaunch& a, cudaStream_t st) {
  switch (G) {
    case 1: return dispatch_lpr<KV, SIDE, 1>(a, st);
    case 2: return dispatch_lpr<KV, SIDE, 2>(a, st);
    case 4: return dispatch_lpr<KV, SIDE, 4>(a, st);
    case 8: return dispatch_lpr<KV, SIDE, 8>(a, st);
    default: return -1;
  }
}

}  // namespace dstorch

// q [S, H, D] bf16; kv [NB, 2, Hkv, bs, D] bf16 (one layer); bt [S, MB] and
// lens [S] int32 (page tokens attended per sequence); side_k/side_v
// [S, C*Hkv, D] bf16 or null, rows cc <= j attended after the pages;
// slopes [H] f32 (ALiBi) or null; window > 0 is the sliding window (0:
// none); out [S, H, D] bf16. Returns the cudaError_t of the launch (0 =
// success), -1 for an unsupported head dim or group size.
extern "C" int dstorch_paged_decode_bf16(const void* q, const void* kv, const void* bt,
                                         const void* lens, const void* side_k,
                                         const void* side_v, const void* slopes, void* out,
                                         int S, int H, int Hkv, int D, int bs, int MB,
                                         int C, int j, int window, float scale,
                                         void* stream) {
  if (S == 0) return 0;
  if (D % 8 != 0 || D > 256 || H % Hkv != 0) return -1;
  dstorch::DecodeLaunch a{q, bt, lens, side_k, side_v, slopes, out,
                          {kv, nullptr, 0, nullptr, Hkv, bs, D}, S, MB, C, j, window,
                          scale};
  return dstorch::dispatch_group<dstorch::bf16, dstorch::bf16>(
      H / Hkv, a, static_cast<cudaStream_t>(stream));
}

// The same over int8 pages kv with f32 scale tiles sc [NB, R8, 128]; the
// side rows are f32. D must be 128 or 256. slopes and window as for bf16
// pages: the window sets t_lo/c_lo (page tokens and side rows below the
// first visible one, and their scale-tile entries, are not read), and the
// ALiBi term is added after the softmax scale and the token's K scale.
extern "C" int dstorch_paged_decode_int8(const void* q, const void* kv, const void* sc,
                                         const void* bt, const void* lens,
                                         const void* side_k, const void* side_v,
                                         const void* slopes, void* out, int S, int H,
                                         int Hkv, int D, int bs, int MB, int r8, int C,
                                         int j, int window, float scale, void* stream) {
  if (S == 0) return 0;
  if ((D != 128 && D != 256) || H % Hkv != 0) return -1;
  dstorch::DecodeLaunch a{q, bt, lens, side_k, side_v, slopes, out,
                          {kv, static_cast<const float*>(sc), r8, nullptr, Hkv, bs, D},
                          S, MB, C, j, window, scale};
  return dstorch::dispatch_group<int8_t, float>(H / Hkv, a,
                                                static_cast<cudaStream_t>(stream));
}
