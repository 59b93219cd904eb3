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
// Design: each (sequence, kv head) is a thread-block cluster of n_cl in
// {1, 2, 4, 8} blocks of 128 threads (cudaLaunchKernelEx with a cluster
// dimension; the host picks n_cl from S * Hkv and the SM count, never from
// lens). Rank r walks slice r of the sequence's visible page range [lo,
// len) (decode_piece: n_cl contiguous slices of ceil((len - lo) / n_cl)
// tokens) with decode_pages of decode_common.cuh: the table slice staged in
// shared memory, a 3-stage cp.async ring of 64-token K/V tiles, the G =
// H/Hkv query heads of the kv head as the n columns of mma.sync products
// that share every page read. The side rows go to the last rank
// (decode_side, f32). Each rank merges its warps' states in shared memory;
// rank 0 then merges the ranks' states in rank order through distributed
// shared memory (cluster.map_shared_rank) and writes the bf16 output, so
// the output needs no global scratch and no second launch, and does not
// depend on timing. Every rank reaches both cluster barriers, whatever its
// slice holds. A row that sees no token gives zeros. Splitting a long
// context across launches with an lse output is paged_splitk.cu (K7).
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

namespace cg = cooperative_groups;

// grid (S * n_cl, Hkv), clusters of (n_cl, 1, 1): blockIdx.x = s * n_cl + rank
template <int DP, typename KV, typename SIDE>
__global__ void __launch_bounds__(kDecThreads, 1)
paged_decode_kernel(const bf16* __restrict__ q, DecodePage pg, const int* __restrict__ bt,
                    const int* __restrict__ lens, const SIDE* __restrict__ side_k,
                    const SIDE* __restrict__ side_v, int C, int j,
                    const float* __restrict__ slopes, bf16* __restrict__ out, int MB,
                    int window, float scale, int G, int tbl_cap) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cl = (int)cluster.dim_blocks().x;
  const int hk = blockIdx.y;
  const int D = pg.D, H = pg.Hkv * G;
  const int s = blockIdx.x / n_cl, rank = (int)cluster.block_rank();
  pg.btr = bt + (size_t)s * MB;
  const int len = min(lens[s], MB * pg.bs);
  const bf16* qrow = q + ((size_t)s * H + hk * G) * D;
  int lo, c_lo, b_lo, b_hi;
  decode_visible(len, side_k != nullptr, j, window, lo, c_lo);
  decode_piece(lo, len, n_cl, rank, b_lo, b_hi);
  const float scale_log2 = scale * kDecLog2e;
  decode_pages<DP, KV>(qrow, G, pg, hk, b_lo, b_hi, scale_log2, slopes, smem, tbl_cap);
  char* body = smem + DecodeSmem<DP, KV>::table_bytes(tbl_cap);
  const bool side = side_k != nullptr && rank == n_cl - 1;
  if (side) {
    const size_t slab = (size_t)s * C * pg.Hkv * D;
    decode_side<DP, SIDE>(qrow, G, D, side_k + slab, side_v + slab, pg.Hkv, hk, c_lo, j + 1,
                          len, scale_log2, slopes, body);
  }
  decode_merge<DP>(body, side ? kDecSlots : kDecWarps);
  cluster.sync();   // every rank's merged state is in its shared memory
  if (rank == 0) {
    DecodeStates<DP> sts(body);
    for (int idx = threadIdx.x; idx < G * D; idx += kDecThreads) {
      const int h = idx / D, d = idx - (idx / D) * D;
      float M = -INFINITY;
      for (int r = 0; r < n_cl; ++r) M = fmaxf(M, cluster.map_shared_rank(sts.fin_m, r)[h]);
      float L = 0.f, A = 0.f;
      for (int r = 0; r < n_cl; ++r) {
        const float lr = cluster.map_shared_rank(sts.fin_l, r)[h];
        const float w = lr > 0.f ? mma::exp2_approx(cluster.map_shared_rank(sts.fin_m, r)[h] - M)
                                 : 0.f;
        L = fmaf(lr, w, L);
        A = fmaf(cluster.map_shared_rank(sts.fin_acc, r)[h * DP + d], w, A);
      }
      out[((size_t)s * H + hk * G + h) * D + d] =
          __float2bfloat16(L > 0.f ? __fdividef(A, L) : 0.f);
    }
  }
  cluster.sync();   // rank 0 has read the other ranks' shared memory
}

struct DecodeLaunch {
  const void *q, *bt, *lens, *side_k, *side_v, *slopes;
  void* out;
  DecodePage pg;
  int S, G, MB, C, j, window, n_cl;
  float scale;
};

// block-table entries a rank stages: its slice is at most ceil(MB bs / n_cl) tokens
inline int decode_cap(int MB, int bs, int n_cl) {
  return decode_table_cap(MB, (MB * bs + n_cl - 1) / n_cl, bs);
}

template <int DP, typename KV, typename SIDE>
int launch_paged_decode(const DecodeLaunch& a, cudaStream_t stream) {
  const int cap = decode_cap(a.MB, a.pg.bs, a.n_cl);
  const size_t smem = DecodeSmem<DP, KV>::bytes(cap);
  auto kern = paged_decode_kernel<DP, KV, SIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S * a.n_cl, a.pg.Hkv);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(a.q), a.pg,
                           static_cast<const int*>(a.bt), static_cast<const int*>(a.lens),
                           static_cast<const SIDE*>(a.side_k),
                           static_cast<const SIDE*>(a.side_v), a.C, a.j,
                           static_cast<const float*>(a.slopes), static_cast<bf16*>(a.out),
                           a.MB, a.window, a.scale, a.G, cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// bf16 pages at the padded head dims; int8 pages at D 128 and 256 (the
// kv_quant gate)
template <typename KV, typename SIDE>
int dispatch_decode(const DecodeLaunch& a, cudaStream_t st) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    switch (a.pg.D) {
      case 128: return launch_paged_decode<128, KV, SIDE>(a, st);
      case 256: return launch_paged_decode<256, KV, SIDE>(a, st);
      default: return -1;
    }
  } else {
    switch (decode_dp(a.pg.D)) {
      case 16: return launch_paged_decode<16, KV, SIDE>(a, st);
      case 32: return launch_paged_decode<32, KV, SIDE>(a, st);
      case 64: return launch_paged_decode<64, KV, SIDE>(a, st);
      case 80: return launch_paged_decode<80, KV, SIDE>(a, st);
      case 96: return launch_paged_decode<96, KV, SIDE>(a, st);
      case 128: return launch_paged_decode<128, KV, SIDE>(a, st);
      case 256: return launch_paged_decode<256, KV, SIDE>(a, st);
      default: return -1;
    }
  }
}

template <int DP, typename KV, typename SIDE>
int decode_attrs(int cap, int* out) {
  return mma::kernel_attributes(paged_decode_kernel<DP, KV, SIDE>, kDecThreads,
                                DecodeSmem<DP, KV>::bytes(cap), out);
}

inline bool decode_shape_ok(int S, int H, int Hkv, int n_cl) {
  return S >= 0 && Hkv > 0 && H % Hkv == 0 && H / Hkv <= kDecHeads
         && (n_cl == 1 || n_cl == 2 || n_cl == 4 || n_cl == 8);
}

}  // namespace dstorch

// q [S, H, D] bf16; kv [NB, 2, Hkv, bs, D] bf16 (one layer); bt [S, MB] and
// lens [S] int32 (page tokens attended per sequence); side_k/side_v
// [S, C*Hkv, D] bf16 or null, rows cc <= j attended after the pages;
// slopes [H] f32 (ALiBi) or null; window > 0 is the sliding window (0:
// none); out [S, H, D] bf16; n_cl in {1, 2, 4, 8} blocks a (sequence, kv
// head) cluster. Returns the cudaError_t of the launch (0 = success), -1
// for an unsupported head dim, group size (H / Hkv <= 8) or cluster size.
extern "C" int dstorch_paged_decode_bf16(const void* q, const void* kv, const void* bt,
                                         const void* lens, const void* side_k,
                                         const void* side_v, const void* slopes, void* out,
                                         int S, int H, int Hkv, int D, int bs, int MB,
                                         int C, int j, int window, float scale, int n_cl,
                                         void* stream) {
  if (D % 8 != 0 || D > 256 || !dstorch::decode_shape_ok(S, H, Hkv, n_cl)) return -1;
  if (S == 0) return 0;
  dstorch::DecodeLaunch a{q, bt, lens, side_k, side_v, slopes, out,
                          {kv, nullptr, 0, nullptr, Hkv, bs, D}, S, H / Hkv, MB, C, j,
                          window, n_cl, scale};
  return dstorch::dispatch_decode<dstorch::bf16, dstorch::bf16>(
      a, static_cast<cudaStream_t>(stream));
}

// The same over int8 pages kv with f32 scale tiles sc [NB, R8, 128]; the
// side rows are f32. D must be 128 or 256. slopes and window as for bf16
// pages: the window sets the first visible page token and side row (page
// tokens and side rows below them, and their scale-tile entries, are not
// read), and the ALiBi term is added after the softmax scale and the
// token's K scale.
extern "C" int dstorch_paged_decode_int8(const void* q, const void* kv, const void* sc,
                                         const void* bt, const void* lens,
                                         const void* side_k, const void* side_v,
                                         const void* slopes, void* out, int S, int H,
                                         int Hkv, int D, int bs, int MB, int r8, int C,
                                         int j, int window, float scale, int n_cl,
                                         void* stream) {
  if ((D != 128 && D != 256) || !dstorch::decode_shape_ok(S, H, Hkv, n_cl)) return -1;
  if (S == 0) return 0;
  dstorch::DecodeLaunch a{q, bt, lens, side_k, side_v, slopes, out,
                          {kv, static_cast<const float*>(sc), r8, nullptr, Hkv, bs, D},
                          S, H / Hkv, MB, C, j, window, n_cl, scale};
  return dstorch::dispatch_decode<int8_t, float>(a, static_cast<cudaStream_t>(stream));
}

// Attributes of the decode kernel's instance for int8 pages (int8 != 0) or
// bf16 pages at head dim D, staging `cap` block-table entries: out[0..5] as
// mma::kernel_attributes. Returns the cudaError_t, -1 for no such instance.
extern "C" int dstorch_paged_decode_attrs(int int8, int D, int cap, int* out) {
  using dstorch::bf16;
  if (int8) {
    switch (D) {
      case 128: return dstorch::decode_attrs<128, int8_t, float>(cap, out);
      case 256: return dstorch::decode_attrs<256, int8_t, float>(cap, out);
      default: return -1;
    }
  }
  switch (D) {
    case 16: return dstorch::decode_attrs<16, bf16, bf16>(cap, out);
    case 32: return dstorch::decode_attrs<32, bf16, bf16>(cap, out);
    case 64: return dstorch::decode_attrs<64, bf16, bf16>(cap, out);
    case 80: return dstorch::decode_attrs<80, bf16, bf16>(cap, out);
    case 96: return dstorch::decode_attrs<96, bf16, bf16>(cap, out);
    case 128: return dstorch::decode_attrs<128, bf16, bf16>(cap, out);
    case 256: return dstorch::decode_attrs<256, bf16, bf16>(cap, out);
    default: return -1;
  }
}
