// Packed ragged-prefill flash attention (forward, optional lse), bf16,
// sm_90a, on the tensor cores.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:204
// flash_attention_packed (kernel body _fwd_kernel_packed, :145), every
// branch: rows of many sequences concatenated, q [R, H, D], k/v [R, Hkv,
// D] (row stride H*D, Hkv*D; GQA kv head h / (H / Hkv), any H, e.g.
// Falcon-7B's 71/1). Row i sees row j iff j <= i, seg[i] == seg[j] and,
// under a sliding window (window > 0; the Pallas kernel's window=,
// :166-183), i - j < window. Padding rows carry segment -1 and see each
// other; their output is never read. With an lse pointer each row's
// log-sum-exp of its scaled scores, m * scale + log l, goes to lse [R, H]
// f32 (-1e30 where l is 0; the Pallas kernel's with_lse=True, :196-201).
// Row distance is position distance because each segment's rows are
// contiguous and in position order (scheduler.schedule_pass checks that
// where it builds the batch).
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s). Llama-2-7B's prefill
// pass, R = 768 rows in segments of 300/200/150/100 plus 18 padding rows,
// 32 heads, D = 128: q, k, v and o are 25.2 MB (7.5 us); the 81796
// visible pairs a head cost 4*D flops each, 1.34 GFLOP (1.4 us): bytes.
// Mistral-7B's, R = 4640 (segments 4224/300/100 plus 16 padding), 32/8
// heads, window 4096: 95.0 MB (28.4 us) against 287 M visible pairs x
// 4*128 flops = 146.9 GFLOP (148.5 us): operations.
//
// Design (flash_fwd.cu's forward on mma_common.cuh): grid (head, q-block
// of 64 rows), 4 warps of 16 query rows. Q is loaded once by cp.async and
// held in A fragments (read from shared memory each tile at D = 256, where
// the f32 O accumulator alone takes 128 registers a thread). K, V and the
// keys' segment ids stream through shared memory in tiles of 64 keys (32
// at D = 256), two stages deep. S = Q.K^T on mma.sync into f32
// registers, the online softmax on the accumulator fragments, P packed to
// bf16 in registers as the A operand of O += P.V. Skipped, neither read
// nor computed: keys past the q-block's last row, keys below its window
// start, and tiles wholly before the segment of its first row (found in
// the kernel by a ballot over the tiles' last keys: segments are
// contiguous). Each warp also skips the tiles above its rows' diagonal,
// below its own window start and before its own first row's segment. A
// warp that holds a padding row also reads from the first padding key at
// or after the block's window start (padding sees all earlier padding;
// the block scans for it). The mask is evaluated only in edge tiles: the
// diagonal, the window's first tiles, tiles that may hold another
// segment's keys, and every tile of a warp with padding rows; cp.async
// zero-fills keys past the last row, so a masked p of 0 never meets NaN.
// Q-blocks are issued last-first.
//
// Head dims 16, 32, 64, 80, 96, 128 and 256 through one template (80 and
// 96 use mma_common's in-row swizzles). Left for later: wgmma and TMA
// loads, overlapping the softmax with the next tile's products, o stored
// in 16-byte rows.
#include <limits.h>

#include "mma_common.cuh"

namespace dstorch {

using mma::bf16;

constexpr int kPkWarps = 4;
constexpr int kPkBQ = 16 * kPkWarps, kPkThreads = 32 * kPkWarps;

// keys per tile: 32 at D = 256 keeps the score tile and shared memory small
template <int D>
constexpr int kPkBK = D > 128 ? 32 : 64;

// Q, two stages of K and V tiles, two stages of the keys' segment ids
template <int D>
constexpr size_t packed_smem_bytes() {
  return (size_t)(kPkBQ + 4 * kPkBK<D>) * D * sizeof(bf16) + 2 * kPkBK<D> * sizeof(int);
}

// Warp-uniform: the first of the tiles [t_lo, x / BK] that may hold a key
// of row x's segment (x a segment row, not padding). Tile t < x / BK lies
// wholly before the segment iff its last key's segment differs from x's,
// and those tiles are a prefix (segments are contiguous), so one ballot
// over 32 tiles counts them.
template <int BK>
__device__ __forceinline__ int first_tile(const int* __restrict__ seg, int x, int t_lo,
                                          int lane) {
  const int s = __ldg(seg + x), last = x / BK;
  int t = t_lo;
  while (t < last) {
    const int tt = t + lane;
    const bool before = tt < last && __ldg(seg + tt * BK + BK - 1) != s;
    const unsigned b = __ballot_sync(0xffffffffu, before);
    if (b != 0xffffffffu) return t + __popc(b);
    t += 32;
  }
  return t < last ? t : last;
}

template <int D>
__global__ void __launch_bounds__(kPkThreads)
flash_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    bf16* __restrict__ out, float* __restrict__ lse, int R, int H, int Hkv,
                    int window, float scale) {
  constexpr int BQ = kPkBQ, BK = kPkBK<D>, NT = BK / 8, THREADS = kPkThreads;
  constexpr bool kQRegs = D <= 128;
  extern __shared__ __align__(128) char smem[];
  __shared__ int warp_lo[kPkWarps];
  // Q, then stage 0's K and V tiles, then stage 1's, then the segment ids
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  auto k_tile = [=](int s) { return Qs + (BQ + 2 * BK * s) * D; };
  auto v_tile = [=](int s) { return Qs + (BQ + 2 * BK * s + BK) * D; };
  int* seg_tiles = reinterpret_cast<int*>(Qs + (BQ + 4 * BK) * D);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, hk = h / (H / Hkv);
  const int nq = (R + BQ - 1) / BQ;
  const int r0 = (nq - 1 - (int)blockIdx.y) * BQ;
  const int n_q = min(BQ, R - r0);
  const int n_keys = r0 + n_q;  // no row of the block sees a later key
  const int last_tile = (n_keys - 1) / BK;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const bf16* kb = k + (size_t)hk * D;
  const bf16* vb = v + (size_t)hk * D;
  const int wr0 = r0 + 16 * warp;  // the warp's first query row
  const bool live = wr0 < R;
  const int wl = min(wr0 + 15, R - 1);

  mma::load_tile<D, BQ, THREADS>(Qs, q + ((size_t)r0 * H + h) * D, q_stride, n_q, tid);
  mma::cp_async_commit();

  // The tiles this warp reads start at w_lo: its first row's segment (or
  // window) start, and with padding rows the first padding key at or after
  // the block's window start. Tiles up to w_seg may hold keys of a segment
  // other than its rows' (every tile, with padding rows).
  __shared__ int first_pad;
  int real_lo = INT_MAX, w_seg = INT_MAX, win_lo = 0;
  bool pad = false;
  if (tid == 0) first_pad = n_keys;
  if (live) {
    const int rr = wr0 + (lane & 15);
    pad = __any_sync(0xffffffffu, rr < R && __ldg(seg + rr) < 0);
    win_lo = window > 0 ? max(0, wr0 - window + 1) / BK : 0;
    if (__ldg(seg + wr0) >= 0) real_lo = first_tile<BK>(seg, wr0, win_lo, lane);
    if (!pad) w_seg = first_tile<BK>(seg, wl, real_lo, lane);
  }
  if (__syncthreads_or(pad)) {
    // 4 keys a thread a round, until a round finds padding
    for (int base = (window > 0 ? max(0, r0 - window + 1) : 0) & ~3;; base += 4 * THREADS) {
      int found = INT_MAX;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = base + 4 * tid + e;
        if (key < n_keys && __ldg(seg + key) < 0) found = min(found, key);
      }
      if (found != INT_MAX) atomicMin(&first_pad, found);
      if (__syncthreads_or(found != INT_MAX) || base + 4 * THREADS >= n_keys) break;
    }
  }
  const int w_lo = min(real_lo, pad ? max(win_lo, first_pad / BK) : INT_MAX);
  if (lane == 0) warp_lo[warp] = w_lo;
  __syncthreads();
  int t0 = warp_lo[0];
#pragma unroll
  for (int w = 1; w < kPkWarps; ++w) t0 = min(t0, warp_lo[w]);

  auto load_kv = [&](int j, int s) {
    const int k0 = j * BK, n = min(BK, n_keys - k0);
    mma::load_tile<D, BK, THREADS>(k_tile(s), kb + (size_t)k0 * kv_stride, kv_stride, n, tid);
    mma::load_tile<D, BK, THREADS>(v_tile(s), vb + (size_t)k0 * kv_stride, kv_stride, n, tid);
    mma::load_vec<BK, THREADS>(reinterpret_cast<float*>(seg_tiles + BK * s),
                               reinterpret_cast<const float*>(seg + k0), n, tid);
  };
  load_kv(t0, 0);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kQRegs ? D / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) mma::ldsm_a<D>(qf[kc], Qs, 16 * warp, kc, lane);
  }
  int seg_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr0 + g + 8 * i;
    seg_row[i] = row < R ? __ldg(seg + row) : 0;
  }

  float acc[D / 8][4];
  mma::zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float scale_log2 = scale * mma::kLog2e;

  for (int j = t0; j <= last_tile; ++j) {
    const int s = (j - t0) & 1, k0 = j * BK;
    if (j < last_tile) {
      load_kv(j + 1, s ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    if (live && j >= w_lo && k0 <= wr0 + 15) {
      float sc[NT][4];
      mma::zero(sc);
      if constexpr (kQRegs)
        mma::gemm_abt<D, NT>(sc, qf, k_tile(s), lane);
      else
        mma::gemm_abt<D, NT>(sc, Qs, 16 * warp, k_tile(s), lane);
      if (k0 + BK - 1 > wr0 || j <= w_seg || (window > 0 && k0 <= wr0 + 15 - window)) {
        const int* sk = seg_tiles + BK * s;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = 8 * n + 2 * t + (e & 1), key = k0 + kk;
            const int row = wr0 + g + 8 * (e >> 1);
            const bool ok = key <= row && row < R && sk[kk] == seg_row[e >> 1] &&
                            (window <= 0 || row - key < window);
            if (!ok) sc[n][e] = -INFINITY;
          }
      }
      float alpha[2];
      mma::online_softmax<NT>(sc, m, l, alpha, scale_log2);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      mma::gemm_pb<D, NT>(acc, sc, v_tile(s), lane);
    }
    __syncthreads();  // stage s is free for tile j + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = mma::quad_sum(l[i]);
    const int row = wr0 + g + 8 * i;
    if (row >= R) continue;
    const float inv = li > 0.f ? 1.f / li : 0.f;
    bf16* orow = out + ((size_t)row * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(size_t)row * H + h] = li > 0.f ? m[i] * scale + logf(li) : -1e30f;
  }
}

template <int D>
int launch_flash_packed(const void* q, const void* k, const void* v, const void* seg,
                        void* out, void* lse, int R, int H, int Hkv, int window, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = packed_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_packed_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, (R + kPkBQ - 1) / kPkBQ);
  flash_packed_kernel<D><<<grid, kPkThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(seg), static_cast<bf16*>(out),
      static_cast<float*>(lse), R, H, Hkv, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int packed_attributes(int* out) {
  return mma::kernel_attributes(flash_packed_kernel<D>, kPkThreads, packed_smem_bytes<D>(),
                                out);
}

}  // namespace dstorch

// K2's head dims: returns FN<D>(...), or -1 for any other head dim
#define DSTORCH_PACKED_DISPATCH_D(D, FN, ...) \
  switch (D) {                                \
    case 16: return FN<16>(__VA_ARGS__);      \
    case 32: return FN<32>(__VA_ARGS__);      \
    case 64: return FN<64>(__VA_ARGS__);      \
    case 80: return FN<80>(__VA_ARGS__);      \
    case 96: return FN<96>(__VA_ARGS__);      \
    case 128: return FN<128>(__VA_ARGS__);    \
    case 256: return FN<256>(__VA_ARGS__);    \
    default: return -1;                       \
  }

// q [R, H, D], k/v [R, Hkv, D] bf16; seg [R] int32; out [R, H, D] bf16;
// lse [R, H] f32 or null (not written); window > 0 hides pairs window or
// more rows apart (0: no window). D in {16, 32, 64, 80, 96, 128, 256}.
// Returns the cudaError_t of the launch (0 = success), -1 for an
// unsupported head dim.
extern "C" int dstorch_flash_packed_bf16(const void* q, const void* k, const void* v,
                                         const void* seg, void* out, void* lse, int R, int H,
                                         int Hkv, int D, int window, float scale,
                                         void* stream) {
  if (R == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_PACKED_DISPATCH_D(D, dstorch::launch_flash_packed, q, k, v, seg, out, lse, R, H,
                            Hkv, window, scale, st)
}

// K2's attributes at head dim D (mma::kernel_attributes: registers, spill
// bytes, static and dynamic shared bytes, threads, blocks an SM) into
// out[0..5]; returns the cudaError_t, -1 for an unsupported head dim
extern "C" int dstorch_flash_packed_attrs(int D, void* out) {
  int* o = static_cast<int*>(out);
  DSTORCH_PACKED_DISPATCH_D(D, dstorch::packed_attributes, o)
}
