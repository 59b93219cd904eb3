// Batched prompt-chunk attention over paged KV, bf16, sm_90a.
//
// Replaces deepspeed_tpu/ops/pallas/paged_attention.py:1534
// paged_chunk_attention_batched (kernel body _chunk_kernel_batched, :1443):
// several prompt chunks per launch, each slot with its own block-table row,
// q_start and ctx; query row r of slot sl sits at position q_start + r and
// sees keys k_pos <= q_pos with k_pos < ctx. An empty slot (ctx 0) gives
// zeros. Pages are [NB, 2, Hkv, bs, D] (K = 0, V = 1), one layer's view.
//
// Sliding window (window > 0; the Pallas kernel's window, :1466-1478):
// keys also need k_pos > q_pos - window, and each (slot, q-block) block
// starts its key walk at its first row's window start, so pages wholly
// below the lowest key the block sees are neither read nor computed.
// Masking is by logical position, so block tables that repeat physical
// pages (the scheduler's page ring) read the right tokens. window = 0 is
// the unwindowed kernel.
//
// ALiBi (slopes != null; the Pallas kernel's alibi, :1493-1498): each
// visible score of q-head h (kv head * G + g) gets slopes[h] * k_pos, the
// key's absolute position, added in f32 after the scale and before the
// running max (flash_block's compile-time bias hook, so the unbiased
// kernel's arithmetic is unchanged). Masked keys are never biased.
//
// Bound on the H100 at the continuation shapes of Llama-2-7B (6 slots x
// 128 rows, 32 heads, D = 128, ctx 2048/1536/1000/300/128/0): the pages
// read once are 82 MB and q/out 13 MB (28 us at 3.35 TB/s), against
// ~10 GFLOP of 4*D flops per visible key and head (10 us at 989 TFLOP/s
// bf16): bytes. Each (q-block, head) block reads its kv head's keys
// itself, so the kernel reads every page (Cs/64) * (H/Hkv) times (mostly
// from L2).
//
// Design: grid (slot, q-block of 64 rows, head), 256 threads. Each block
// reads its own block-table row and (q_start, ctx), then walks keys up to
// min(ctx, q_start + last row + 1) through the shared flash_block loop of
// attn_common.cuh, gathering each key's K and V row through the block
// table while staging a 64-key tile, so tiles may straddle pages. f32 FMAs
// on CUDA cores make it compute-limited far above either bound; tensor-core
// tiles over all of a kv head's query heads are the next step.
//
// int8 pages (the kv_quant pool; replaces _chunk_kernel_batched_quant,
// :1528): the same loop over int8 pages and their f32 scale tiles
// [NB, R8, 128] (flat index kv*Hkv*bs + h*bs + t per page). Each key's K
// scale multiplies its score column and its V scale its p column
// (_chunk_head_scale, :1422), in f32. Half the page bytes of bf16. The
// window and ALiBi branches are the bf16 kernel's (:1466-1478, :1493-1498):
// under a window the key walk starts at the q-block's first row's window
// start, so pages wholly below it are not read and neither are their
// scale-tile entries (kv_row reads a key's scales only with its row).
#include "attn_common.cuh"

namespace dstorch {

// KV = bf16 (pages) or int8_t (pages + scale tiles `sc`, R8 rows per page);
// ALIBI reads the q heads' slopes [H]
template <int D, typename KV, bool ALIBI>
__global__ void __launch_bounds__(kTileThreads)
paged_chunk_kernel(const bf16* __restrict__ q, const KV* __restrict__ kv,
                   const float* __restrict__ sc, int r8, const int* __restrict__ bt,
                   const int* __restrict__ q_starts, const int* __restrict__ ctx_lens,
                   const float* __restrict__ slopes, bf16* __restrict__ out, int Cs,
                   int H, int Hkv, int bs, int MB, int window, float scale) {
  extern __shared__ __align__(16) char smem[];
  const int sl = blockIdx.x, qb = blockIdx.y, h = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = q_starts[sl];
  const int ctx = ctx_lens[sl];
  const int r0 = qb * kBQ;
  const int n_q = min(kBQ, Cs - r0);
  const int n_keys = max(0, min(ctx, q0 + r0 + n_q));
  const int* btr = bt + (size_t)sl * MB;
  const size_t page_elems = (size_t)2 * Hkv * bs * D;
  auto kv_row = [=](int key) {
    const int pi = key / bs;
    const int slot = key - pi * bs;
    const int pg = __ldg(btr + pi);
    const KV* page = kv + (size_t)pg * page_elems;
    if constexpr (std::is_same<KV, int8_t>::value) {
      const float* ps = sc + (size_t)pg * r8 * 128;
      KVRowPtrI8 p;
      p.k = page + ((size_t)hk * bs + slot) * D;
      p.v = page + ((size_t)(Hkv + hk) * bs + slot) * D;
      p.ks = __ldg(ps + hk * bs + slot);
      p.vs = __ldg(ps + (Hkv + hk) * bs + slot);
      return p;
    } else {
      KVRowPtr p;
      p.k = page + ((size_t)hk * bs + slot) * D;
      p.v = page + ((size_t)(Hkv + hk) * bs + slot) * D;
      return p;
    }
  };
  auto mask = [=](int row, int key) {
    const int qp = q0 + r0 + row;
    return key <= qp && (window <= 0 || qp - key < window);
  };
  const int k_lo = window > 0 ? max(0, q0 + r0 - window + 1) : 0;
  const size_t off = (((size_t)sl * Cs + r0) * H + h) * D;
  if constexpr (ALIBI)
    flash_block<D>(q + off, out + off, H * D, n_q, n_keys, kv_row, mask, scale, smem,
                   nullptr, k_lo, AlibiBias{__ldg(slopes + h)});
  else
    flash_block<D>(q + off, out + off, H * D, n_q, n_keys, kv_row, mask, scale, smem,
                   nullptr, k_lo);
}

template <int D, typename KV, bool ALIBI = false>
int launch_paged_chunk(const void* q, const void* kv, const void* sc, int r8,
                       const void* bt, const void* q_starts, const void* ctx_lens,
                       const void* slopes, void* out, int NC, int Cs, int H, int Hkv,
                       int bs, int MB, int window, float scale, cudaStream_t stream) {
  const size_t smem = FlashSmem<D, std::is_same<KV, int8_t>::value>::bytes;
  auto kern = paged_chunk_kernel<D, KV, ALIBI>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(NC, (Cs + kBQ - 1) / kBQ, H);
  kern<<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(kv),
      static_cast<const float*>(sc), r8, static_cast<const int*>(bt),
      static_cast<const int*>(q_starts), static_cast<const int*>(ctx_lens),
      static_cast<const float*>(slopes), static_cast<bf16*>(out), Cs, H, Hkv, bs, MB,
      window, scale);
  return (int)cudaGetLastError();
}

// ALIBI is a compile-time branch (flash_block's bias hook), picked here by
// slopes != null for either page type
template <int D, typename KV>
int launch_paged_chunk_any(const void* q, const void* kv, const void* sc, int r8,
                           const void* bt, const void* q_starts, const void* ctx_lens,
                           const void* slopes, void* out, int NC, int Cs, int H, int Hkv,
                           int bs, int MB, int window, float scale, cudaStream_t stream) {
  if (slopes != nullptr)
    return launch_paged_chunk<D, KV, true>(q, kv, sc, r8, bt, q_starts, ctx_lens, slopes,
                                           out, NC, Cs, H, Hkv, bs, MB, window, scale,
                                           stream);
  return launch_paged_chunk<D, KV>(q, kv, sc, r8, bt, q_starts, ctx_lens, nullptr, out, NC,
                                   Cs, H, Hkv, bs, MB, window, scale, stream);
}

template <int D>
int launch_paged_chunk_bf16(const void* q, const void* kv, const void* bt,
                            const void* q_starts, const void* ctx_lens, const void* slopes,
                            void* out, int NC, int Cs, int H, int Hkv, int bs, int MB,
                            int window, float scale, cudaStream_t stream) {
  return launch_paged_chunk_any<D, bf16>(q, kv, nullptr, 0, bt, q_starts, ctx_lens, slopes,
                                         out, NC, Cs, H, Hkv, bs, MB, window, scale, stream);
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
