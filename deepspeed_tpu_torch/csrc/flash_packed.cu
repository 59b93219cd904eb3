// Packed ragged-prefill flash attention (forward only), bf16, sm_90a.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:204
// flash_attention_packed (kernel body _fwd_kernel_packed, :145): rows of
// many sequences concatenated; row i attends row j iff j <= i and
// seg[i] == seg[j]. Padding rows carry segment -1 (they attend each other;
// their output is never read). GQA: kv head = h / (H / Hkv).
//
// Sliding window (window > 0; the Pallas kernel's window=, :166-183): a
// pair is also masked where q_idx - k_idx >= window. Row distance equals
// position distance because each segment's rows are contiguous and in
// position order (the scheduler checks that where it builds the batch).
// Key tiles wholly before the q-block's window start (its first row minus
// window - 1) are skipped: neither read nor computed. window = 0 is the
// unwindowed kernel.
//
// Bound on the H100 at the prefill shapes of Llama-2-7B (R = 768 packed
// rows, 32 heads, D = 128): q, k, v and out are 25 MB (7.5 us at 3.35
// TB/s); the causal pairs cost 4*D flops per head each, 4.8 GFLOP (4.9 us
// at 989 TFLOP/s bf16) when all 768 rows are one segment. So the bound is
// bytes at these shapes, with operations close behind and ahead for
// segments past ~1200 rows.
//
// Design: grid (head, q-block of 64 rows), 256 threads, the shared
// flash_block loop of attn_common.cuh (f32 FMAs on CUDA cores, online
// softmax, K/V tiles staged in shared memory). The key loop stops at the
// q-block's last row. This first version leaves the tensor cores idle, so
// it runs compute-limited far above either bound; mma.sync/wgmma tiles are
// the next step. Q-blocks are issued last-first: later rows see more keys.
#include "attn_common.cuh"

namespace dstorch {

template <int D>
__global__ void __launch_bounds__(kTileThreads)
flash_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    bf16* __restrict__ out, int R, int H, int Hkv, int window,
                    float scale) {
  extern __shared__ __align__(16) char smem[];
  const int nq = (R + kBQ - 1) / kBQ;
  const int h = blockIdx.x;
  const int qb = nq - 1 - (int)blockIdx.y;
  const int hk = h / (H / Hkv);
  const int r0 = qb * kBQ;
  const int n_q = min(kBQ, R - r0);
  const int n_keys = r0 + n_q;
  auto kv_row = [=](int key) {
    KVRowPtr p;
    p.k = k + ((size_t)key * Hkv + hk) * D;
    p.v = v + ((size_t)key * Hkv + hk) * D;
    return p;
  };
  auto mask = [=](int row, int key) {
    const int qi = r0 + row;
    return key <= qi && (window <= 0 || qi - key < window) &&
           __ldg(seg + key) == __ldg(seg + qi);
  };
  const int k_lo = window > 0 ? max(0, r0 - window + 1) : 0;
  const size_t off = ((size_t)r0 * H + h) * D;
  flash_block<D>(q + off, out + off, H * D, n_q, n_keys, kv_row, mask, scale, smem,
                 nullptr, k_lo);
}

template <int D>
int launch_flash_packed(const void* q, const void* k, const void* v, const void* seg,
                        void* out, int R, int H, int Hkv, int window, float scale,
                        cudaStream_t stream) {
  const size_t smem = FlashSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_packed_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, (R + kBQ - 1) / kBQ);
  flash_packed_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(seg),
      static_cast<bf16*>(out), R, H, Hkv, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace dstorch

// q [R, H, D], k/v [R, Hkv, D] bf16; seg [R] int32; out [R, H, D] bf16;
// window > 0 hides pairs window or more rows apart (0: no window).
// Returns the cudaError_t of the launch (0 = success), -1 for an
// unsupported head dim.
extern "C" int dstorch_flash_packed_bf16(const void* q, const void* k, const void* v,
                                         const void* seg, void* out, int R, int H,
                                         int Hkv, int D, int window, float scale,
                                         void* stream) {
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  DSTORCH_DISPATCH_D(D, dstorch::launch_flash_packed, q, k, v, seg, out, R, H, Hkv,
                     window, scale, st)
}
