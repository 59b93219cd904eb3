// Flash attention forward with log-sum-exp (training), bf16, sm_90a.
//
// Replaces deepspeed_tpu/ops/pallas/flash_attention.py:54 _fwd_kernel
// (launched by _fwd, :100): q [B, Tq, H, D], k/v [B, Tk, H, D] -> o
// [B, Tq, H, D] and lse [B, H, Tq] f32 (the backward's input). Causal
// masking is TOP-LEFT aligned, as in the Pallas kernel: query i sees key j
// iff j <= i, also when Tq != Tk. A row that sees no key gets o = 0 and
// lse = -1e30.
//
// Bound on the H100 at GPT-2 small's training shape (B = 8, H = 12, T =
// 1024, D = 64, causal): q, k, v and o are 12.6 MB each and lse 0.4 MB,
// 50.7 MB in all (15.1 us at 3.35 TB/s); the 50.4 M visible (query, key)
// pairs cost 4*D flops each, 12.9 GFLOP (13.0 us at 989 TFLOP/s bf16). So the
// bound is bytes, with operations close behind.
//
// Design: grid (B*H, q-block of 64 rows), 256 threads, the shared
// flash_block loop of attn_common.cuh (f32 FMAs on CUDA cores, online
// softmax, K/V tiles in shared memory) reading the [B, T, H, D] layout
// directly (row stride H*D, no transpose) and writing each row's lse. The
// TPU kernel's sequential KV grid axis is the loop inside the block; causal
// blocks stop at the q-block's last row. Q-blocks are issued last-first:
// later rows see more keys. The tensor cores stay idle in this first
// version, so it runs compute-limited far above the bound.
#include "attn_common.cuh"

namespace dstorch {

template <int D>
__global__ void __launch_bounds__(kTileThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int H, float scale,
                 int causal) {
  extern __shared__ __align__(16) char smem[];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int nq = (Tq + kBQ - 1) / kBQ;
  const int r0 = (nq - 1 - (int)blockIdx.y) * kBQ;
  const int n_q = min(kBQ, Tq - r0);
  const int n_keys = causal ? min(Tk, r0 + n_q) : Tk;
  const bf16* kb = k + ((size_t)b * Tk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Tk * H + h) * D;
  const size_t kv_stride = (size_t)H * D;
  auto kv_row = [=](int key) {
    KVRowPtr p;
    p.k = kb + key * kv_stride;
    p.v = vb + key * kv_stride;
    return p;
  };
  auto mask = [=](int row, int key) { return !causal || key <= r0 + row; };
  const size_t off = (((size_t)b * Tq + r0) * H + h) * D;
  flash_block<D>(q + off, o + off, H * D, n_q, n_keys, kv_row, mask, scale, smem,
                 lse + (size_t)bh * Tq + r0);
}

template <int D>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                     int B, int Tq, int Tk, int H, float scale, int causal,
                     cudaStream_t stream) {
  const size_t smem = FlashSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Tq + kBQ - 1) / kBQ);
  flash_fwd_kernel<D><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
      Tq, Tk, H, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace dstorch

// q [B, Tq, H, D], k/v [B, Tk, H, D] bf16 -> o [B, Tq, H, D] bf16, lse
// [B, H, Tq] f32. D in {16, 32, 64, 128}. Returns the cudaError_t of the
// launch (0 = success), -1 for an unsupported head dim.
extern "C" int dstorch_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                      void* o, void* lse, int B, int Tq, int Tk,
                                      int H, int D, float scale, int causal,
                                      void* stream) {
  if (B == 0 || Tq == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return dstorch::launch_flash_fwd<16>(q, k, v, o, lse, B, Tq, Tk, H, scale, causal, st);
    case 32: return dstorch::launch_flash_fwd<32>(q, k, v, o, lse, B, Tq, Tk, H, scale, causal, st);
    case 64: return dstorch::launch_flash_fwd<64>(q, k, v, o, lse, B, Tq, Tk, H, scale, causal, st);
    case 128: return dstorch::launch_flash_fwd<128>(q, k, v, o, lse, B, Tq, Tk, H, scale, causal, st);
    default: return -1;
  }
}
