// Shared definitions of the port's paged attention kernels (sm_90a, bf16
// in, f32 accumulate, bf16 out): the bf16 type, the finite "minus
// infinity" of the split-K partials' empty pieces, and the head-dim
// dispatch of the kernels built for every head dim. The device code they
// share lives in mma_common.cuh (tensor-core tiles) and decode_common.cuh
// (the paged walk).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dstorch {

typedef __nv_bfloat16 bf16;

constexpr float kNegBig = -1e30f;

// Dispatch on the head dim (a compile-time template argument): 80 and 96
// are phi-2's and GPT-NeoX-20B's.
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
