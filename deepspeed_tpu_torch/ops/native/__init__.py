"""The native host tier (the JAX package's ``ops/native/``): C++ async
file I/O and the host optimizer kernels of ``csrc/ds_native.cpp``, built
with ``g++`` at first use and bound with ``ctypes``. Host work (the
offloaded optimizer step, disk swaps, dtype conversion on the host) runs
here; device work stays in the CUDA kernels under ``ops/kernels``."""

from deepspeed_tpu_torch.ops.native.aio import (AIO_DEFAULT_DICT, AsyncIOHandle, aligned_empty,
                                                swap_in_tensors, swap_out_tensors)
from deepspeed_tpu_torch.ops.native.builder import NativeBuildError, load_native
from deepspeed_tpu_torch.ops.native.cpu_optimizer import (HostAdagrad, HostAdam, HostLion,
                                                          bf16_to_f32, f32_to_bf16)

__all__ = [
    "load_native", "NativeBuildError", "AsyncIOHandle", "aligned_empty",
    "swap_in_tensors", "swap_out_tensors", "AIO_DEFAULT_DICT", "HostAdam",
    "HostAdagrad", "HostLion", "f32_to_bf16", "bf16_to_f32",
]
