"""Host tensor swapping (the JAX package's ``runtime/swap_tensor/``): the
pinned bounce-buffer pool and the NVMe optimizer-state swappers, over the
native AIO engine (``ops/native/aio.py``)."""

from deepspeed_tpu_torch.runtime.swap_tensor.buffer_pool import SwapBufferPool
from deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper import (
    OptimizerStateSwapper, PipelinedOptimizerSwapper, SwappedTensorMeta)

__all__ = ["SwapBufferPool", "OptimizerStateSwapper", "PipelinedOptimizerSwapper",
           "SwappedTensorMeta"]
