"""Host tensor swapping: the pinned bounce-buffer pool (the JAX package's
``runtime/swap_tensor/``; its NVMe swappers are not ported yet)."""

from deepspeed_tpu_torch.runtime.swap_tensor.buffer_pool import SwapBufferPool

__all__ = ["SwapBufferPool"]
