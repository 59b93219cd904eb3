"""The port's hand-written CUDA kernels (``deepspeed_tpu_torch/csrc``), each
with a wrapper, its plain PyTorch version and a launch count
(``_loader.LAUNCHES``). A wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises."""

from deepspeed_tpu_torch.ops.kernels._loader import (LAUNCHES, load_library,
                                                      reset_launches)
from deepspeed_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain, flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq,
    flash_bwd_dq_plain, flash_delta)
from deepspeed_tpu_torch.ops.kernels.flash_packed import (
    flash_attention_packed, flash_attention_packed_plain)
from deepspeed_tpu_torch.ops.kernels.paged_chunk import (
    paged_chunk_attention_batched, paged_chunk_attention_batched_plain)
from deepspeed_tpu_torch.ops.kernels.paged_decode import (
    paged_decode_attention, paged_decode_attention_plain)
from deepspeed_tpu_torch.ops.kernels.paged_splitk import (
    merge_splitk_partials, splitk_attention, splitk_attention_plain)
from deepspeed_tpu_torch.ops.kernels.quantized_matmul import (
    quantized_matmul, quantized_matmul_plain)
