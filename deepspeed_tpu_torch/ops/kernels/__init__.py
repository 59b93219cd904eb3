"""The port's hand-written CUDA kernels (``deepspeed_tpu_torch/csrc``), each
with a wrapper, its plain PyTorch version and a launch count
(``_loader.LAUNCHES``). A wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.

K9's [B, T, H, D] entry ``block_sparse_attention`` is exported by
``deepspeed_tpu_torch.ops``, so that the module of the same name stays
reachable here. K10 (``evoformer_attention``: the fused pair-bias op, its
four kernels and the four AlphaFold attention modes) exports its functions
under their own names; the module keeps its name here."""

from deepspeed_tpu_torch.ops.kernels._loader import (LAUNCHES, load_library,
                                                      reset_launches)
from deepspeed_tpu_torch.ops.kernels.alibi import alibi_slope, alibi_slopes
from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
    BlockSparseAttention, block_sparse_attention_bhsd,
    block_sparse_bwd, block_sparse_bwd_plain, block_sparse_delta, block_sparse_dkv,
    block_sparse_dkv_plain, block_sparse_dq, block_sparse_dq_plain, block_sparse_fwd,
    block_sparse_fwd_plain, get_tables)
from deepspeed_tpu_torch.ops.kernels.evoformer_attention import (
    EvoformerAttention, evoformer_bwd, evoformer_bwd_plain, evoformer_dbias,
    evoformer_dbias_plain, evoformer_delta, evoformer_dkv, evoformer_dkv_plain, evoformer_dq,
    evoformer_dq_plain, evoformer_flash_attention, evoformer_fwd, evoformer_fwd_plain,
    msa_col_attention, msa_row_attention, triangle_attention_ending_node,
    triangle_attention_starting_node)
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
    quantized_matmul, quantized_matmul_grouped, quantized_matmul_grouped_plain,
    quantized_matmul_int4, quantized_matmul_int4_plain, quantized_matmul_plain)
