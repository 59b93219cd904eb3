"""Operators of the port: hand-written CUDA kernels under ``ops.kernels``,
attention dispatch (``ops.attention``), block-sparse self-attention
(``ops.sparse_attention``), Evoformer attention (``ops.evoformer``:
``DS4Sci_EvoformerAttention`` over the fused pair-bias op K10, and the four
AlphaFold attention modes) and the optimizer registry.

``build_optimizer`` reads the config's ``optimizer`` block as the JAX
package's does: the Adam family, LAMB, Lion, Adagrad, SGD and the
host-offloaded names (``cpuadam``, ``cpulion``, ``cpuadagrad``; the offload
tier steps them on the host). The JAX package's 1-bit optimizers raise
``NotImplementedError`` naming them."""

from typing import Any, Dict

from deepspeed_tpu_torch.ops.adagrad import Adagrad, DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam, FusedAdam
from deepspeed_tpu_torch.ops.evoformer import (DS4Sci_EvoformerAttention, evoformer_attention,
                                               msa_row_attention_mask_bias,
                                               triangle_pair_bias)
from deepspeed_tpu_torch.ops.kernels.evoformer_attention import (
    evoformer_flash_attention, msa_col_attention, msa_row_attention,
    triangle_attention_ending_node, triangle_attention_starting_node)
from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
    block_sparse_attention, block_sparse_attention_bhsd)
from deepspeed_tpu_torch.ops.lamb import FusedLamb
from deepspeed_tpu_torch.ops.lion import DeepSpeedCPULion, FusedLion
from deepspeed_tpu_torch.ops.optimizer import TPUOptimizer
from deepspeed_tpu_torch.ops.sgd import SGD
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, SparsityConfig, VariableSparsityConfig, layout_to_mask,
    sparse_self_attention, sparsity_ratio)

OPTIMIZER_REGISTRY = {"adam": FusedAdam, "adamw": FusedAdam, "fusedadam": FusedAdam,
                      "cpuadam": DeepSpeedCPUAdam, "deepspeedcpuadam": DeepSpeedCPUAdam,
                      "lamb": FusedLamb, "fusedlamb": FusedLamb,
                      "lion": FusedLion, "fusedlion": FusedLion, "cpulion": DeepSpeedCPULion,
                      "adagrad": Adagrad, "cpuadagrad": DeepSpeedCPUAdagrad, "sgd": SGD}
# registered in the JAX package, not ported yet: the 1-bit optimizers
UNPORTED_OPTIMIZERS = ("onebitadam", "onebitlamb", "zerooneadam")


def build_optimizer(opt_type: str, params: Dict[str, Any]) -> TPUOptimizer:
    """Build an optimizer from the config ``optimizer`` block."""
    key = opt_type.lower().replace("_", "")
    if key in UNPORTED_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer '{opt_type}': not ported to deepspeed_tpu_torch yet "
            f"(ported: {sorted(OPTIMIZER_REGISTRY)})")
    if key not in OPTIMIZER_REGISTRY:
        raise ValueError(
            f"unknown optimizer type '{opt_type}'; known: {sorted(OPTIMIZER_REGISTRY)}")
    kwargs = dict(params)
    # DeepSpeed configs use torch naming; translate the common ones.
    if "betas" in kwargs:
        kwargs["betas"] = tuple(float(b) for b in kwargs["betas"])
    for k in ("lr", "eps", "weight_decay"):
        if k in kwargs and isinstance(kwargs[k], str):
            kwargs[k] = float(kwargs[k])
    if key == "adam" and "adam_w_mode" not in kwargs:
        # bare "Adam" means classic L2 unless adam_w_mode is set; "AdamW"
        # always decouples
        kwargs["adam_w_mode"] = False
    if key == "adamw":
        kwargs["adam_w_mode"] = True
    kwargs.pop("torch_adam", None)
    return OPTIMIZER_REGISTRY[key](**kwargs)
