"""Multi-tenant LoRA serving (the JAX package's ``inference/v2/lora/``):

- :class:`LoraPagePool`: the device page pool and its bucketed host movers;
- :class:`LoraAdapterRegistry`: adapter lifecycle (register, acquire,
  release, LRU eviction, byte-exact restore) and each run's page table.

The delta itself lives in ``ragged_model`` (``lora_target_dims``,
``lora_page_layout``, ``lora_layer_operands`` and the ``lora_targets``
knob of the step builders); checkpoint loading in ``module_inject.lora``.
"""

from deepspeed_tpu_torch.inference.v2.lora.pool import LoraPagePool
from deepspeed_tpu_torch.inference.v2.lora.registry import (EVICTED, REGISTERED, RESIDENT,
                                                            LoraAdapterRegistry)

__all__ = [
    "LoraPagePool",
    "LoraAdapterRegistry",
    "REGISTERED",
    "RESIDENT",
    "EVICTED",
]
