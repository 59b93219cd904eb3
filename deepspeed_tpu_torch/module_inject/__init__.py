"""Checkpoint injection for the port's serving engine: LoRA adapter
loading (``lora.py``). The JAX package's HF model converters
(``convert_hf_model``, the injection policies) are not ported yet."""

from deepspeed_tpu_torch.module_inject.lora import (load_lora_adapter, pack_lora_pages,
                                                    validate_lora_adapter)

__all__ = ["load_lora_adapter", "validate_lora_adapter", "pack_lora_pages"]
