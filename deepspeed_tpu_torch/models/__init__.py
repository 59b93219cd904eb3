"""Model definitions of the port."""

from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
