"""Model definitions of the port."""

from deepspeed_tpu_torch.models.decoder import (DecoderConfig, DecoderLM, alibi_bias,
                                                alibi_slopes)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
