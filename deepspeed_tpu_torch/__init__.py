"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

The JAX package ``deepspeed_tpu`` stays the reference; this package imports
``torch`` and never ``jax``, ``flax`` or ``deepspeed_tpu``. Its serving path
is the v2 ragged engine (``inference.v2.InferenceEngineV2``) serving Llama-2,
with attention in hand-written CUDA kernels for ``sm_90a``
(``ops.kernels``, sources in ``csrc/``).
"""

from deepspeed_tpu_torch.inference.v2 import (DecodePipeline, InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__version__ = "0.1.0"
