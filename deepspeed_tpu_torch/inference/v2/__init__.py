"""Inference v2 in PyTorch: the ragged / continuous-batching engine over a
paged KV cache, with its attention in hand-written CUDA kernels."""

from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.pipeline import DecodePipeline
from deepspeed_tpu_torch.inference.v2.ragged_model import (ADAPTERS, RaggedModelSpec,
                                                           adapt_model,
                                                           build_multistep_decode,
                                                           multistep_schedule)
