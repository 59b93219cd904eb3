"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

The JAX package ``deepspeed_tpu`` stays the reference; this package imports
``torch`` and never ``jax``, ``flax`` or ``deepspeed_tpu``. It has two paths,
each with its attention in hand-written CUDA kernels for ``sm_90a``
(``ops.kernels``, sources in ``csrc/``):

- serving: the v2 ragged engine (``inference.v2.InferenceEngineV2``)
  serving Llama-2, Mistral with its sliding window, and the generic
  decoder families (``models.decoder``: OPT, Falcon, Phi, GPT-NeoX, GPT-J,
  BLOOM with ALiBi) and GPT-2 (kernels K2, K5, the paged decode kernel and
  split-K);
- training: :func:`initialize` -> ``engine.train_batch`` /
  ``train_steps`` / ``eval_loss`` or the forward/backward/step facade on
  one device, training GPT-2 (``models.gpt2.GPT2LMHead``) and the Llama
  family (``models.llama.LlamaForCausalLM``) with the Adam family, LAMB,
  Lion, Adagrad or SGD, bf16 mixed precision, activation checkpointing,
  progressive layer drop, a curriculum seqlen schedule and a prefetching
  data pipeline (``training_data``), with the flash attention kernels K1
  (forward, dq and dk/dv).

``ops`` also carries two attention ops of their own, forward and backward:
block-sparse self-attention (``sparse_self_attention``, kernels K9) and
Evoformer attention (``DS4Sci_EvoformerAttention`` and the four AlphaFold
modes, kernels K10).
"""

from deepspeed_tpu_torch.config import ConfigError, DeepSpeedTPUConfig
from deepspeed_tpu_torch.inference.v2 import (DecodePipeline, InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.runtime.engine import DeepSpeedTPUEngine

__version__ = "0.1.0"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mesh_topology=None,
               collate_fn=None, config=None, config_params=None, device=None):
    """Build the training engine, as the JAX package's ``initialize``.

    Returns ``(engine, engine.optimizer, engine.training_dataloader,
    engine.lr_scheduler)``; the loader is None without ``training_data``.
    ``device=None`` means the CUDA device and raises where there is none;
    pass ``device="cpu"`` to train on the CPU with the kernels' plain
    versions."""
    cfg = DeepSpeedTPUConfig.load(config if config is not None else config_params)
    engine = DeepSpeedTPUEngine(args=args, model=model, optimizer=optimizer,
                                model_parameters=model_parameters,
                                training_data=training_data, lr_scheduler=lr_scheduler,
                                mesh_topology=mesh_topology, config=cfg, device=device,
                                collate_fn=collate_fn)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
