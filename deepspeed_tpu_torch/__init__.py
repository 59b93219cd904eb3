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
  (forward, dq and dk/dv), monitor sinks (TensorBoard, W&B, CSV and a live
  Prometheus exporter, ``monitor``), the flops profiler (``profiling``)
  and the elastic agent (``elasticity``);
- RLHF on one device: the colocated rollout (``runtime.colocated``:
  ``WeightBridge`` casts the trainer's master into a live v2 engine's
  weights on the card, ``swap_weights`` rebinds them between decode
  slices, ``RolloutLoop`` interleaves generation and training), and the
  hybrid engine (``hybrid_engine.enabled``: ``engine.generate`` through
  the v1 engine of :func:`init_inference`, a dense KV cache in plain
  PyTorch).

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
    versions.

    A fault plan in ``DSTPU_FAULTS`` and span tracing into ``DSTPU_TRACE``
    are armed here, before the config is read."""
    from deepspeed_tpu_torch.monitor import trace as _trace
    from deepspeed_tpu_torch.utils import fault_injection
    fault_injection.install_from_env()
    _trace.install_from_env()
    cfg = DeepSpeedTPUConfig.load(config if config is not None else config_params)
    engine_cls, extra = DeepSpeedTPUEngine, {}
    if cfg.hybrid_engine.enabled:
        # DeepSpeed's initialize returns its hybrid engine here
        from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine
        engine_cls = DeepSpeedHybridEngine
        extra["inference_config"] = {
            "tensor_parallel": {"tp_size": cfg.hybrid_engine.inference_tp_size},
            "max_out_tokens": cfg.hybrid_engine.max_out_tokens}
    engine = engine_cls(args=args, model=model, optimizer=optimizer,
                        model_parameters=model_parameters,
                        training_data=training_data, lr_scheduler=lr_scheduler,
                        mesh_topology=mesh_topology, config=cfg, device=device,
                        collate_fn=collate_fn, **extra)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def init_inference(model=None, config=None, model_parameters=None, device=None, **kwargs):
    """The v1 inference engine (``inference.engine.InferenceEngine``), as the
    JAX package's ``init_inference``; extra keyword arguments override the
    config. ``model`` is a port model with a dense ``decode``
    (``LlamaForCausalLM``); a model name or path and a HuggingFace module
    (module injection) are refused by name."""
    from deepspeed_tpu_torch.inference.config import InferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    cfg = InferenceConfig.load(config, **kwargs)
    if isinstance(model, str):
        raise NotImplementedError(
            f"init_inference(model={model!r}): loading a model by name or path through "
            "transformers is not ported to deepspeed_tpu_torch yet")
    mcfg = getattr(model, "config", None)
    if (mcfg is not None and hasattr(mcfg, "model_type")
            and callable(getattr(model, "state_dict", None))
            and not callable(getattr(model, "named_flat_parameters", None))):
        raise NotImplementedError(
            "init_inference on a HuggingFace model (module injection, "
            "convert_hf_model): not ported to deepspeed_tpu_torch yet")
    return InferenceEngine(model, cfg, model_parameters=model_parameters, device=device)
