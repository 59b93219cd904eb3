"""The v1 inference engine on one device (the JAX package's
``inference/engine.py`` ``InferenceEngine``): a model's parameters cast to
the serving dtype, a dense forward, and generation over a dense KV cache.

- The parameters: ``model_parameters`` (a flax-named flat tree of tensors
  or numpy arrays), else the model-states file of
  ``config.checkpoint.checkpoint_dir``, copied to the device and cast to
  ``config.dtype``; the engine owns these tensors (:attr:`params`, by flax
  name). It runs the model's own code over them through a shallow copy of
  the model's module tree whose parameters ARE those tensors,
  so writing into :attr:`params` in place (the hybrid engine's refresh)
  is all a weight update needs.
- ``forward(ids)``: the model's ``forward_logits``.
- ``generate``: a prefill and single-token steps of the model's ``decode``
  over the dense cache of ``models.llama.init_cache``, greedy or sampled
  (temperature, top-k) from a ``torch.Generator`` seeded with
  ``config.seed``, under the JAX package's ``max_out_tokens``,
  ``max_tokens``, ``min_out_tokens`` and ``eos_token_id`` rules.

The JAX engine computes this in XLA with no Pallas kernel, so the port's is
plain PyTorch. Tensor and expert parallelism, int8 weights and the int8
cache tier are refused by ``InferenceConfig``; models without a dense
``decode`` (``DecoderLM``, Mixtral, GPT-2) are refused at ``generate``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.checkpoint.convert import params_from_flat
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.utils.device import resolve_device


class InferenceEngine:
    """See the module docstring."""

    def __init__(self, model: Any, config: Optional[InferenceConfig] = None,
                 model_parameters: Optional[Mapping[str, Any]] = None, device=None):
        self.config = config if isinstance(config, InferenceConfig) \
            else InferenceConfig.load(config)
        self.module = model
        self.model_config = getattr(model, "config", None)
        self.device = resolve_device(device)
        self._dtype = self.config.compute_dtype
        params = model_parameters
        if params is None and self.config.checkpoint.checkpoint_dir:
            params = self._load_checkpoint_params(self.config.checkpoint.checkpoint_dir,
                                                  self.config.checkpoint.tag)
        if params is None:
            raise ValueError("init_inference needs model_parameters or "
                             "config.checkpoint.checkpoint_dir")
        self.params = self._cast_params(params)
        self._net = self._bind(model)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed)

    # ------------------------------------------------------------------ #
    # setup helpers
    # ------------------------------------------------------------------ #

    @staticmethod
    def _load_checkpoint_params(ckpt_dir: str, tag: Optional[str]) -> Dict[str, np.ndarray]:
        """A training tag's model-states file (the fp32 master by flax
        name; ``tag=None`` reads ``latest``)."""
        from deepspeed_tpu_torch.checkpoint.state import MODEL_FILE, read_latest_tag
        tag = tag or read_latest_tag(ckpt_dir) or ""
        with np.load(os.path.join(ckpt_dir, tag, MODEL_FILE)) as data:
            return {k: data[k] for k in data.files}

    def _cast_params(self, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Fresh device copies in the serving dtype (floating leaves), so no
        caller's tensor is ever written through the engine."""
        if any(isinstance(v, np.ndarray) for v in params.values()):
            params = params_from_flat(params, device=self.device)
        out = {}
        for name, t in params.items():
            dt = self._dtype if t.is_floating_point() else t.dtype
            out[name] = t.detach().to(device=self.device, dtype=dt, copy=True)
        return out

    def _bind(self, model: nn.Module) -> nn.Module:
        """A shallow copy of the model's module tree whose parameters are
        :attr:`params` (shared storage, no copy); the model is untouched."""
        want = {n.replace(".", "/") for n, _ in model.named_parameters()}
        if want != set(self.params):
            raise KeyError(f"model_parameters names differ from the model's: missing "
                           f"{sorted(want - set(self.params))[:4]}, unexpected "
                           f"{sorted(set(self.params) - want)[:4]}")

        def rebind(module: nn.Module, prefix: str) -> nn.Module:
            net = copy.copy(module)
            net._parameters = {}
            for name, p in module._parameters.items():
                t = self.params[prefix + name]
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"{prefix + name}: shape {tuple(t.shape)} != "
                                     f"{tuple(p.shape)}")
                net._parameters[name] = nn.Parameter(t, requires_grad=False)
            net._modules = {name: rebind(m, f"{prefix}{name}/")
                            for name, m in module._modules.items()}
            return net

        return rebind(model, "")

    def _make_cache(self, batch_size: int, max_len: int) -> Dict[str, torch.Tensor]:
        from deepspeed_tpu_torch.models.decoder import DecoderLM
        from deepspeed_tpu_torch.models.llama import init_cache
        if isinstance(self.module, DecoderLM):
            raise NotImplementedError(
                "DecoderLM.decode over the dense KV cache (init_decoder_cache): "
                "not ported to deepspeed_tpu_torch yet")
        return init_cache(self.model_config, batch_size, max_len, dtype=self._dtype,
                          device=self.device)

    # ------------------------------------------------------------------ #
    # forward / generate
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def forward(self, input_ids) -> torch.Tensor:
        """Full-sequence f32 logits [B, T, V] (the model's ``forward_logits``)."""
        return self._net.forward_logits(torch.as_tensor(input_ids, device=self.device).long())

    __call__ = forward

    def _sample(self, logits: torch.Tensor, do_sample: bool, temperature: float,
                top_k: int) -> torch.Tensor:
        if not do_sample:
            return torch.argmax(logits, dim=-1)
        logits = logits / max(temperature, 1e-6)
        if top_k > 0:
            kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
            logits = torch.where(logits < kth, torch.finfo(logits.dtype).min, logits)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=self.generator)[:, 0]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Autoregressive generation: one prefill step of the prompt, then
        one decode step a token. Returns [B, T + new] token ids (fewer new
        columns when every row reached ``eos_token_id``; a finished row
        repeats it)."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device).long()
        B, T = ids.shape
        if max_new_tokens > self.config.max_out_tokens:
            raise ValueError(f"max_new_tokens {max_new_tokens} exceeds "
                             f"config.max_out_tokens {self.config.max_out_tokens}")
        max_len = T + max_new_tokens
        if max_len > self.config.max_tokens:
            raise ValueError(f"prompt+generation {max_len} exceeds "
                             f"config.max_tokens {self.config.max_tokens}")
        decode = self._net.decode
        cache = self._make_cache(B, max_len)
        logits, cache = decode(ids, cache, 0)
        out = [ids.cpu().numpy()]
        tok = self._sample(logits[:, -1], do_sample, temperature, top_k)
        finished = np.zeros((B,), bool)
        for i in range(max_new_tokens):
            tok_np = tok.cpu().numpy()
            if eos_token_id is not None and i + 1 >= self.config.min_out_tokens:
                tok_np = np.where(finished, eos_token_id, tok_np)
                finished |= tok_np == eos_token_id
            out.append(tok_np[:, None])
            if eos_token_id is not None and finished.all():
                break
            if i + 1 == max_new_tokens:
                break
            step = torch.as_tensor(tok_np[:, None], device=self.device)
            logits, cache = decode(step, cache, T + i)
            tok = self._sample(logits[:, -1], do_sample, temperature, top_k)
        return np.concatenate(out, axis=1).astype(np.int64)
