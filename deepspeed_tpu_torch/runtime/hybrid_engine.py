"""The hybrid engine: one engine that trains AND generates (RLHF), as the
JAX package's ``runtime/hybrid_engine.py``.

``DeepSpeedHybridEngine`` is the training engine plus ``generate()``: a v1
``InferenceEngine`` (``inference/engine.py``) built lazily from the live
parameters, whose parameters are refreshed IN PLACE on the card, a cast
of the live training weights, before any generate that follows a step.
``eval()`` pre-pushes them; ``train()`` with
``hybrid_engine.release_inference_cache`` drops the inference engine.
``generate_count`` / ``generate_time`` and ``train_time`` are the latency
counters (``generate`` returns numpy, so its timer is synced by the
fetch; ``train_batch``'s measures the launch, as the JAX engine's).
On one device there is no ZeRO-3 gather to undo: both modes read the same
tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.runtime.engine import DeepSpeedTPUEngine
from deepspeed_tpu_torch.utils.timer import Timer


class DeepSpeedHybridEngine(DeepSpeedTPUEngine):
    """Training engine + ``generate()`` (see the module docstring)."""

    def __init__(self, *args, inference_config: Optional[dict] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._inference_config = dict(inference_config or {})
        self._infer = None
        self._infer_params_fresh = False
        self._in_eval = False
        self._generate_timer = Timer("hybrid_generate", sync=False, device=self.device)
        self._train_timer = Timer("hybrid_train", sync=False, device=self.device)
        self.generate_time = 0.0
        self.train_time = 0.0
        self.generate_count = 0

    # ---- mode flips ---- #

    def eval(self):
        """Enter generation mode: push the live weights into the inference
        engine now, so the rollout phase's first generate is warm."""
        self._in_eval = True
        self.refresh_inference_params()
        return self

    def train(self, mode: bool = True):
        self._in_eval = not mode
        if mode and self.config.hybrid_engine.release_inference_cache:
            self._infer = None
            self._infer_params_fresh = False
        return self

    # ---- generation ---- #

    def _inference_engine(self):
        if self._infer is None:
            from deepspeed_tpu_torch.inference.config import InferenceConfig
            from deepspeed_tpu_torch.inference.engine import InferenceEngine
            cfg = dict(self._inference_config)
            cfg.setdefault("dtype", "bfloat16" if self.mixed_precision else "float32")
            self._infer = InferenceEngine(self.module, InferenceConfig.from_dict(cfg),
                                          model_parameters=self._current_params(),
                                          device=self.device)
            self._infer_params_fresh = True
        return self._infer

    @torch.no_grad()
    def refresh_inference_params(self) -> None:
        """Cast the live training weights into the inference engine's
        parameters, in place on the card (no new tensor, no host copy)."""
        eng = self._inference_engine()
        if self._infer_params_fresh:
            return      # just built from the live weights
        live = self._current_params()
        torch._foreach_copy_([eng.params[n] for n in live], [live[n].detach() for n in live])
        self._infer_params_fresh = True

    def generate(self, input_ids, **kwargs):
        """Generate with the CURRENT training weights."""
        self._generate_timer.start()
        self.refresh_inference_params()
        out = self._inference_engine().generate(input_ids, **kwargs)
        self._generate_timer.stop(record=False)
        self.generate_time = self._generate_timer.elapsed()
        self.generate_count += 1
        return out

    def train_batch(self, *args, **kwargs):
        self._train_timer.start()
        out = super().train_batch(*args, **kwargs)
        self._train_timer.stop(record=False)
        self.train_time = self._train_timer.elapsed()
        self._infer_params_fresh = False  # weights moved: the next generate refreshes
        return out

    def step(self):
        # the forward/backward/step facade moves the weights too
        out = super().step()
        self._infer_params_fresh = False
        return out
