"""Mixtral (the sparse-MoE Llama lineage) in PyTorch: the configuration the
serving engine reads, and a plain dense forward used as the oracle the
engine is held against.

The Llama backbone (``models/llama.py``) with each MLP replaced by a top-k
routed MoE of SwiGLU experts. The forward routes as the JAX package's
``dropless_moe`` (``parallel/moe.py:142``), the semantics the ragged engine
serves: f32 router logits, a softmax over all experts, the top-k gates
renormalised to sum to 1, every (token, choice) through its expert's FFN
(no capacity, no token dropped) and the weighted outputs added per token in
the model dtype. The JAX package's default ``dispatch_mode="capacity"``
(one-hot dispatch with a per-expert capacity that drops overflow tokens) is
its training and expert-parallel routing; the port refuses it by name.

Parameters carry the flax names: ``layers_{i}/block_sparse_moe/gate/kernel``
(the router, ``[hidden, E]``) and the expert stacks
``layers_{i}/block_sparse_moe/{w_gate, w_up}`` ``[E, hidden, ff]`` and
``w_down`` ``[E, ff, hidden]``, beside the Llama names of the attention,
norms, embedding and head.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from deepspeed_tpu_torch.models.llama import (Attention, Dense, LlamaConfig,
                                              LlamaForCausalLM, RMSNorm, _param,
                                              mlp_gate_act)


@dataclass
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    # the JAX package's default is "capacity" (its training routing); the
    # port's dense forward and engine route dropless
    dispatch_mode: str = "dropless"

    @classmethod
    def mixtral_8x7b(cls, **kw):
        """``mistralai/Mixtral-8x7B-v0.1``'s geometry, as the JAX package's
        preset (``models/mixtral.py:43-50``)."""
        defaults = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                        num_hidden_layers=32, num_attention_heads=32,
                        num_key_value_heads=8, max_position_embeddings=32768,
                        rope_theta=1e6, num_local_experts=8, num_experts_per_tok=2)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **kw):
        """Fixture-sized config, as the JAX package's ``MixtralConfig.tiny``."""
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, max_position_embeddings=128,
                        num_local_experts=4, num_experts_per_tok=2)
        defaults.update(kw)
        return cls(**defaults)


class SparseMoe(nn.Module):
    def __init__(self, cfg: MixtralConfig, device):
        super().__init__()
        E, hid, ff = cfg.num_local_experts, cfg.hidden_size, cfg.intermediate_size
        self.gate = Dense(hid, E, cfg.dtype, device)
        self.w_gate = _param((E, hid, ff), cfg.dtype, device)
        self.w_up = _param((E, hid, ff), cfg.dtype, device)
        self.w_down = _param((E, ff, hid), cfg.dtype, device)


class MixtralBlock(nn.Module):
    def __init__(self, cfg: MixtralConfig, device):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.dtype, device)
        self.self_attn = Attention(cfg, device)
        self.block_sparse_moe = SparseMoe(cfg, device)


class MixtralForCausalLM(LlamaForCausalLM):
    """Mixtral decoder with flax-named parameters in ``config.dtype`` on
    ``device`` (default: the CUDA device; ``meta`` for names and shapes
    only), initialised from ``seed``: projections and the router as flax's
    lecun_normal, the expert stacks normal(0.02) (the JAX package's
    initialiser)."""

    block_cls = MixtralBlock

    def __init__(self, config: MixtralConfig, device=None, seed: int = 0):
        if config.dispatch_mode != "dropless":
            raise NotImplementedError(
                f"dispatch_mode={config.dispatch_mode!r} (the JAX package's capacity "
                "routing for training and expert parallelism) is not ported to "
                "deepspeed_tpu_torch yet; use dispatch_mode='dropless'")
        super().__init__(config, device=device, seed=seed)

    def forward(self, batch) -> torch.Tensor:
        raise NotImplementedError("MoE training (Mixtral's training forward and its "
                                  "router loss): not ported to deepspeed_tpu_torch yet")

    def decode(self, input_ids, cache, cache_index, positions=None):
        raise NotImplementedError("Mixtral's decode over the dense KV cache (the v1 "
                                  "inference engine's step): not ported to "
                                  "deepspeed_tpu_torch yet")

    def ffn(self, layer: nn.Module, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """Dropless top-k routing of ``h`` [B, T, hidden] through the
        layer's experts (the JAX package's ``dropless_moe``)."""
        cfg, m = self.config, layer.block_sparse_moe
        shape = h.shape
        x = h.reshape(-1, shape[-1])
        gates = torch.softmax(x.float() @ m.gate.kernel.float(), dim=-1)
        top_w, top_e = torch.topk(gates, cfg.num_experts_per_tok, dim=-1)
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
        act = mlp_gate_act(cfg.mlp_act)
        out = torch.zeros_like(x)
        for e in range(cfg.num_local_experts):
            tok, slot = (top_e == e).nonzero(as_tuple=True)
            xs = x[tok]
            y = (act(xs @ m.w_gate[e].to(dt)) * (xs @ m.w_up[e].to(dt))) @ m.w_down[e].to(dt)
            out.index_add_(0, tok, y * top_w[tok, slot, None].to(dt))
        return out.reshape(shape)
