"""Llama-2 in PyTorch: the configuration the serving engine reads, and a plain
dense forward used as the oracle the engine is held against.

Nothing on the serving path calls :class:`LlamaForCausalLM`'s forward: the
engine reads its configuration and its parameters. The forward follows the
JAX package's flax model step for step: RMSNorm computed in f32, rotary
embedding on INTERLEAVED pairs (``x[..., 0::2]``, ``x[..., 1::2]``, not the
rotate-half convention), causal attention with f32 scores (restricted to the sliding window
``[q - window + 1, q]`` when the config has one), and a SwiGLU MLP. The
JAX package's lineage flags ride the same model: biased q/k/v (``qkv_bias``,
Qwen2) and Gemma's embedding scaled by sqrt(hidden) in f32
(``embed_scale_by_sqrt_dim``), RMSNorm by ``1 + weight`` (``norm_plus_one``,
weights initialised at 0) and a tanh-GELU gate (``mlp_act="gelu"``, flax's
``nn.gelu`` default).
The causal-LM losses the training path shares (:func:`causal_lm_loss`,
:func:`chunked_causal_lm_loss`) live here too, as in the JAX package.

Parameters carry the flax names (``embed_tokens/embedding``,
``layers_{i}/self_attn/q_proj/kernel``, ..., ``lm_head/kernel``) and the flax
layout: a projection's ``kernel`` is ``[in, out]`` and computes ``x @
kernel`` (``nn.Linear`` would be ``[out, in]``). Init matches flax's scale:
truncated-normal projections with variance 1/fan_in (lecun_normal),
normal(1/sqrt(hidden)) embeddings, unit norms — drawn from a seeded
``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.utils.device import resolve_device


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32        # < num_attention_heads => GQA
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    sliding_window: Optional[int] = None  # Mistral: keys at most window-1 back
    qkv_bias: bool = False               # Qwen2 lineage: biased q/k/v projections
    head_dim_override: Optional[int] = None  # Gemma: head_dim apart from hidden/heads
    embed_scale_by_sqrt_dim: bool = False    # Gemma: x *= sqrt(hidden) after embedding
    norm_plus_one: bool = False              # Gemma: RMSNorm scales by (1 + weight)
    mlp_act: str = "silu"                    # "silu" | "gelu" (tanh) gate activation
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls, **kw):
        return cls(**kw)

    @classmethod
    def llama2_13b(cls, **kw):
        defaults = dict(hidden_size=5120, intermediate_size=13824,
                        num_hidden_layers=40, num_attention_heads=40,
                        num_key_value_heads=40)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def mistral_7b(cls, **kw):
        """The JAX package's preset as it stands: Mistral-7B's geometry with
        GQA 32/8, ``sliding_window=4096`` (v0.1) and ``rope_theta=1e6``
        (v0.2's value)."""
        defaults = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                        num_hidden_layers=32, num_attention_heads=32,
                        num_key_value_heads=8, max_position_embeddings=32768,
                        rope_theta=1e6, sliding_window=4096)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **kw):
        """Fixture-sized config, as the JAX package's ``LlamaConfig.tiny``."""
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` [in, out] and, with ``bias``, ``bias``
    [out]; ``x @ kernel + bias``."""

    def __init__(self, d_in: int, d_out: int, dtype, device, bias: bool = False):
        super().__init__()
        self.kernel = _param((d_in, d_out), dtype, device)
        if bias:
            self.bias = _param((d_out,), dtype, device)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """``x @ kernel (+ bias)`` with the parameters cast to ``dt``."""
        y = x @ self.kernel.to(dt)
        return y + self.bias.to(dt) if hasattr(self, "bias") else y


class Embed(nn.Module):
    def __init__(self, vocab: int, hidden: int, dtype, device):
        super().__init__()
        self.embedding = _param((vocab, hidden), dtype, device)


class RMSNorm(nn.Module):
    def __init__(self, hidden: int, dtype, device):
        super().__init__()
        self.weight = _param((hidden,), dtype, device)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        hid, D = cfg.hidden_size, cfg.head_dim
        H, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
        qb = cfg.qkv_bias
        self.q_proj = Dense(hid, H * D, cfg.dtype, device, qb)
        self.k_proj = Dense(hid, Hkv * D, cfg.dtype, device, qb)
        self.v_proj = Dense(hid, Hkv * D, cfg.dtype, device, qb)
        self.o_proj = Dense(H * D, hid, cfg.dtype, device)


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        hid, ff = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Dense(hid, ff, cfg.dtype, device)
        self.up_proj = Dense(hid, ff, cfg.dtype, device)
        self.down_proj = Dense(ff, hid, cfg.dtype, device)


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.dtype, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.dtype, device)
        self.self_attn = Attention(cfg, device)
        self.mlp = MLP(cfg, device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             dtype: torch.dtype, plus_one: bool = False) -> torch.Tensor:
    """RMSNorm computed in f32, cast to ``dtype``; ``plus_one`` scales by
    ``1 + weight`` (Gemma), the sum taken in the weight's dtype as the JAX
    engine's ``_norm`` takes it."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * (1 + weight if plus_one else weight).float()).to(dtype)


def embed_scale(x: torch.Tensor, cfg) -> torch.Tensor:
    """Gemma's embedding normaliser: ``x * sqrt(hidden)`` in f32, back to
    x's dtype (the JAX package's f32 round trip); x unchanged without
    ``embed_scale_by_sqrt_dim``."""
    if not getattr(cfg, "embed_scale_by_sqrt_dim", False):
        return x
    return (x.float() * cfg.hidden_size ** 0.5).to(x.dtype)


def mlp_gate_act(name: str):
    """The gated MLP's gate activation: SiLU, or the tanh GELU (flax's
    ``nn.gelu`` default) for ``mlp_act="gelu"``."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"llama-lineage mlp_act '{name}' has no gated-MLP mapping "
                     "(expected 'silu' or 'gelu')")


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) [..., head_dim / 2] in f32 for integer ``positions``."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=positions.device) / head_dim))
    ang = positions.float()[..., None] * freqs
    return ang.cos(), ang.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on interleaved pairs. x [..., T, H, D]; cos/sin
    [..., T, D / 2]."""
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    c, s = cos.unsqueeze(-2), sin.unsqueeze(-2)
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).flatten(-2)
    return out.to(x.dtype)


def window_mask(q_positions: torch.Tensor, k_positions: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """[B, Tq, Tk] bool: key position <= query position, and within the
    sliding window ``[q - window + 1, q]`` when one is given (the JAX
    package's ``_window_bias`` rule)."""
    delta = q_positions[:, :, None] - k_positions[:, None, :]
    ok = delta >= 0
    if window is not None:
        ok = ok & (delta < window)
    return ok


class LlamaForCausalLM(nn.Module):
    """Llama-2 decoder with flax-named parameters in ``config.dtype`` on
    ``device`` (default: the CUDA device), initialised from ``seed``. On the
    ``meta`` device the parameters have names and shapes only (no values):
    a caller that makes the weights itself reads them from there."""

    block_cls = Block

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype, device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}", self.block_cls(cfg, device))
        self.norm = RMSNorm(cfg.hidden_size, cfg.dtype, device)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, cfg.dtype, device)
        if device.type != "meta":
            self.reset_parameters(seed)

    @property
    def layers(self):
        return [getattr(self, f"layers_{i}")
                for i in range(self.config.num_hidden_layers)]

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator(device=self.embed_tokens.embedding.device)
        gen.manual_seed(seed)
        # flax lecun_normal: truncated to +-2 std, std corrected so the
        # variance is 1 / fan_in
        lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
        for name, p in self.named_parameters():
            tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if name.endswith("kernel"):
                std = 1.0 / math.sqrt(p.shape[0]) / 0.87962566103423978
                tmp.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
                tmp.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)
            elif name.endswith("embedding"):
                tmp.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            elif name.endswith(("w_gate", "w_up", "w_down")):
                tmp.normal_(0.0, 0.02, generator=gen)      # MoE expert stacks
            else:
                # norm weights (zero-centred under norm_plus_one) and biases
                tmp.fill_(0.0 if name.endswith("bias") or self.config.norm_plus_one
                          else 1.0)
            p.copy_(tmp)

    def flat_params(self) -> Dict[str, torch.Tensor]:
        """Parameters by their flax names (``/``-joined)."""
        return {n.replace(".", "/"): p.data for n, p in self.named_parameters()}

    @torch.no_grad()
    def load_flat(self, flat: Dict[str, torch.Tensor]) -> None:
        """Copy a flax-named tree (see :meth:`flat_params`) into the
        parameters; names and shapes must match exactly."""
        own = self.flat_params()
        if set(own) != set(flat):
            raise KeyError(f"parameter names differ: missing "
                           f"{sorted(set(own) - set(flat))[:4]}, unexpected "
                           f"{sorted(set(flat) - set(own))[:4]}")
        for name, p in own.items():
            if tuple(flat[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(flat[name].shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(flat[name])

    @torch.no_grad()
    def forward_logits(self, input_ids: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Dense causal forward, ``input_ids`` [B, T] -> f32 logits [B, T, V]
        (:meth:`hidden`, then the head)."""
        dt = compute_dtype or self.config.dtype
        return self.lm_head(self.hidden(input_ids, positions, dt), dt).float()

    @torch.no_grad()
    def hidden(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The final normed hidden states [B, T, hidden] of the dense causal
        forward, in ``compute_dtype`` (default ``config.dtype``); each
        layer's weights are cast as that layer runs, so an f32 pass over
        bf16 parameters holds only one layer's f32 copy at a time."""
        cfg = self.config
        dt = compute_dtype or cfg.dtype
        B, T = input_ids.shape
        H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        eps, p1 = cfg.rms_norm_eps, cfg.norm_plus_one
        if positions is None:
            positions = torch.arange(T, device=input_ids.device).expand(B, T)
        cos, sin = rope_tables(positions, D, cfg.rope_theta)
        visible = window_mask(positions, positions, cfg.sliding_window)[:, None]
        x = embed_scale(self.embed_tokens.embedding[input_ids], cfg).to(dt)
        for layer in self.layers:
            a = layer.self_attn
            h = rms_norm(x, layer.input_layernorm.weight, eps, dt, p1)
            q = apply_rope(a.q_proj(h, dt).view(B, T, H, D), cos, sin)
            k = apply_rope(a.k_proj(h, dt).view(B, T, Hkv, D), cos, sin)
            v = a.v_proj(h, dt).view(B, T, Hkv, D)
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * D ** -0.5
            s = s.masked_fill(~visible, torch.finfo(torch.float32).min)
            p = torch.softmax(s, dim=-1).to(dt)
            del s
            o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, H * D)
            x = x + a.o_proj(o, dt)
            h = rms_norm(x, layer.post_attention_layernorm.weight, eps, dt, p1)
            x = x + self.ffn(layer, h, dt)
        return rms_norm(x, self.norm.weight, eps, dt, p1)

    def ffn(self, layer: nn.Module, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """One layer's gated MLP on its normed input ``h`` in ``dt``."""
        m = layer.mlp
        return (mlp_gate_act(self.config.mlp_act)(m.gate_proj(h, dt))
                * m.up_proj(h, dt)) @ m.down_proj.kernel.to(dt)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL with shift-by-one, in the logsumexp form
    (``logsumexp(logits) - logits[label]``): no second [B, T, V] array."""
    logits_s = logits[:, :-1, :]
    labels_s = labels[:, 1:].long()
    lse = torch.logsumexp(logits_s, dim=-1)
    picked = torch.gather(logits_s, -1, labels_s[..., None])[..., 0]
    return (lse - picked).mean()


def _chunk_nll_sum(h: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum of one chunk's NLL: ``h`` [c, T-1, C] @ ``w`` [C, V] (both in the
    matmul type), f32 logits, logsumexp minus the label's logit."""
    logits = torch.matmul(h, w).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, y[..., None])[..., 0]
    return (lse - picked).sum()


def chunked_causal_lm_loss(x: torch.Tensor, vocab_weight: torch.Tensor,
                           labels: torch.Tensor, batch_chunk: int = 4) -> torch.Tensor:
    """Fused projection + cross entropy over batch chunks.

    ``x`` [B, T, C] final hidden states; ``vocab_weight`` [V, C] (the tied
    embedding; the JAX function's ``transpose`` and ``head_bias`` for untied
    heads come with the first model that trains one). Each chunk's body
    runs under ``torch.utils.checkpoint`` (the counterpart of the JAX
    package's ``jax.checkpoint`` scan body), so only one chunk's
    [chunk, T-1, V] f32 logits live at a time, in the forward and again in
    the backward. bf16 models project in bf16 (the matmul accumulates in
    f32; its output is rounded to bf16 before the f32 softmax, where XLA
    keeps the f32 product); f32 models stay in f32."""
    B, T, C = x.shape
    chunk = max(1, min(batch_chunk, B))
    while B % chunk:
        chunk -= 1
    mm_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    w = vocab_weight.t().to(mm_dtype)
    y = labels[:, 1:].long()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, B, chunk):
        total = total + checkpoint(_chunk_nll_sum, x[i:i + chunk, :-1].to(mm_dtype), w,
                                   y[i:i + chunk], use_reentrant=False)
    return total / (B * (T - 1))
