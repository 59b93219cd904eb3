"""GPT-2 in PyTorch, as the JAX package's flax ``models/gpt2.py``.

Pre-LN transformer with learned positions (``arange(T)``), causal attention
through ``ops.attention.dot_product_attention`` (the flash kernel K1), and a
tied embedding head. Given a batch with ``input_ids`` the forward returns the
mean next-token cross entropy (``labels`` default to the ids themselves),
through ``chunked_causal_lm_loss``; given bare ids it returns the tied-head
logits as f32.

Parameters are trainable, carry the flax names (``wte/embedding``,
``h_0/attn/c_attn/kernel``, ``h_0/ln_1/scale``, ...) and the flax layout: a
projection's ``kernel`` is ``[in, out]`` and computes ``x @ kernel + bias``.
The numerics follow flax: every op runs in ``config.dtype`` with the
parameters cast to it; LayerNorm takes its statistics in f32 (``E[x^2] -
E[x]^2``, clipped at 0) and rounds its output to ``config.dtype``; the MLP's
``gelu`` is the tanh approximation. Init matches flax's scale: truncated-
normal kernels with variance 1/fan_in (lecun_normal), zero biases,
normal(1/sqrt(n_embd)) embeddings, unit LayerNorm scales, drawn from a
seeded ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.llama import chunked_causal_lm_loss
from deepspeed_tpu_torch.ops.attention import dot_product_attention
from deepspeed_tpu_torch.utils.device import resolve_device


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    mlp_ratio: int = 4
    dropout: float = 0.0     # no dropout layer reads it, as in the JAX model
    eps: float = 1e-5        # HF GPT-2 layer_norm_epsilon
    dtype: torch.dtype = torch.float32
    # activation checkpointing and Ulysses sequence parallelism are not
    # ported yet: switching them on raises
    remat: bool = False
    remat_policy: Optional[str] = None
    sequence_parallel: bool = False
    # rows per chunk of the fused projection + CE loss
    lm_loss_chunk: int = 4

    def __post_init__(self):
        off = [n for n, on in [("remat", self.remat),
                               ("sequence_parallel", self.sequence_parallel)] if on]
        if off:
            raise NotImplementedError(
                f"GPT2Config {', '.join(off)}: not ported to deepspeed_tpu_torch yet")

    @classmethod
    def tiny(cls, **kw):
        """Test-sized config, as the JAX package's ``GPT2Config.tiny``."""
        defaults = dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4)
        defaults.update(kw)
        return cls(**defaults)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` [in, out], ``bias`` [out]."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.kernel = _param((d_in, d_out), dtype, device)
        self.bias = _param((d_out,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class Embed(nn.Module):
    def __init__(self, num: int, features: int, dtype, device):
        super().__init__()
        self.embedding = _param((num, features), dtype, device)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in f32, output in ``dtype``."""

    def __init__(self, features: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = _param((features,), dtype, device)
        self.bias = _param((features,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        self.n_head = cfg.n_head
        self.c_attn = Dense(cfg.n_embd, 3 * cfg.n_embd, cfg.dtype, device)
        self.c_proj = Dense(cfg.n_embd, cfg.n_embd, cfg.dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        q, k, v = self.c_attn(x).split(C, dim=-1)
        # the flash kernels take contiguous [B, T, H, D]
        heads = lambda t: t.reshape(B, T, self.n_head, C // self.n_head).contiguous()
        out = dot_product_attention(heads(q), heads(k), heads(v), causal=True)
        return self.c_proj(out.reshape(B, T, C))


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        self.c_fc = Dense(cfg.n_embd, cfg.mlp_ratio * cfg.n_embd, cfg.dtype, device)
        self.c_proj = Dense(cfg.mlp_ratio * cfg.n_embd, cfg.n_embd, cfg.dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.eps, cfg.dtype, device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.eps, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT2LMHead(nn.Module):
    """GPT-2 with flax-named parameters in ``config.dtype`` on ``device``
    (default: the CUDA device), initialised from ``seed``."""

    def __init__(self, config: GPT2Config, device=None, seed: int = 0):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        self.wte = Embed(cfg.vocab_size, cfg.n_embd, cfg.dtype, device)
        self.wpe = Embed(cfg.n_positions, cfg.n_embd, cfg.dtype, device)
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg, device))
        self.ln_f = LayerNorm(cfg.n_embd, cfg.eps, cfg.dtype, device)
        self.reset_parameters(seed)

    @property
    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.config.n_layer)]

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator(device=self.wte.embedding.device)
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
            else:
                tmp.fill_(1.0 if name.endswith("scale") else 0.0)
            p.copy_(tmp)

    def named_flat_parameters(self) -> Dict[str, nn.Parameter]:
        """The parameters themselves, by their flax names (``/``-joined)."""
        return {n.replace(".", "/"): p for n, p in self.named_parameters()}

    def flat_params(self) -> Dict[str, torch.Tensor]:
        """Parameter values by their flax names (``/``-joined)."""
        return {n: p.data for n, p in self.named_flat_parameters().items()}

    @torch.no_grad()
    def load_flat_params(self, flat: Mapping[str, torch.Tensor]) -> None:
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

    def forward(self, batch: Union[Mapping[str, torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """``{"input_ids": [B, T], "labels"?: [B, T]}`` -> mean loss (0-d f32);
        bare ``input_ids`` -> f32 logits [B, T, V]."""
        cfg = self.config
        dt = cfg.dtype
        if isinstance(batch, Mapping):
            if "pld_theta" in batch:
                raise NotImplementedError(
                    "progressive layer drop (pld_theta): not ported to "
                    "deepspeed_tpu_torch yet")
            input_ids, labels = batch["input_ids"], batch.get("labels")
            if labels is None:
                labels = input_ids   # LM objective: next token of the same ids
        else:
            input_ids, labels = batch, None
        input_ids = input_ids.long()
        T = input_ids.shape[1]
        pos = torch.arange(T, device=input_ids.device)
        x = self.wte.embedding[input_ids].to(dt) + self.wpe.embedding[pos].to(dt)[None]
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        if labels is None:
            # flax's Embed.attend: both sides in the compute dtype
            return (x @ self.wte.embedding.to(dt).t()).float()
        return chunked_causal_lm_loss(x, self.wte.embedding.to(dt), labels,
                                      batch_chunk=cfg.lm_loss_chunk)
