"""The generic decoder-only LM (OPT / Falcon / Phi / GPT-NeoX / GPT-J /
BLOOM) in PyTorch, as the JAX package's flax ``models/decoder.py``: the
configuration the serving engine reads (``adapt_decoder``), the parameter
layout, and a plain dense forward used as the oracle the engine is held
against.

The families differ only in a handful of structural flags
(:class:`DecoderConfig`): norm type, activation, full, partial or no rotary
(interleaved pairs, as the JAX package's ``_partial_rope``), learned
positions with an offset (OPT), parallel attention + MLP blocks off one or
two norms, biases, a tied or untied head with an optional bias, and BLOOM's
ALiBi position bias with a LayerNorm right after the embedding.

Parameters carry the flax names (``embed/embedding``,
``pos_embed/embedding``, ``embed_norm/{scale,bias}``,
``layers_{i}/{ln1,ln2}/{scale,bias}``, ``layers_{i}/{wq,wk,wv,wo}``,
``layers_{i}/{bq,bk,bv,bo}``, ``layers_{i}/mlp/{w_gate,w_up,b_up,w_down,
b_down}``, ``final_norm/...``, ``lm_head``, ``lm_head_bias``) and the flax
layout (projections ``[in, out]``, computing ``x @ w``), so a JAX tree
converts by ``checkpoint.params_from_flat`` alone. Init matches the flax
initialisers' scales: normal(0.02) projections and head, normal(1 /
sqrt(hidden)) embeddings (flax ``nn.Embed``), unit norm scales, zero norm
and projection biases, drawn from a seeded ``torch.Generator``.

The forward follows the JAX module's numerics: norms take f32 statistics
(``var = mean((x - mean)^2)``) and round to the compute dtype; attention
scores are f32 with the ALiBi bias ``slope_h * (k_pos - q_pos)`` added
(:func:`alibi_bias`); a 'local' layer's window mask takes the place of the
ALiBi bias there, as in the JAX module; the tied head is ``x.f32 @
embed.f32.T``.

:meth:`DecoderLM.decode` is the v1 engine's incremental step over the dense
KV cache of :func:`init_decoder_cache` (the JAX package's
``DecoderLM.decode``), in bf16/fp32 or in the int8 tier of
``models/llama.py`` (``quantized_cache_append`` /
``quantized_cache_attention``); the causal mask and BLOOM's ALiBi come in
one shared bias, and a 'local' layer rebuilds its own window bias, as in
the JAX module. A projection may be a ``QuantizedWeight`` there (every
projection is read through ``w.to(dt)``, in :func:`_proj`). The training
loss, ``remat`` and ``sequence_parallel`` are not ported yet and raise by
name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.llama import (dense_cache, quantized_cache_append,
                                              quantized_cache_attention, window_bias,
                                              window_mask)
from deepspeed_tpu_torch.utils.device import resolve_device


@dataclass
class DecoderConfig:
    family: str = "opt"
    vocab_size: int = 50272
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_key_value_heads: Optional[int] = None   # None -> MHA
    max_position_embeddings: int = 2048
    norm: str = "ln"                 # "ln" | "rms"
    activation: str = "relu"  # "relu" | "gelu" (tanh) | "gelu_exact" | "silu" | "swiglu"
    rope_theta: Optional[float] = None          # None -> no rotary
    rotary_pct: float = 1.0                     # fraction of head_dim that rotates
    learned_pos: bool = False
    pos_offset: int = 0              # OPT: positions offset by 2 in the table
    alibi: bool = False              # BLOOM: per-head linear position bias
    embed_norm: bool = False         # BLOOM: layernorm right after the embedding
    attn_scale: Optional[float] = None  # GPT-Neo: 1.0 (no 1/sqrt(D) scaling)
    local_window: Optional[int] = None  # GPT-Neo: sliding window for 'local' layers
    # per-layer attention kinds ("global" | "local"); None -> all global
    attention_layers: Optional[tuple] = None
    parallel_block: bool = False     # attn + mlp in one residual add
    parallel_dual_norm: bool = False # neox: MLP from ln2(x) instead of ln1(x)
    qkv_bias: bool = True
    out_bias: bool = True
    mlp_bias: bool = True
    tied_lm_head: bool = False
    head_bias: bool = False          # phi/gpt-j: bias on the LM head projection
    sequence_parallel: bool = False  # not ported yet: raises
    eps: float = 1e-5
    lm_loss_chunk: int = 4
    dtype: torch.dtype = torch.float32
    remat: bool = False              # not ported yet: raises
    remat_policy: Optional[str] = None

    def __post_init__(self):
        off = [n for n, on in [("remat", self.remat),
                               ("sequence_parallel", self.sequence_parallel)] if on]
        if off:
            raise NotImplementedError(
                f"DecoderConfig {', '.join(off)}: not ported to deepspeed_tpu_torch yet")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def rotary_dim(self) -> Optional[int]:
        if self.rope_theta is None:
            return None
        rd = int(self.head_dim * self.rotary_pct)
        return rd - rd % 2

    # ---- family presets (sizes per public model cards) -------------------- #

    @classmethod
    def opt_125m(cls, **kw):
        d = dict(family="opt", vocab_size=50272, hidden_size=768,
                 intermediate_size=3072, num_hidden_layers=12,
                 num_attention_heads=12, learned_pos=True, pos_offset=2,
                 activation="relu", tied_lm_head=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def opt_1b3(cls, **kw):
        d = dict(family="opt", vocab_size=50272, hidden_size=2048,
                 intermediate_size=8192, num_hidden_layers=24,
                 num_attention_heads=32, learned_pos=True, pos_offset=2,
                 activation="relu", tied_lm_head=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def falcon_7b(cls, **kw):
        d = dict(family="falcon", vocab_size=65024, hidden_size=4544,
                 intermediate_size=4 * 4544, num_hidden_layers=32,
                 num_attention_heads=71, num_key_value_heads=1,
                 rope_theta=10000.0, activation="gelu", parallel_block=True,
                 qkv_bias=False, out_bias=False, mlp_bias=False)
        d.update(kw)
        return cls(**d)

    @classmethod
    def phi_2(cls, **kw):
        d = dict(family="phi", vocab_size=51200, hidden_size=2560,
                 intermediate_size=10240, num_hidden_layers=32,
                 num_attention_heads=32, rope_theta=10000.0, rotary_pct=0.4,
                 activation="gelu", parallel_block=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def gpt_neox_20b(cls, **kw):
        d = dict(family="gpt_neox", vocab_size=50432, hidden_size=6144,
                 intermediate_size=24576, num_hidden_layers=44,
                 num_attention_heads=64, rope_theta=10000.0, rotary_pct=0.25,
                 activation="gelu", parallel_block=True, parallel_dual_norm=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def bloom_560m(cls, **kw):
        d = dict(family="bloom", vocab_size=250880, hidden_size=1024,
                 intermediate_size=4096, num_hidden_layers=24,
                 num_attention_heads=16, alibi=True, embed_norm=True,
                 activation="gelu", tied_lm_head=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def gptj_6b(cls, **kw):
        d = dict(family="gptj", vocab_size=50400, hidden_size=4096,
                 intermediate_size=16384, num_hidden_layers=28,
                 num_attention_heads=16, rope_theta=10000.0, rotary_pct=0.25,
                 activation="gelu", parallel_block=True, qkv_bias=False,
                 out_bias=False, head_bias=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, family: str = "opt", **kw):
        base = {
            "opt": dict(learned_pos=True, pos_offset=2, activation="relu",
                        tied_lm_head=True),
            "falcon": dict(rope_theta=10000.0, activation="gelu",
                           parallel_block=True, qkv_bias=False, out_bias=False,
                           mlp_bias=False, num_key_value_heads=1),
            "phi": dict(rope_theta=10000.0, rotary_pct=0.5, activation="gelu",
                        parallel_block=True),
            "gpt_neox": dict(rope_theta=10000.0, rotary_pct=0.5, activation="gelu",
                             parallel_block=True, parallel_dual_norm=True),
            "bloom": dict(alibi=True, embed_norm=True, activation="gelu",
                          tied_lm_head=True),
            "gptj": dict(rope_theta=10000.0, rotary_pct=0.5, activation="gelu",
                         parallel_block=True, qkv_bias=False, out_bias=False,
                         head_bias=True),
            "gpt_neo": dict(learned_pos=True, activation="gelu",
                            qkv_bias=False, tied_lm_head=True, attn_scale=1.0,
                            local_window=8,
                            attention_layers=("global", "local")),
        }[family]
        d = dict(family=family, vocab_size=256, hidden_size=64,
                 intermediate_size=128, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=128)
        d.update(base)
        d.update(kw)
        return cls(**d)


def alibi_slopes(n_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes (geometric in 2^(-8/n), with the standard
    interpolation for non-power-of-two head counts), computed in Python
    floats as the JAX package's ``alibi_slopes``. f32, shape [H]."""
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]
    if math.log2(n_heads).is_integer():
        s = pow2(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        s = pow2(closest) + pow2(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(s, dtype=torch.float32)


def alibi_bias(q_positions: torch.Tensor, k_positions: torch.Tensor,
               n_heads: int) -> torch.Tensor:
    """Additive attention bias [B, H, Tq, Tk] f32: ``slope_h * (k_pos -
    q_pos)``. Constant along each softmax row up to the key term, so it
    gives the same softmax as the paged kernels' ``slope_h * k_pos``."""
    rel = (k_positions[:, None, None, :] - q_positions[:, None, :, None]).float()
    return alibi_slopes(n_heads).to(rel.device)[None, :, None, None] * rel


def _partial_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                  rotary_dim: Optional[int]) -> torch.Tensor:
    """[B, T, H, D] with per-row positions [B, T]; rotates the first
    ``rotary_dim`` dims on interleaved pairs, in f32, back in x's dtype."""
    D = x.shape[-1]
    rd = rotary_dim or D
    xr, xp = x[..., :rd], x[..., rd:]
    freqs = 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32,
                                          device=x.device) / rd))
    angles = positions[..., None].float() * freqs
    cos, sin = angles.cos()[:, :, None, :], angles.sin()[:, :, None, :]
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    rot = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                      dim=-1).flatten(-2).to(x.dtype)
    return torch.cat([rot, xp], dim=-1) if rd < D else rot


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
               kind: str, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's ``_Norm``: RMSNorm (``kind == "rms"``) or LayerNorm
    with ``var = mean((x - mean)^2)``, statistics in f32, cast to
    ``dtype``."""
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * scale.float()
    else:
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).pow(2).mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(dtype)


PLAIN_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "silu": F.silu,
    "relu": F.relu,
}


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Embed(nn.Module):
    def __init__(self, num: int, features: int, dtype, device):
        super().__init__()
        self.embedding = _param((num, features), dtype, device)


class Norm(nn.Module):
    """Scale (and, for LayerNorm, bias) of one norm."""

    def __init__(self, kind: str, features: int, dtype, device):
        super().__init__()
        self.kind = kind
        self.scale = _param((features,), dtype, device)
        if kind != "rms":
            self.bias = _param((features,), dtype, device)

    def normalize(self, x, eps: float, dtype):
        return layer_norm(x, self.scale, getattr(self, "bias", None), self.kind, eps,
                          dtype)


class Mlp(nn.Module):
    def __init__(self, cfg: DecoderConfig, device):
        super().__init__()
        hid, ff, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        if cfg.activation == "swiglu":
            self.w_gate = _param((hid, ff), dt, device)
        self.w_up = _param((hid, ff), dt, device)
        biased = cfg.mlp_bias and cfg.activation != "swiglu"
        if biased:
            self.b_up = _param((ff,), dt, device)
        self.w_down = _param((ff, hid), dt, device)
        if biased:
            self.b_down = _param((hid,), dt, device)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig, device):
        super().__init__()
        H, Hkv, D, hid, dt = (cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim,
                              cfg.hidden_size, cfg.dtype)
        self.ln1 = Norm(cfg.norm, hid, dt, device)
        if not cfg.parallel_block or cfg.parallel_dual_norm:
            self.ln2 = Norm(cfg.norm, hid, dt, device)
        self.wq = _param((hid, H * D), dt, device)
        self.wk = _param((hid, Hkv * D), dt, device)
        self.wv = _param((hid, Hkv * D), dt, device)
        self.wo = _param((H * D, hid), dt, device)
        if cfg.qkv_bias:
            self.bq = _param((H * D,), dt, device)
            self.bk = _param((Hkv * D,), dt, device)
            self.bv = _param((Hkv * D,), dt, device)
        if cfg.out_bias:
            self.bo = _param((hid,), dt, device)
        self.mlp = Mlp(cfg, device)


def _proj(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], dt) -> torch.Tensor:
    y = x @ w.to(dt)
    return y if b is None else y + b.to(dt)


_PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")


class DecoderLM(nn.Module):
    """The generic decoder with flax-named parameters in ``config.dtype`` on
    ``device`` (default: the CUDA device), initialised from ``seed``."""

    def __init__(self, config: DecoderConfig, device=None, seed: int = 0):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        hid, dt = cfg.hidden_size, cfg.dtype
        self.embed = Embed(cfg.vocab_size, hid, dt, device)
        if cfg.learned_pos:
            self.pos_embed = Embed(cfg.max_position_embeddings + cfg.pos_offset, hid, dt,
                                   device)
        if cfg.embed_norm:
            self.embed_norm = Norm(cfg.norm, hid, dt, device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}", DecoderBlock(cfg, device))
        self.final_norm = Norm(cfg.norm, hid, dt, device)
        if not cfg.tied_lm_head:
            self.lm_head = _param((hid, cfg.vocab_size), dt, device)
        if cfg.head_bias:
            self.lm_head_bias = _param((cfg.vocab_size,), dt, device)
        self.reset_parameters(seed)

    @property
    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.config.num_hidden_layers)]

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator(device=self.embed.embedding.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            if leaf == "embedding":
                tmp.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            elif leaf in _PROJECTIONS:
                tmp.normal_(0.0, 0.02, generator=gen)
            else:
                tmp.fill_(1.0 if leaf == "scale" else 0.0)
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
    def hidden(self, input_ids: torch.Tensor, positions: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Dense causal trunk, ``input_ids`` [B, T] -> final-normed hidden
        states [B, T, hidden] in ``compute_dtype`` (default ``config.dtype``);
        each layer's weights are cast as that layer runs."""
        cfg = self.config
        dt = compute_dtype or cfg.dtype
        B, T = input_ids.shape
        H, Hkv, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        if positions is None:
            positions = torch.arange(T, device=input_ids.device).expand(B, T)
        x = self._embed_in(input_ids, positions, dt)
        causal = window_mask(positions, positions, None)[:, None]
        alibi = alibi_bias(positions, positions, H) if cfg.alibi else None
        kinds = cfg.attention_layers or ("global",) * cfg.num_hidden_layers
        scale = cfg.attn_scale if cfg.attn_scale is not None else D ** -0.5
        for layer, kind in zip(self.layers, kinds):
            h1 = layer.ln1.normalize(x, cfg.eps, dt)
            q, k, v = self._qkv(layer, h1, positions, dt)
            k = k.repeat_interleave(H // Hkv, dim=2)
            v = v.repeat_interleave(H // Hkv, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
            visible = causal
            if kind == "local":
                # the window mask takes the place of the ALiBi bias here, as
                # in the JAX module
                visible = window_mask(positions, positions, cfg.local_window)[:, None]
            elif alibi is not None:
                s = s + alibi
            s = s.masked_fill(~visible, torch.finfo(torch.float32).min)
            p = torch.softmax(s, dim=-1).to(dt)
            o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, H * D)
            x = self._combine(layer, x, h1, _proj(o, layer.wo, getattr(layer, "bo", None), dt),
                              dt)
        return self.final_norm.normalize(x, cfg.eps, dt)

    def _embed_in(self, input_ids: torch.Tensor, positions: torch.Tensor, dt) -> torch.Tensor:
        """The token (and learned position) embedding in ``dt``, behind
        BLOOM's embedding norm."""
        cfg = self.config
        x = self.embed.embedding.to(dt)[input_ids]
        if cfg.learned_pos:
            x = x + self.pos_embed.embedding.to(dt)[positions + cfg.pos_offset]
        if cfg.embed_norm:
            x = self.embed_norm.normalize(x, cfg.eps, dt)
        return x

    def _qkv(self, layer: DecoderBlock, h1: torch.Tensor, positions: torch.Tensor, dt):
        """q [B, T, H, D] and k, v [B, T, Hkv, D] of the normed ``h1``, the
        rotary part rotated."""
        cfg = self.config
        B, T, _ = h1.shape
        H, Hkv, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        q = _proj(h1, layer.wq, getattr(layer, "bq", None), dt).view(B, T, H, D)
        k = _proj(h1, layer.wk, getattr(layer, "bk", None), dt).view(B, T, Hkv, D)
        v = _proj(h1, layer.wv, getattr(layer, "bv", None), dt).view(B, T, Hkv, D)
        if cfg.rope_theta is not None:
            q = _partial_rope(q, positions, cfg.rope_theta, cfg.rotary_dim)
            k = _partial_rope(k, positions, cfg.rope_theta, cfg.rotary_dim)
        return q, k, v

    def _combine(self, layer: DecoderBlock, x: torch.Tensor, h1: torch.Tensor,
                 attn: torch.Tensor, dt) -> torch.Tensor:
        """The residual: a parallel block adds attention and the MLP (off
        ``h1``, or off ln2 under ``parallel_dual_norm``) at once, a
        sequential one in turn."""
        cfg = self.config
        if cfg.parallel_block:
            mlp_in = layer.ln2.normalize(x, cfg.eps, dt) if cfg.parallel_dual_norm else h1
            return x + attn + self._mlp(layer.mlp, mlp_in, dt)
        x = x + attn
        return x + self._mlp(layer.mlp, layer.ln2.normalize(x, cfg.eps, dt), dt)

    def _mlp(self, m: Mlp, x: torch.Tensor, dt) -> torch.Tensor:
        act = self.config.activation
        if act == "swiglu":
            h = F.silu(x @ m.w_gate.to(dt)) * (x @ m.w_up.to(dt))
        else:
            h = PLAIN_ACTS[act](_proj(x, m.w_up, getattr(m, "b_up", None), dt))
        return _proj(h, m.w_down, getattr(m, "b_down", None), dt)

    @torch.no_grad()
    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final hidden states -> f32 logits: the tied head in f32 (``x.f32 @
        embed.f32.T``) or ``x @ lm_head`` in x's dtype, plus the head bias."""
        if self.config.tied_lm_head:
            logits = x.float() @ self.embed.embedding.float().t()
        else:
            logits = (x @ self.lm_head.to(x.dtype)).float()
        if self.config.head_bias:
            logits = logits + self.lm_head_bias.float()
        return logits

    @torch.no_grad()
    def forward_logits(self, input_ids: torch.Tensor,
                       positions: Optional[torch.Tensor] = None,
                       compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Dense causal forward, ``input_ids`` [B, T] -> f32 logits [B, T, V]."""
        return self.head(self.hidden(input_ids, positions, compute_dtype))

    def forward(self, batch, deterministic: bool = True):
        raise NotImplementedError("DecoderLM training loss: not ported to "
                                  "deepspeed_tpu_torch yet (serving reads the config "
                                  "and the parameters; forward_logits is the dense "
                                  "oracle)")

    @torch.no_grad()
    def decode(self, input_ids: torch.Tensor, cache: Dict[str, torch.Tensor],
               cache_index: int, positions: Optional[torch.Tensor] = None):
        """One incremental step over the dense KV cache (prefill or
        single-token decode), the JAX package's ``DecoderLM.decode``.

        ``input_ids`` [B, T]; ``cache`` from :func:`init_decoder_cache`;
        ``cache_index`` the write offset. Writes this step's K/V rows into
        the cache IN PLACE and returns (logits [B, T, V] f32, cache).
        Positions default to ``cache_index + arange(T)``. Computed in
        ``config.dtype``."""
        cfg = self.config
        dt = cfg.dtype
        input_ids = input_ids.long()
        B, T = input_ids.shape
        cache_index = int(cache_index)
        if positions is None:
            positions = cache_index + torch.arange(T, device=input_ids.device).expand(B, T)
        x = self._embed_in(input_ids, positions, dt)
        S = cache["k"].shape[2]
        k_pos = torch.arange(S, device=input_ids.device).expand(B, S)
        bias = window_bias(positions, k_pos, None)
        if cfg.alibi:
            bias = bias + alibi_bias(positions, k_pos, cfg.num_attention_heads)
        kinds = cfg.attention_layers or ("global",) * cfg.num_hidden_layers
        for i, (layer, kind) in enumerate(zip(self.layers, kinds)):
            window = cfg.local_window if kind == "local" else None
            x = self._decode_layer(layer, x, positions, k_pos,
                                   {key: cache[key][i] for key in cache}, cache_index,
                                   bias, window, dt)
        return self.head(self.final_norm.normalize(x, cfg.eps, dt)), cache

    def _decode_layer(self, layer: DecoderBlock, x: torch.Tensor, positions: torch.Tensor,
                      k_pos: torch.Tensor, layer_cache: Dict[str, torch.Tensor],
                      cache_index: int, bias: torch.Tensor, window: Optional[int],
                      dt) -> torch.Tensor:
        """One layer of :meth:`decode` (the JAX package's
        ``DecoderBlock.decode``): the shared ``bias`` [B, 1|H, T, S] (causal
        mask plus ALiBi), rebuilt as the window's own causal bias on a
        'local' layer; the dense cache's attention as ``reference_attention``
        (f32 scores, probabilities in q's dtype), the int8 cache's through
        ``quantized_cache_attention``."""
        cfg = self.config
        B, T, _ = x.shape
        H, Hkv, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        h1 = layer.ln1.normalize(x, cfg.eps, dt)
        q, k, v = self._qkv(layer, h1, positions, dt)
        if window is not None:
            bias = window_bias(positions, k_pos, window)
        if "k_scale" in layer_cache:
            quantized_cache_append(layer_cache, k, v, cache_index)
            o = quantized_cache_attention(q, layer_cache, bias, Hkv,
                                          softmax_scale=cfg.attn_scale)
        else:
            ck, cv = layer_cache["k"], layer_cache["v"]
            ck[:, cache_index:cache_index + T] = k.to(ck.dtype)
            cv[:, cache_index:cache_index + T] = v.to(cv.dtype)
            scale = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / (D ** 0.5)
            s = torch.einsum("bqhd,bkhd->bhqk", q,
                             ck.repeat_interleave(H // Hkv, dim=2)).float() * scale
            p = torch.softmax(s + bias, dim=-1).to(q.dtype)
            del s
            o = torch.einsum("bhqk,bkhd->bqhd", p, cv.repeat_interleave(H // Hkv, dim=2))
        o = o.reshape(B, T, H * D)
        return self._combine(layer, x, h1, _proj(o, layer.wo, getattr(layer, "bo", None), dt),
                             dt)


def init_decoder_cache(config: DecoderConfig, batch_size: int, max_len: int, dtype=None,
                       kv_bits: Optional[int] = None, device=None) -> Dict[str, torch.Tensor]:
    """The dense KV cache of the v1 engine for :class:`DecoderLM` (the JAX
    package's ``init_decoder_cache``): {"k", "v"} zeros [L, B, max_len,
    kv_heads, D] in ``dtype`` (default ``config.dtype``) on ``device``
    (default: the CUDA device); ``kv_bits=8`` the int8 tier."""
    if kv_bits is not None and kv_bits != 8:
        raise ValueError(f"kv_bits must be 8, got {kv_bits!r}")
    shape = (config.num_hidden_layers, batch_size, max_len, config.kv_heads,
             config.head_dim)
    return dense_cache(shape, dtype or config.dtype, kv_bits, resolve_device(device))
