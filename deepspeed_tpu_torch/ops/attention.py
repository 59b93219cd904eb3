"""Attention dispatch, as the JAX package's ``ops/attention.py``.

Without ``bias`` and ``segment_ids`` attention goes to the flash kernel K1
(``ops.kernels.flash_attention``) at every sequence length: its CUDA kernels
for CUDA tensors, its plain PyTorch version for CPU tensors. A kernel
failure raises; nothing falls back to the dense path. With ``bias`` or
``segment_ids`` it goes to :func:`reference_attention`, as the JAX package
does (its flash wrapper also sends ``segment_ids`` there).

The JAX package takes the dense path below ``FLASH_MIN_SEQ`` = 1024 on its
TPU; that threshold was tuned there, and the port has none until it is
measured on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention


def padding_mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """HF-style [B, S] key mask (1 = attend) -> additive f32 bias [B, 1, 1, S]."""
    neg = torch.finfo(torch.float32).min
    return torch.where(mask[:, None, None, :] > 0, 0.0, neg).to(torch.float32)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          bias: Optional[torch.Tensor] = None,
                          segment_ids: Optional[torch.Tensor] = None,
                          softmax_scale: Optional[float] = None) -> torch.Tensor:
    """[B, T, H, D] attention."""
    if bias is None and segment_ids is None:
        return flash_attention(q, k, v, causal=causal, softmax_scale=softmax_scale)
    return reference_attention(q, k, v, causal=causal, bias=bias,
                               segment_ids=segment_ids, softmax_scale=softmax_scale)


def reference_attention(q, k, v, causal=False, bias=None, segment_ids=None,
                        softmax_scale=None):
    """Dense attention with [B, H, Tq, Tk] f32 scores. Causal masking is
    BOTTOM-RIGHT aligned (``tril(k=Tk-Tq)``), as in the JAX package."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D ** 0.5)
    neg = torch.finfo(torch.float32).min
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        scores = scores + bias
    if causal:
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(Tk - Tq)
        scores = scores.masked_fill(~mask, neg)
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = scores.masked_fill(~seg_mask[:, None], neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
