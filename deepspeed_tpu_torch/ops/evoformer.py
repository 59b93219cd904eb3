"""Evoformer attention (DeepSpeed4Science): pair-bias and triangle attention.

Counterpart of the JAX package's ``ops/evoformer.py`` (parity: DeepSpeed's
``DS4Sci_EvoformerAttention(Q, K, V, [bias1, bias2])``, used by
AlphaFold-style models for MSA row/column attention, bias1 = per-sequence
mask bias ``[B, N, 1, 1, S]``, and triangle attention, bias2 = pair bias
``[B, 1, H, S, S]``).

:func:`evoformer_attention` is the broadcast reference in plain torch, with
autograd through both biases. :func:`DS4Sci_EvoformerAttention` routes the
published layouts to the fused op (K10,
``ops.kernels.evoformer_attention``: the CUDA kernels for CUDA tensors,
their plain versions for CPU tensors) by the JAX package's rule, and
anything else to the reference.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels.evoformer_attention import evoformer_flash_attention


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        biases: Sequence[Optional[torch.Tensor]] = ()) -> torch.Tensor:
    """Attention over the second-to-last axis with broadcastable biases.

    q/k/v ``[B, N, S, H, D]`` (batch, group/MSA row, sequence, heads,
    head_dim); each bias broadcastable to ``[B, N, H, S, S]``. Returns
    ``[B, N, S, H, D]``. The JAX reference's casts: the score product in
    the input type, then f32; the probabilities back in q's type.
    """
    *lead, S, H, D = q.shape
    scores = torch.einsum("...qhd,...khd->...hqk", q, k).to(torch.float32)
    scores = scores / np.sqrt(D)
    for bias in biases:
        if bias is not None:
            scores = scores + bias.to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", probs.to(q.dtype), v)


def DS4Sci_EvoformerAttention(Q, K, V, biases: List[Optional[torch.Tensor]],
                              fused: Optional[bool] = None):
    """Reference-shaped entry point (evoformer_attn.py
    DS4Sci_EvoformerAttention).

    Routes to the fused op when the shapes match the published layouts —
    Q/K/V ``[B, N, S, H, D]``, bias1 ``[B, N, 1, 1, S]`` (per-row additive
    key mask), bias2 ``[B, 1, H, S, S]`` (pair bias) — and to the reference
    for anything else.

    ``fused``: the fused op treats bias1 as a constant (zero gradient; it is
    a padding mask in every published use). So the default (None) fuses
    only when that cannot matter (bias1 absent); ``fused=True`` accepts the
    constant-mask contract with bias1 present (and raises ``ValueError`` on
    other shapes); ``fused=False`` takes the reference (full autograd for
    both biases).
    """
    if len(biases) > 2:
        raise ValueError("DS4Sci_EvoformerAttention takes at most 2 biases")
    bias1 = biases[0] if len(biases) >= 1 else None
    bias2 = biases[1] if len(biases) >= 2 else None
    fusable = Q.dim() == 5 and K.shape == Q.shape and V.shape == Q.shape
    if fusable:
        B, N, S, H, D = Q.shape
        fusable = (bias2 is not None and tuple(bias2.shape) == (B, 1, H, S, S)
                   and (bias1 is None or tuple(bias1.shape) == (B, N, 1, 1, S)))
    if fused is None:
        fused = fusable and bias1 is None
    if fused:
        if not fusable:
            raise ValueError(
                "fused=True but the shapes don't match the fused kernel's "
                f"layouts: Q {tuple(Q.shape)}, biases "
                f"{[None if b is None else tuple(b.shape) for b in biases]}")
        fold = lambda t: t.reshape(B * N, S, H, D).contiguous()
        mask = None if bias1 is None else bias1.reshape(B * N, S)
        out = evoformer_flash_attention(fold(Q), fold(K), fold(V), bias2[:, 0], mask,
                                        rows_per_group=N)
        return out.reshape(B, N, S, H, D)
    return evoformer_attention(Q, K, V, biases)


def msa_row_attention_mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, N, S] residue mask -> bias1 [B, N, 1, 1, S] (0 kept, -1e9 masked,
    f32; the reference's bias1 shape)."""
    return torch.where(mask > 0, 0.0, -1e9)[:, :, None, None, :].to(torch.float32)


def triangle_pair_bias(z: torch.Tensor, num_heads: int, proj: torch.Tensor) -> torch.Tensor:
    """Pair representation [B, S, S, C] @ proj [C, H] -> bias2 [B, 1, H, S, S]."""
    b = torch.einsum("bqkc,ch->bhqk", z, proj)
    return b[:, None].reshape(z.shape[0], 1, num_heads, z.shape[1], z.shape[2])
