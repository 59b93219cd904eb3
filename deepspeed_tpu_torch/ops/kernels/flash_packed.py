"""Packed ragged-prefill attention: CUDA kernel ``csrc/flash_packed.cu`` and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``
``flash_attention_packed``. Rows of many sequences are concatenated; row i
attends row j iff ``j <= i`` and ``seg[i] == seg[j]``. Padding rows carry
segment -1.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels._plain import masked_softmax_av

NAME = "flash_packed"
SOURCE = "deepspeed_tpu_torch/csrc/flash_packed.cu"
REPLACES = "deepspeed_tpu/ops/pallas/flash_attention.py:204"


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           segment_ids: torch.Tensor,
                           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q [R, H, D]; k/v [R, Hkv, D]; segment_ids [R] int32 -> [R, H, D].

    CPU tensors run :func:`flash_attention_packed_plain`; CUDA tensors launch
    the kernel (bf16, contiguous) or raise."""
    R, H, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv or k.shape != (R, Hkv, D) or v.shape != k.shape \
            or segment_ids.shape != (R,):
        raise ValueError(f"{NAME}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} seg {tuple(segment_ids.shape)}")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if _loader.on_cpu(NAME, q, k, v, segment_ids):
        return flash_attention_packed_plain(q, k, v, segment_ids, scale)
    _loader.check_cuda(NAME, q.dtype, q=q, k=k, v=v, segment_ids=segment_ids)
    out = torch.empty_like(q)
    P = _loader.ptr
    _loader.launch(NAME, "dstorch_flash_packed_bf16", q.device,
                   P(q), P(k), P(v), P(segment_ids), P(out), R, H, Hkv, D, scale)
    return out


def flash_attention_packed_plain(q, k, v, segment_ids,
                                 softmax_scale: Optional[float] = None):
    """The same function in plain PyTorch, computed in f32; returns q's
    dtype."""
    R, H, D = q.shape
    G = H // k.shape[1]
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = torch.einsum("qhd,khd->hqk", qf, kf) * scale
    idx = torch.arange(R, device=q.device)
    seg = segment_ids.long()
    mask = (idx[:, None] >= idx[None, :]) & (seg[:, None] == seg[None, :])
    return masked_softmax_av(s, mask[None], vf, "hqk,khd->qhd").to(q.dtype)

