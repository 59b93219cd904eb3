"""Packed ragged-prefill attention: CUDA kernel ``csrc/flash_packed.cu`` and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``
``flash_attention_packed``. Rows of many sequences are concatenated; row i
attends row j iff ``j <= i`` and ``seg[i] == seg[j]``. Padding rows carry
segment -1. With a sliding ``window`` row i also needs ``i - j < window``:
row distance equals position distance because each segment's rows are
contiguous and in position order (``scheduler.schedule_pass`` checks
that where it builds the batch). A windowed launch counts as
``flash_packed_window``.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels._plain import masked_softmax_av

NAME = "flash_packed"
NAME_WINDOW = "flash_packed_window"
SOURCE = "deepspeed_tpu_torch/csrc/flash_packed.cu"
REPLACES = "deepspeed_tpu/ops/pallas/flash_attention.py:204"
REPLACES_WINDOW = ("deepspeed_tpu/ops/pallas/flash_attention.py:204 window= "
                   "(_fwd_kernel_packed :145; window :166-168, :182-183)")


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           segment_ids: torch.Tensor,
                           softmax_scale: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """q [R, H, D]; k/v [R, Hkv, D]; segment_ids [R] int32; ``window``
    (None: none) -> [R, H, D].

    CPU tensors run :func:`flash_attention_packed_plain`; CUDA tensors launch
    the kernel (bf16, contiguous) or raise."""
    R, H, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv or k.shape != (R, Hkv, D) or v.shape != k.shape \
            or segment_ids.shape != (R,):
        raise ValueError(f"{NAME}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} seg {tuple(segment_ids.shape)}")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    name = NAME if window is None else NAME_WINDOW
    if _loader.on_cpu(name, q, k, v, segment_ids):
        return flash_attention_packed_plain(q, k, v, segment_ids, scale, window)
    _loader.check_cuda(name, q.dtype, q=q, k=k, v=v, segment_ids=segment_ids)
    out = torch.empty_like(q)
    P = _loader.ptr
    _loader.launch(name, "dstorch_flash_packed_bf16", q.device,
                   P(q), P(k), P(v), P(segment_ids), P(out), R, H, Hkv, D,
                   _loader.window_arg(window), scale)
    return out


def flash_attention_packed_plain(q, k, v, segment_ids,
                                 softmax_scale: Optional[float] = None,
                                 window: Optional[int] = None):
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
    if window is not None:
        mask &= idx[:, None] - idx[None, :] < window
    return masked_softmax_av(s, mask[None], vf, "hqk,khd->qhd").to(q.dtype)

