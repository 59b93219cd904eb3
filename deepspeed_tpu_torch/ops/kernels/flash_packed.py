"""Packed ragged-prefill attention: CUDA kernel ``csrc/flash_packed.cu`` and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``
``flash_attention_packed``. Rows of many sequences are concatenated; row i
attends row j iff ``j <= i`` and ``seg[i] == seg[j]``. Padding rows carry
segment -1. With a sliding ``window`` row i also needs ``i - j < window``:
row distance equals position distance because each segment's rows are
contiguous and in position order (``scheduler.schedule_pass`` checks
that where it builds the batch). A windowed launch counts as
``flash_packed_window``. ``with_lse=True`` also returns each row's
log-sum-exp of its scaled scores, ``lse [R, H]`` f32 (-1e30 for a row that
sees no key), as the Pallas kernel's ``with_lse`` does; such a launch
counts as ``flash_packed_lse`` (``flash_packed_window_lse``). The kernel
takes head dims 16, 32, 64, 80, 96, 128 and 256.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels._plain import masked_softmax_av

NAME = "flash_packed"
NAME_WINDOW = "flash_packed_window"
NAME_LSE = "flash_packed_lse"
SOURCE = "deepspeed_tpu_torch/csrc/flash_packed.cu"
REPLACES = "deepspeed_tpu/ops/pallas/flash_attention.py:204"
REPLACES_WINDOW = ("deepspeed_tpu/ops/pallas/flash_attention.py:204 window= "
                   "(_fwd_kernel_packed :145; window :166-168, :182-183)")
REPLACES_LSE = ("deepspeed_tpu/ops/pallas/flash_attention.py:204 with_lse=True "
                "(flag :208, lse :196-201, return :278)")
KERNEL_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           segment_ids: torch.Tensor,
                           softmax_scale: Optional[float] = None,
                           window: Optional[int] = None, with_lse: bool = False):
    """q [R, H, D]; k/v [R, Hkv, D]; segment_ids [R] int32; ``window``
    (None: none) -> o [R, H, D], or (o, lse [R, H] f32) with ``with_lse``.

    CPU tensors run :func:`flash_attention_packed_plain`; CUDA tensors launch
    the kernel (bf16, contiguous) or raise."""
    R, H, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv or k.shape != (R, Hkv, D) or v.shape != k.shape \
            or segment_ids.shape != (R,):
        raise ValueError(f"{NAME}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} seg {tuple(segment_ids.shape)}")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    name = (NAME if window is None else NAME_WINDOW) + ("_lse" if with_lse else "")
    if _loader.on_cpu(name, q, k, v, segment_ids):
        return flash_attention_packed_plain(q, k, v, segment_ids, scale, window, with_lse)
    _loader.check_cuda(name, q.dtype, q=q, k=k, v=v, segment_ids=segment_ids)
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {KERNEL_HEAD_DIMS}")
    out = torch.empty_like(q)
    lse = torch.empty((R, H), dtype=torch.float32, device=q.device) if with_lse else None
    P = _loader.ptr
    _loader.launch(name, "dstorch_flash_packed_bf16", q.device,
                   P(q), P(k), P(v), P(segment_ids), P(out), P(lse), R, H, Hkv, D,
                   _loader.window_arg(window), scale)
    return (out, lse) if with_lse else out


def flash_attention_packed_plain(q, k, v, segment_ids,
                                 softmax_scale: Optional[float] = None,
                                 window: Optional[int] = None, with_lse: bool = False):
    """The same function in plain PyTorch, computed in f32; o in q's dtype,
    lse in f32."""
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
    o = masked_softmax_av(s, mask[None], vf, "hqk,khd->qhd").to(q.dtype)
    if not with_lse:
        return o
    lse = torch.logsumexp(torch.where(mask[None], s, torch.full_like(s, -torch.inf)), -1)
    lse = torch.where(torch.isfinite(lse), lse, torch.full_like(lse, -1e30))
    return o, lse.t().contiguous()
