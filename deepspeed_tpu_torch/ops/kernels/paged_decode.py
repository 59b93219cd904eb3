"""Paged decode attention, one query per sequence: CUDA kernel
``csrc/paged_decode.cu`` and its plain PyTorch version.

One function covers the JAX package's three decode entry points, as their
Pallas kernels share one body (``_decode_body``):

  - ``paged_decode_attention``: pages hold every visible token
    (``lens = ctx``), no side rows;
  - ``paged_decode_attention_step``: pages hold ``[0, ctx - 1)`` and the
    current token's K/V is one side row (``C = 1, j = 0``); the caller writes
    it into its page afterwards;
  - ``paged_decode_attention_sidebuf``: a frozen prefix in pages plus a side
    slab of fresh rows, ``[S, C * Hkv, D]`` with row ``cc * Hkv + h``; rows
    ``cc <= j`` are attended.

A row that sees no token gives zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels._plain import masked_softmax_av

NAME = "paged_decode"
SOURCE = "deepspeed_tpu_torch/csrc/paged_decode.cu"
REPLACES = ("deepspeed_tpu/ops/pallas/paged_attention.py:1088 (K3), "
            ":1249 (K4), :809 (K6); body _decode_body :280")


def paged_decode_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                           block_tables: torch.Tensor, lens: torch.Tensor,
                           side_k: Optional[torch.Tensor] = None,
                           side_v: Optional[torch.Tensor] = None, j: int = 0,
                           softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q [S, H, D]; kv_pages [NB, 2, Hkv, bs, D] (one layer); block_tables
    [S, MB], lens [S] int32 (page tokens attended per sequence); optional
    side_k/side_v [S, C * Hkv, D] with step ``j`` -> [S, H, D].

    CPU tensors run :func:`paged_decode_attention_plain`; CUDA tensors launch
    the kernel (bf16, contiguous) or raise."""
    S, H, D = q.shape
    NB, two, Hkv, bs, Dk = kv_pages.shape
    MB = block_tables.shape[1]
    if two != 2 or Dk != D or H % Hkv or block_tables.shape != (S, MB) \
            or lens.shape != (S,):
        raise ValueError(f"{NAME}: bad shapes q {tuple(q.shape)} kv "
                         f"{tuple(kv_pages.shape)} bt {tuple(block_tables.shape)} "
                         f"lens {tuple(lens.shape)}")
    C = 0
    sides = ()
    if side_k is not None:
        if side_v is None or side_k.shape != side_v.shape or side_k.ndim != 3 \
                or side_k.shape[0] != S or side_k.shape[2] != D \
                or side_k.shape[1] % Hkv:
            raise ValueError(f"{NAME}: side rows must be [S, C*Hkv, D] pairs")
        C = side_k.shape[1] // Hkv
        if not 0 <= j < C:
            raise ValueError(f"{NAME}: step j={j} outside [0, {C})")
        sides = (side_k, side_v)
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if _loader.on_cpu(NAME, q, kv_pages, block_tables, lens, *sides):
        return paged_decode_attention_plain(q, kv_pages, block_tables, lens,
                                            side_k, side_v, j, scale)
    _loader.check_cuda(NAME, q.dtype, q=q, kv_pages=kv_pages,
                       block_tables=block_tables, lens=lens,
                       **dict(zip(("side_k", "side_v"), sides)))
    out = torch.empty_like(q)
    P = _loader.ptr
    _loader.launch(NAME, "dstorch_paged_decode_bf16", q.device,
                   P(q), P(kv_pages), P(block_tables), P(lens), P(side_k),
                   P(side_v), P(out), S, H, Hkv, D, bs, MB, C, int(j), scale)
    return out


def paged_decode_attention_plain(q, kv_pages, block_tables, lens, side_k=None,
                                 side_v=None, j: int = 0,
                                 softmax_scale: Optional[float] = None):
    """The same function in plain PyTorch, computed in f32; returns q's
    dtype."""
    S, H, D = q.shape
    _, _, Hkv, bs, _ = kv_pages.shape
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    n_pages = -(-int(lens.max()) // bs) if S else 0
    T = n_pages * bs
    pages = kv_pages[block_tables[:, :n_pages].long()]     # [S, P, 2, Hkv, bs, D]

    def rows(i):
        return pages[:, :, i].float().permute(0, 2, 1, 3, 4).reshape(S, Hkv, T, D)

    k, v = rows(0), rows(1)
    mask = torch.arange(T, device=q.device)[None] < lens.long()[:, None]
    if side_k is not None:
        C = side_k.shape[1] // Hkv
        sk = side_k.view(S, C, Hkv, D)[:, :j + 1].float().transpose(1, 2)
        sv = side_v.view(S, C, Hkv, D)[:, :j + 1].float().transpose(1, 2)
        k = torch.cat([k, sk], dim=2)
        v = torch.cat([v, sv], dim=2)
        mask = torch.cat([mask, mask.new_ones((S, j + 1))], dim=1)
    s = torch.einsum("shgd,shtd->shgt", q.float().view(S, Hkv, G, D), k) * scale
    out = masked_softmax_av(s, mask[:, None, None, :], v, "shgt,shtd->shgd")
    return out.reshape(S, H, D).to(q.dtype)
