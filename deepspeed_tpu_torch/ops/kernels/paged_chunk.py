"""Batched prompt-chunk attention over paged KV: CUDA kernel
``csrc/paged_chunk.cu`` and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/paged_attention.py``
``paged_chunk_attention_batched``: one slot per prompt chunk, each with its
own block-table row, ``q_start`` and ``ctx``; row r of a slot sits at
position ``q_start + r`` and sees keys ``k_pos <= q_pos`` with
``k_pos < ctx``. An empty slot (ctx 0) gives zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels._plain import masked_softmax_av

NAME = "paged_chunk"
SOURCE = "deepspeed_tpu_torch/csrc/paged_chunk.cu"
REPLACES = "deepspeed_tpu/ops/pallas/paged_attention.py:1534"


def paged_chunk_attention_batched(q: torch.Tensor, kv_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  q_starts: torch.Tensor, ctx_lens: torch.Tensor,
                                  softmax_scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """q [NC, Cs, H, D]; kv_pages [NB, 2, Hkv, bs, D] (one layer);
    block_tables [NC, MB], q_starts [NC], ctx_lens [NC] int32 ->
    [NC, Cs, H, D].

    CPU tensors run :func:`paged_chunk_attention_batched_plain`; CUDA tensors
    launch the kernel (bf16, contiguous) or raise."""
    NC, Cs, H, D = q.shape
    NB, two, Hkv, bs, Dk = kv_pages.shape
    MB = block_tables.shape[1]
    if two != 2 or Dk != D or H % Hkv or block_tables.shape != (NC, MB) \
            or q_starts.shape != (NC,) or ctx_lens.shape != (NC,):
        raise ValueError(f"{NAME}: bad shapes q {tuple(q.shape)} kv "
                         f"{tuple(kv_pages.shape)} bt {tuple(block_tables.shape)}")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if _loader.on_cpu(NAME, q, kv_pages, block_tables, q_starts, ctx_lens):
        return paged_chunk_attention_batched_plain(q, kv_pages, block_tables,
                                                   q_starts, ctx_lens, scale)
    _loader.check_cuda(NAME, q.dtype, q=q, kv_pages=kv_pages,
                       block_tables=block_tables, q_starts=q_starts,
                       ctx_lens=ctx_lens)
    if kv_pages.dtype != q.dtype:
        raise TypeError(f"{NAME}: kv_pages {kv_pages.dtype} != q {q.dtype}")
    out = torch.empty_like(q)
    P = _loader.ptr
    _loader.launch(NAME, "dstorch_paged_chunk_bf16", q.device,
                   P(q), P(kv_pages), P(block_tables), P(q_starts), P(ctx_lens),
                   P(out), NC, Cs, H, Hkv, D, bs, MB, scale)
    return out


def paged_chunk_attention_batched_plain(q, kv_pages, block_tables, q_starts,
                                        ctx_lens,
                                        softmax_scale: Optional[float] = None):
    """The same function in plain PyTorch, computed in f32; returns q's
    dtype."""
    NC, Cs, H, D = q.shape
    _, _, Hkv, bs, _ = kv_pages.shape
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    n_pages = -(-int(ctx_lens.max()) // bs) if NC else 0
    if n_pages == 0:
        return torch.zeros_like(q)
    pages = kv_pages[block_tables[:, :n_pages].long()]     # [NC, P, 2, Hkv, bs, D]
    T = n_pages * bs

    def side(i):
        x = pages[:, :, i].float().permute(0, 2, 1, 3, 4).reshape(NC, Hkv, T, D)
        return x.repeat_interleave(G, dim=1)               # [NC, H, T, D]

    s = torch.einsum("nqhd,nhkd->nhqk", q.float(), side(0)) * scale
    q_pos = q_starts.long()[:, None] + torch.arange(Cs, device=q.device)[None]
    k_pos = torch.arange(T, device=q.device)
    mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
            & (k_pos[None, None, :] < ctx_lens.long()[:, None, None]))
    return masked_softmax_av(s, mask[:, None], side(1),
                             "nhqk,nhkd->nqhd").to(q.dtype)
