"""Batched prompt-chunk attention over paged KV: CUDA kernel
``csrc/paged_chunk.cu`` and its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/paged_attention.py``
``paged_chunk_attention_batched``: one slot per prompt chunk, each with its
own block-table row, ``q_start`` and ``ctx``; row r of a slot sits at
position ``q_start + r`` and sees keys ``k_pos <= q_pos`` with
``k_pos < ctx``. An empty slot (ctx 0) gives zeros. A sliding ``window``
also needs ``k_pos > q_pos - window`` (by logical position, so tables that
repeat physical pages under the scheduler's page ring read the right
tokens); pages wholly below a q-block's lowest visible key are not read. A
windowed launch counts as ``paged_chunk_window``.

ALiBi (``alibi=True``; ``_chunk_kernel_batched`` :1493-1498): each visible
score of q-head ``h`` (``kv_head * G + g``) gets ``slope[h] * k_pos``, the
key's absolute position (``ops/kernels/alibi.py``), after the scale and
before the softmax. An ALiBi launch counts as ``paged_chunk_alibi``.

int8 pages (``kv_scales``, the kv_quant pool): ``kv_pages`` is int8 with
its f32 scale tiles ``[NB, R8, 128]`` (``kv_quant``), the int8 body of the
same kernel (``_chunk_kernel_batched_quant`` :1528, with the per-head scale
fold ``_chunk_head_scale`` :1422), with the window and ALiBi as over bf16
pages: its launches count as ``paged_chunk_int8``,
``paged_chunk_int8_window`` and ``paged_chunk_int8_alibi``.

The kernel runs on the tensor cores: one block of ``CHUNK_ROWS`` mma rows a
(q-tile, kv head, slot), the rows being a slot's (row, query head) pairs
``r * G + g``, so each K/V tile it reads (and over int8 pages converts)
serves all G query heads of its kv head. :func:`chunk_grid` and
:func:`chunk_table_cap` are its launch plan from shapes alone (the C
launcher computes the same).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels._plain import masked_softmax_av
from deepspeed_tpu_torch.ops.kernels.alibi import alibi_slopes
from deepspeed_tpu_torch.ops.kernels.kv_quant import scale_tile_rows
from deepspeed_tpu_torch.ops.kernels.paged_decode import gather_rows

NAME = "paged_chunk"
NAME_INT8 = "paged_chunk_int8"
NAME_WINDOW = "paged_chunk_window"
NAME_ALIBI = "paged_chunk_alibi"
SOURCE = "deepspeed_tpu_torch/csrc/paged_chunk.cu"
REPLACES = "deepspeed_tpu/ops/pallas/paged_attention.py:1534"
REPLACES_WINDOW = ("deepspeed_tpu/ops/pallas/paged_attention.py:1534 window= "
                   "(_chunk_kernel_batched :1443; window :1466-1478)")
REPLACES_ALIBI = ("deepspeed_tpu/ops/pallas/paged_attention.py:1534 alibi=True "
                  "(_chunk_kernel_batched :1443; alibi :1493-1498; slope _alibi_slope :204)")
REPLACES_INT8 = ("deepspeed_tpu/ops/pallas/paged_attention.py:1528 "
                 "_chunk_kernel_batched_quant (K5; scale fold _chunk_head_scale :1422)")
REPLACES_INT8_WINDOW = ("deepspeed_tpu/ops/pallas/paged_attention.py:1528 "
                        "_chunk_kernel_batched_quant window= (bound at :1574-1577; "
                        "window :1466-1478)")
REPLACES_INT8_ALIBI = ("deepspeed_tpu/ops/pallas/paged_attention.py:1528 "
                       "_chunk_kernel_batched_quant alibi=True (bound at :1574-1577; "
                       "alibi :1493-1498)")

# (row, head) pairs a block takes: the kernel's kChRows (4 warps of 16 mma rows)
CHUNK_ROWS = 64


def chunk_grid(NC: int, Cs: int, H: int, Hkv: int):
    """The kernel's grid: (q-tiles of ``CHUNK_ROWS`` (row, head) pairs of a
    slot, kv heads, slots)."""
    return (-(-Cs * (H // Hkv) // CHUNK_ROWS), Hkv, NC)


def chunk_table_cap(MB: int, bs: int, window: Optional[int]) -> int:
    """Block-table entries a block stages in shared memory: under a window
    its key range spans at most ``window + CHUNK_ROWS - 1`` keys (the
    decode walk's ``decode_table_cap``), else the whole row."""
    if window:
        return min((window + CHUNK_ROWS) // bs + 2, MB)
    return MB


def paged_chunk_attention_batched(q: torch.Tensor, kv_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  q_starts: torch.Tensor, ctx_lens: torch.Tensor,
                                  softmax_scale: Optional[float] = None,
                                  kv_scales: Optional[torch.Tensor] = None,
                                  window: Optional[int] = None,
                                  alibi: bool = False) -> torch.Tensor:
    """q [NC, Cs, H, D]; kv_pages [NB, 2, Hkv, bs, D] (one layer);
    block_tables [NC, MB], q_starts [NC], ctx_lens [NC] int32; ``kv_scales``
    [NB, R8, 128] f32 for int8 pages; ``window`` (None: none) and
    ``alibi``, over either pool -> [NC, Cs, H, D].

    CPU tensors run :func:`paged_chunk_attention_batched_plain`; CUDA tensors
    launch the kernel (bf16 q; bf16 pages, or int8 pages with their scale
    tiles; contiguous) or raise."""
    NC, Cs, H, D = q.shape
    NB, two, Hkv, bs, Dk = kv_pages.shape
    MB = block_tables.shape[1]
    if two != 2 or Dk != D or H % Hkv or block_tables.shape != (NC, MB) \
            or q_starts.shape != (NC,) or ctx_lens.shape != (NC,):
        raise ValueError(f"{NAME}: bad shapes q {tuple(q.shape)} kv "
                         f"{tuple(kv_pages.shape)} bt {tuple(block_tables.shape)}")
    quant = kv_scales is not None
    if quant and tuple(kv_scales.shape) != (NB, scale_tile_rows(Hkv, bs), 128):
        raise ValueError(f"{NAME}: scale tiles {tuple(kv_scales.shape)} do not fit "
                         f"pages {tuple(kv_pages.shape)}")
    name = _loader.variant(NAME_INT8 if quant else NAME, window, alibi)
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    extra = (kv_scales,) if quant else ()
    if _loader.on_cpu(name, q, kv_pages, block_tables, q_starts, ctx_lens, *extra):
        return paged_chunk_attention_batched_plain(q, kv_pages, block_tables,
                                                   q_starts, ctx_lens, scale, kv_scales,
                                                   window, alibi)
    out = torch.empty_like(q)
    P = _loader.ptr
    slopes = alibi_slopes(H, q.device) if alibi else None
    slope_kw = {"slopes": slopes} if alibi else {}
    if quant:
        _loader.check_cuda(name, q.dtype, f32=("kv_scales", "slopes"), i8=("kv_pages",),
                           q=q, kv_pages=kv_pages, kv_scales=kv_scales,
                           block_tables=block_tables, q_starts=q_starts,
                           ctx_lens=ctx_lens, **slope_kw)
        _loader.launch(name, "dstorch_paged_chunk_int8", q.device,
                       P(q), P(kv_pages), P(kv_scales), P(block_tables), P(q_starts),
                       P(ctx_lens), P(slopes), P(out), NC, Cs, H, Hkv, D, bs, MB,
                       kv_scales.shape[1], _loader.window_arg(window), scale)
        return out
    _loader.check_cuda(name, q.dtype, f32=("slopes",), q=q, kv_pages=kv_pages,
                       block_tables=block_tables, q_starts=q_starts,
                       ctx_lens=ctx_lens, **slope_kw)
    _loader.launch(name, "dstorch_paged_chunk_bf16", q.device,
                   P(q), P(kv_pages), P(block_tables), P(q_starts), P(ctx_lens),
                   P(slopes), P(out), NC, Cs, H, Hkv, D, bs, MB,
                   _loader.window_arg(window), scale)
    return out


def paged_chunk_attention_batched_plain(q, kv_pages, block_tables, q_starts,
                                        ctx_lens,
                                        softmax_scale: Optional[float] = None,
                                        kv_scales: Optional[torch.Tensor] = None,
                                        window: Optional[int] = None,
                                        alibi: bool = False):
    """The same function in plain PyTorch, computed in f32; returns q's
    dtype."""
    NC, Cs, H, D = q.shape
    _, _, Hkv, bs, _ = kv_pages.shape
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    n_pages = -(-int(ctx_lens.max()) // bs) if NC else 0
    if n_pages == 0:
        return torch.zeros_like(q)
    T = n_pages * bs
    k, v = (x.repeat_interleave(G, dim=1)                  # [NC, H, T, D]
            for x in gather_rows(kv_pages, block_tables, n_pages, kv_scales))
    s = torch.einsum("nqhd,nhkd->nhqk", q.float(), k) * scale
    q_pos = q_starts.long()[:, None] + torch.arange(Cs, device=q.device)[None]
    k_pos = torch.arange(T, device=q.device)
    if alibi:
        s = s + alibi_slopes(H, q.device)[:, None, None] * k_pos.float()
    mask = ((k_pos[None, None, :] <= q_pos[:, :, None])
            & (k_pos[None, None, :] < ctx_lens.long()[:, None, None]))
    if window is not None:
        mask &= k_pos[None, None, :] > q_pos[:, :, None] - window
    return masked_softmax_av(s, mask[:, None], v, "nhqk,nhkd->nqhd").to(q.dtype)
