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

Sliding ``window`` (``_decode_body``'s window, :303-349 and :487-488): the
query of a row without side rows sits at ``lens - 1`` and sees page tokens
from ``max(lens - window, 0)``; with side rows it sits at ``prefix + j``,
so page tokens from ``max(prefix + j + 1 - window, 0)`` and side rows
``cc >= j + 1 - window``. Pages below that start are not read, and tokens
are masked by logical position, so tables that repeat physical pages under
the scheduler's page ring read the right tokens. A windowed launch counts
as ``paged_decode_window``.

ALiBi (``alibi=True``; ``_decode_body`` :461-465 and :493-496, the step's
current token :529-531, ``_decode_kernel_smalld`` :1028-1032): query head
``h`` adds ``slope[h] * pos`` to each visible score, ``pos`` the key's
absolute position: ``t`` for page token ``t``, ``lens + cc`` for side row
``cc`` (so the decode step's current token, one side row over ``ctx - 1``
page tokens, sits at ``ctx - 1``). An ALiBi launch counts as
``paged_decode_alibi``.

int8 pages (``kv_scales``, the kv_quant pool): ``kv_pages`` is int8 with
its f32 scale tiles ``[NB, R8, 128]`` (``kv_quant``), the int8 bodies of
the same three entry points (``_decode_kernel_quant`` :561,
``_decode_step_kernel_quant`` :1217, ``_decode_kernel_sidebuf_quant`` :772,
``_sidebuf_batched_kernel_quant`` :792). The side rows are then f32: they
hold ``kv_write_dequant`` values, which a bf16 copy would round away from
what the pages store. The window and ALiBi apply over int8 pages as over
bf16 ones (the Pallas int8 bodies are built with ``window=`` and
``alibi=`` too, :1134-1140): their launches count as
``paged_decode_int8_window``, ``paged_decode_int8_alibi`` and so on.

A launch with more than one side row (``C > 1``: the side buffer of a
``decode_steps`` burst, ``_sidebuf_batched_kernel(_quant)`` :783/:792)
counts under the ``_side`` names (``paged_decode_side``,
``paged_decode_int8_side``, ``paged_decode_side_window``,
``paged_decode_side_alibi``), apart from the one-row decode step.

The kernel runs each (sequence, kv head) as a thread-block cluster of
:func:`cluster_ranks` blocks, each walking one slice of the sequence's
visible range; the ranks' states merge inside the cluster (one launch, no
scratch). The host picks the cluster size from the shapes and the card's
SM count only, never from ``lens``.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels._plain import masked_softmax_av
from deepspeed_tpu_torch.ops.kernels.alibi import alibi_slopes
from deepspeed_tpu_torch.ops.kernels.kv_quant import (scale_tile_rows,
                                                      scales_from_tiles)

NAME = "paged_decode"
NAME_INT8 = "paged_decode_int8"
NAME_WINDOW = "paged_decode_window"
NAME_ALIBI = "paged_decode_alibi"
NAME_SIDE = "paged_decode_side"
NAME_INT8_SIDE = "paged_decode_int8_side"
SOURCE = "deepspeed_tpu_torch/csrc/paged_decode.cu"
REPLACES = ("deepspeed_tpu/ops/pallas/paged_attention.py:1088 (K3), "
            ":1249 (K4), :809 (K6); body _decode_body :280")
REPLACES_WINDOW = ("deepspeed_tpu/ops/pallas/paged_attention.py:1088 (K3), :1249 (K4), "
                   ":809 (K6) window=; _decode_body :280 (window :303-349, side rows "
                   ":487-488), _sidebuf_batched_body :569 (:594-612, :744-745)")
REPLACES_ALIBI = ("deepspeed_tpu/ops/pallas/paged_attention.py:1088 (K3), :1053 (K3s), "
                  ":1249 (K4), :809 (K6) alibi=True; _decode_body :461-465, :493-496, "
                  ":529-531; _sidebuf_batched_body :722-726, :750-752; "
                  "_decode_kernel_smalld :1028-1032")
REPLACES_INT8 = ("deepspeed_tpu/ops/pallas/paged_attention.py:561 "
                 "_decode_kernel_quant (K3), :1217 (K4), :772 and :792 (K6)")
REPLACES_INT8_WINDOW = ("deepspeed_tpu/ops/pallas/paged_attention.py:561 "
                        "_decode_kernel_quant (K3), :1217 (K4), :772 and :792 (K6) "
                        "window= (bound at :1134-1140; _decode_body window :303-349, "
                        "side rows :487-488)")
REPLACES_INT8_ALIBI = ("deepspeed_tpu/ops/pallas/paged_attention.py:561 "
                       "_decode_kernel_quant (K3), :1217 (K4), :772 and :792 (K6) "
                       "alibi=True (_decode_body :461-465, :493-496; "
                       "_sidebuf_batched_body :722-726, :750-752)")
REPLACES_SIDE = ("deepspeed_tpu/ops/pallas/paged_attention.py:809 (K6, C > 1) -> "
                 "_sidebuf_batched_kernel :783 (body _sidebuf_batched_body :569)")
REPLACES_INT8_SIDE = ("deepspeed_tpu/ops/pallas/paged_attention.py:809 (K6, C > 1) -> "
                      "_sidebuf_batched_kernel_quant :792 (body :569)")


CLUSTER_MAX = {False: 4, True: 8}   # bf16 / int8 pages (PERF.md §6: clusters of 8
                                    # lost over bf16 pages, won over int8)


def cluster_ranks(S: int, Hkv: int, sms: int, quant: bool = False) -> int:
    """Blocks a (sequence, kv head) cluster of the decode kernel: the
    smallest power of two up to ``CLUSTER_MAX[quant]`` for which the
    launch's ``S * Hkv * n`` blocks fill one block an SM over bf16 pages,
    two over int8 pages (``quant``: half the bytes a token, so a block
    streams them at its compute's pace and more blocks keep the card
    busy)."""
    n, want = 1, (2 if quant else 1) * sms
    while n < CLUSTER_MAX[quant] and S * Hkv * n < want:
        n *= 2
    return n


def check_paged_inputs(name: str, q, kv_pages, block_tables, lens, side_k, side_v,
                       j: int, kv_scales) -> int:
    """Validate the decode kernels' shapes (q [S, H, D], pages
    [NB, 2, Hkv, bs, D], tables [S, MB], lens [S], side rows
    [S, C * Hkv, D], scale tiles [NB, R8, 128]); returns C (0 without side
    rows)."""
    S, H, D = q.shape
    NB, two, Hkv, bs, Dk = kv_pages.shape
    MB = block_tables.shape[1]
    if two != 2 or Dk != D or H % Hkv or block_tables.shape != (S, MB) \
            or lens.shape != (S,):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} kv "
                         f"{tuple(kv_pages.shape)} bt {tuple(block_tables.shape)} "
                         f"lens {tuple(lens.shape)}")
    if kv_scales is not None and tuple(kv_scales.shape) != (
            NB, scale_tile_rows(Hkv, bs), 128):
        raise ValueError(f"{name}: scale tiles {tuple(kv_scales.shape)} do not "
                         f"fit pages {tuple(kv_pages.shape)}")
    if side_k is None:
        return 0
    if side_v is None or side_k.shape != side_v.shape or side_k.ndim != 3 \
            or side_k.shape[0] != S or side_k.shape[2] != D \
            or side_k.shape[1] % Hkv:
        raise ValueError(f"{name}: side rows must be [S, C*Hkv, D] pairs")
    C = side_k.shape[1] // Hkv
    if not 0 <= j < C:
        raise ValueError(f"{name}: step j={j} outside [0, {C})")
    return C


def launch_name(quant: bool, window: Optional[int], alibi: bool, C: int) -> str:
    """The decode kernel's launch-count name: ``paged_decode`` or
    ``paged_decode_int8``, with ``_side`` for more than one side row, then
    the window and ALiBi suffixes."""
    base = (NAME_INT8 if quant else NAME) + ("_side" if C > 1 else "")
    return _loader.variant(base, window, alibi)


def alibi_positions(S: int, T: int, lens: torch.Tensor, j: int, side: bool,
                    device) -> torch.Tensor:
    """Absolute key positions [S, T (+ j + 1)] f32 of the plain decode
    versions' key axis: page tokens ``0 .. T-1``, then (with side rows) side
    row ``cc`` at ``lens + cc``."""
    pos = torch.arange(T, device=device, dtype=torch.float32)[None].expand(S, T)
    if not side:
        return pos
    cc = torch.arange(j + 1, device=device)
    return torch.cat([pos, (lens.long()[:, None] + cc[None]).float()], dim=1)


def window_starts(lens: torch.Tensor, j: int, window: Optional[int], side: bool):
    """Each row's first visible page token [S] (long) and first visible side
    row under a sliding ``window``; (0s, 0) without one."""
    lens = lens.long()
    if window is None:
        return torch.zeros_like(lens), 0
    q_next = lens + j + 1 if side else lens        # query position + 1
    return (q_next - window).clamp_min(0), max(j + 1 - window, 0)


def paged_decode_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                           block_tables: torch.Tensor, lens: torch.Tensor,
                           side_k: Optional[torch.Tensor] = None,
                           side_v: Optional[torch.Tensor] = None, j: int = 0,
                           softmax_scale: Optional[float] = None,
                           kv_scales: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                           alibi: bool = False) -> torch.Tensor:
    """q [S, H, D]; kv_pages [NB, 2, Hkv, bs, D] (one layer); block_tables
    [S, MB], lens [S] int32 (page tokens attended per sequence); optional
    side_k/side_v [S, C * Hkv, D] with step ``j``; ``kv_scales`` [NB, R8,
    128] f32 for int8 pages; ``window`` (None: none) and ``alibi``, over
    either pool -> [S, H, D].

    CPU tensors run :func:`paged_decode_attention_plain`; CUDA tensors launch
    the kernel (bf16 q; bf16 pages and side rows, or int8 pages with f32
    side rows; contiguous; at most 8 query heads a kv head) or raise."""
    S, H, D = q.shape
    NB, _, Hkv, bs, _ = kv_pages.shape
    MB = block_tables.shape[1]
    quant = kv_scales is not None
    C = check_paged_inputs(NAME_INT8 if quant else NAME, q, kv_pages, block_tables, lens,
                           side_k, side_v, j, kv_scales)
    name = launch_name(quant, window, alibi, C)
    sides = () if side_k is None else (side_k, side_v)
    extra = (kv_scales,) if quant else ()
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if _loader.on_cpu(name, q, kv_pages, block_tables, lens, *sides, *extra):
        return paged_decode_attention_plain(q, kv_pages, block_tables, lens,
                                            side_k, side_v, j, scale, kv_scales, window,
                                            alibi)
    side_kw = dict(zip(("side_k", "side_v"), sides))
    out = torch.empty_like(q)
    n_cl = cluster_ranks(S, Hkv, _loader.sm_count(q.device), quant)
    P = _loader.ptr
    slopes = alibi_slopes(H, q.device) if alibi else None
    slope_kw = {"slopes": slopes} if alibi else {}
    if quant:
        _loader.check_cuda(name, q.dtype, f32=("kv_scales", "side_k", "side_v", "slopes"),
                           i8=("kv_pages",), q=q, kv_pages=kv_pages,
                           kv_scales=kv_scales, block_tables=block_tables, lens=lens,
                           **side_kw, **slope_kw)
        _loader.launch(name, "dstorch_paged_decode_int8", q.device,
                       P(q), P(kv_pages), P(kv_scales), P(block_tables), P(lens),
                       P(side_k), P(side_v), P(slopes), P(out), S, H, Hkv, D, bs, MB,
                       kv_scales.shape[1], C, int(j), _loader.window_arg(window), scale, n_cl)
        return out
    _loader.check_cuda(name, q.dtype, f32=("slopes",), q=q, kv_pages=kv_pages,
                       block_tables=block_tables, lens=lens, **side_kw, **slope_kw)
    _loader.launch(name, "dstorch_paged_decode_bf16", q.device,
                   P(q), P(kv_pages), P(block_tables), P(lens), P(side_k),
                   P(side_v), P(slopes), P(out), S, H, Hkv, D, bs, MB, C, int(j),
                   _loader.window_arg(window), scale, n_cl)
    return out


def gather_rows(kv_pages, block_tables, n_pages: int,
                kv_scales: Optional[torch.Tensor] = None):
    """Each row's first ``n_pages`` pages as f32 K and V ``[R, Hkv, T, D]``
    (T = n_pages * bs), dequantized when ``kv_scales`` is given."""
    R = block_tables.shape[0]
    _, _, Hkv, bs, D = kv_pages.shape
    T = n_pages * bs
    idx = block_tables[:, :n_pages].long()
    pages = kv_pages[idx].float()                          # [R, P, 2, Hkv, bs, D]
    if kv_scales is not None:
        pages = pages * scales_from_tiles(kv_scales, Hkv, bs)[idx][..., None]

    def rows(i):
        return pages[:, :, i].permute(0, 2, 1, 3, 4).reshape(R, Hkv, T, D)

    return rows(0), rows(1)


def paged_decode_attention_plain(q, kv_pages, block_tables, lens, side_k=None,
                                 side_v=None, j: int = 0,
                                 softmax_scale: Optional[float] = None,
                                 kv_scales: Optional[torch.Tensor] = None,
                                 window: Optional[int] = None, alibi: bool = False):
    """The same function in plain PyTorch, computed in f32; returns q's
    dtype."""
    S, H, D = q.shape
    _, _, Hkv, bs, _ = kv_pages.shape
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    n_pages = -(-int(lens.max()) // bs) if S else 0
    T = n_pages * bs
    k, v = gather_rows(kv_pages, block_tables, n_pages, kv_scales)
    t_lo, c_lo = window_starts(lens, j, window, side_k is not None)
    pos = torch.arange(T, device=q.device)[None]
    mask = (pos < lens.long()[:, None]) & (pos >= t_lo[:, None])
    if side_k is not None:
        C = side_k.shape[1] // Hkv
        sk = side_k.view(S, C, Hkv, D)[:, :j + 1].float().transpose(1, 2)
        sv = side_v.view(S, C, Hkv, D)[:, :j + 1].float().transpose(1, 2)
        k = torch.cat([k, sk], dim=2)
        v = torch.cat([v, sv], dim=2)
        side_ok = torch.arange(j + 1, device=q.device) >= c_lo
        mask = torch.cat([mask, side_ok[None].expand(S, j + 1)], dim=1)
    s = torch.einsum("shgd,shtd->shgt", q.float().view(S, Hkv, G, D), k) * scale
    if alibi:
        pos = alibi_positions(S, T, lens, j, side_k is not None, q.device)
        s = s + alibi_slopes(H, q.device).view(1, Hkv, G, 1) * pos[:, None, None]
    out = masked_softmax_av(s, mask[:, None, None, :], v, "shgt,shtd->shgd")
    return out.reshape(S, H, D).to(q.dtype)
