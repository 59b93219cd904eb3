"""Flash-decoding split-K paged decode attention (K7): CUDA kernels
``csrc/paged_splitk.cu`` and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas/paged_splitk.py``. Each
sequence's visible token range (``[0, lens)``, or from the sliding
window's first visible token) is cut into ``n_splits`` pieces of
``ceil(range / n_splits)`` tokens (:func:`piece_bounds`; the kernel cuts it
so on the device); each piece yields an f32 partial ``(out, lse)`` over its
own tokens (``out`` normalised by its own sum, ``lse = m + log l``; an
empty piece gives ``(0, -1e30)``), and the partials merge with logsumexp
weights (:func:`merge_splitk_partials`):

    m = max_p lse_p;  w_p = exp(lse_p - m);  out = sum_p w_p out_p / sum_p w_p

The JAX package cuts the block table's width ``[0, MB)`` into splits of
``ceil(MB / n_splits)`` pages instead; the merged output and lse are the
same function either way (up to rounding), and the tests hold the plain
version against the Pallas kernel.

- :func:`splitk_attention` is the kernel pair: the partials kernel (one
  block per (sequence x piece, kv head); with side rows one more piece per
  sequence attends the side rows ``cc <= j``) and the merge kernel
  (:func:`splitk_merge`, a second small CUDA kernel where the JAX package
  merges in XLA). Its plain version :func:`splitk_attention_plain`
  computes the same partials and merge in PyTorch (the JAX package's
  ``paged_decode_attention_xla`` :123 is that composition).
- The dispatchers, one per caller shape, as in JAX:
  :func:`paged_decode_attention_splitk` (:597), :func:`paged_sidebuf_attention_splitk`
  (:725, prefix splits + the side piece merged as n_splits + 1 pieces),
  :func:`paged_decode_attention_splitk_step` (:668, write the current token
  first, then attend) and :func:`paged_chunk_attention_splitk` (:639).
- :func:`paged_chunk_attention_xla` (:228) is the multi-query split path of
  the chunk dispatcher. The JAX package computes it outside any Pallas
  kernel on every backend (split-K buys the compute-bound chunk attention
  nothing); here it is plain PyTorch on every device, likewise. The
  engine's chunk attention does not take it: ``AttentionKernelSpec.chunk``
  runs the chunk kernel (K5) at every rung.

int8 pages (``kv_scales``) dequantize each gathered row (``k * s``), the
algebra the kernels fold into their score and p columns; an int8 partials
launch counts under the ``_int8`` names (``paged_splitk_int8/<n>``,
``paged_splitk_int8_window/<n>``, ``paged_splitk_int8_side_alibi/<n>``),
with the window and ALiBi as over bf16 pages. A split count above 1 always
runs split-K; ``n_splits <= 1`` is the base kernel.

A sliding ``window`` (``_splitk_body`` :324-377, the dispatchers :597-725)
moves the start of the range the pieces cut to the first visible token
(as the decode kernel: ``max(ctx - window, 0)``, or ``max(prefix + j + 1 -
window, 0)`` with side rows, whose piece needs ``cc >= j + 1 - window``),
so no piece reads a page below it. A windowed partials launch counts as
``paged_splitk_window/<n>``.

ALiBi (``alibi=True``; ``_splitk_body`` :467-471, the XLA split paths
:174-175/:200 and :266-267/:295, the side-slab piece :800-805): each
split's partial biases its scores by ``slope[h] * k_pos`` with ``k_pos``
the key's ABSOLUTE position, and the side piece by ``prefix + cc``, so
every partial's lse carries the same row constant and the merge is
unchanged. An ALiBi partials launch counts as ``paged_splitk_alibi/<n>``.

A partials launch whose side piece holds more than one side row (``C >
1``: a ``decode_steps`` burst's side buffer, the dispatcher :725) counts
under the ``_side`` names (``paged_splitk_side/<n>``,
``paged_splitk_side_window/<n>``, ``paged_splitk_side_alibi/<n>``).
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels.alibi import alibi_slopes
from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_quantize_rows
from deepspeed_tpu_torch.ops.kernels.paged_chunk import paged_chunk_attention_batched
from deepspeed_tpu_torch.ops.kernels.paged_decode import (alibi_positions,
                                                          check_paged_inputs,
                                                          gather_rows,
                                                          paged_decode_attention,
                                                          window_starts)

NAME = "paged_splitk"          # counted per split count: paged_splitk/<n>
NAME_WINDOW = "paged_splitk_window"
MERGE = "splitk_merge"
SOURCE = "deepspeed_tpu_torch/csrc/paged_splitk.cu"
REPLACES = ("deepspeed_tpu/ops/pallas/paged_splitk.py:499 "
            "paged_decode_attention_splitk_pallas (K7; _splitk_kernel :485, "
            "_splitk_kernel_quant :491, body _splitk_body :324)")
REPLACES_WINDOW = ("deepspeed_tpu/ops/pallas/paged_splitk.py:499 window= (_splitk_body "
                   ":324; window :345-377; dispatchers :597-725)")
REPLACES_ALIBI = ("deepspeed_tpu/ops/pallas/paged_splitk.py:499 alibi=True (_splitk_body "
                  ":324; alibi :467-471; side-slab piece :800-805)")
REPLACES_SIDE = ("deepspeed_tpu/ops/pallas/paged_splitk.py:499 with the side piece at "
                 "C > 1 (paged_sidebuf_attention_splitk :725; side slab :800-805)")
REPLACES_INT8_WINDOW = ("deepspeed_tpu/ops/pallas/paged_splitk.py:491 _splitk_kernel_quant "
                        "window= (bound at :544; _splitk_body :324, window :345-377; "
                        "dispatchers :597-725)")
REPLACES_INT8_ALIBI = ("deepspeed_tpu/ops/pallas/paged_splitk.py:491 _splitk_kernel_quant "
                       "alibi=True (_splitk_body :467-471; side-slab piece :800-805)")
REPLACES_MERGE = "deepspeed_tpu/ops/pallas/paged_splitk.py:84 merge_splitk_partials"
NEG_INF = -1e30


def kernel_name(n_splits: int, window: Optional[int] = None, alibi: bool = False,
                side: bool = False, quant: bool = False) -> str:
    """The partials kernel's launch-count name; ``side``: a side piece of
    more than one side row; ``quant``: int8 pages."""
    base = NAME + ("_int8" if quant else "") + ("_side" if side else "")
    return f"{_loader.variant(base, window, alibi)}/{int(n_splits)}"


def split_pages(max_blocks: int, n_splits: int) -> int:
    """Pages per split: ``ceil(MB / n_splits)``."""
    return -(-max_blocks // n_splits)


def piece_bounds(lens: torch.Tensor, j: int, window: Optional[int], side: bool,
                 n_splits: int):
    """Each sequence's visible page tokens cut into ``n_splits`` pieces, as
    the partials kernel cuts them on the device: ``(lo, hi)`` long ``[S,
    n_splits]``, piece p = ``[lo0 + p c, min(lo0 + (p + 1) c, lens))`` with
    ``lo0`` the first visible token (:func:`window_starts`) and ``c =
    ceil((lens - lo0) / n_splits)``; empty pieces have ``lo == hi``."""
    start, _ = window_starts(lens, j, window, side)
    end = torch.maximum(lens.long(), start)
    c = -(-(end - start) // n_splits)
    p = torch.arange(n_splits, device=lens.device)
    lo = torch.minimum(start[:, None] + p[None] * c[:, None], end[:, None])
    return lo, torch.minimum(lo + c[:, None], end[:, None])


# --------------------------------------------------------------------- #
# the logsumexp merge
# --------------------------------------------------------------------- #

def merge_splitk_partials(out_p: torch.Tensor, lse_p: torch.Tensor):
    """``out_p [S, P, H, D]`` f32 partials (each normalised by its own sum)
    and ``lse_p [S, P, H]`` (``-1e30`` = empty) -> ``(out [S, H, D] f32,
    lse [S, H] f32)``. Empty partials weigh 0; an all-empty row gives
    ``(0, -1e30)``."""
    m = lse_p.amax(dim=1)
    # mask before exp: for an all-empty row lse_p - m == 0 and a bare exp
    # would weigh the empty partials 1
    w = torch.where(lse_p > NEG_INF * 0.5, torch.exp(lse_p - m[:, None]),
                    torch.zeros_like(lse_p))
    den = w.sum(dim=1)
    safe = torch.where(den > 0, den, torch.ones_like(den))
    out = (w[..., None] * out_p.float()).sum(dim=1) / safe[..., None]
    lse = torch.where(den > 0, m + torch.log(safe), torch.full_like(m, NEG_INF))
    return out, lse


def splitk_merge(out_p: torch.Tensor, lse_p: torch.Tensor, dtype: torch.dtype,
                 with_lse: bool = False):
    """:func:`merge_splitk_partials` with the output in ``dtype``: CPU
    tensors run it in PyTorch; CUDA tensors launch the merge kernel (f32
    partials, bf16 output) or raise."""
    S, P, H, D = out_p.shape
    if lse_p.shape != (S, P, H):
        raise ValueError(f"{MERGE}: bad shapes out_p {tuple(out_p.shape)} "
                         f"lse_p {tuple(lse_p.shape)}")
    if _loader.on_cpu(MERGE, out_p, lse_p):
        out, lse = merge_splitk_partials(out_p, lse_p)
        out = out.to(dtype)
        return (out, lse) if with_lse else out
    _loader.check_cuda(MERGE, dtype, f32=("out_p", "lse_p"), out_p=out_p, lse_p=lse_p)
    out = torch.empty((S, H, D), dtype=dtype, device=out_p.device)
    lse = torch.empty((S, H), dtype=torch.float32, device=out_p.device) \
        if with_lse else None
    ptr = _loader.ptr
    _loader.launch(MERGE, "dstorch_splitk_merge", out_p.device, ptr(out_p), ptr(lse_p),
                   ptr(out), ptr(lse), S, P, H, D)
    return (out, lse) if with_lse else out


def _partial(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor, spec: str):
    """One split's (out, lse) from scaled scores ``s [..., T]`` over the
    keys ``mask`` admits and values ``v`` (``einsum(spec, p, v)``)."""
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum(spec, p, v) / safe[..., None]
    lse = torch.where(l > 0, m + torch.log(safe), torch.full_like(m, NEG_INF))
    return out, lse


def _padded_tables(block_tables: torch.Tensor, n_pages: int) -> torch.Tensor:
    """Block tables widened to ``n_pages`` columns with page 0 (finite pool
    bytes whose scores the position mask drops)."""
    pad = n_pages - block_tables.shape[1]
    return torch.nn.functional.pad(block_tables, (0, pad)) if pad > 0 else block_tables


# --------------------------------------------------------------------- #
# the kernel pair and its plain version
# --------------------------------------------------------------------- #

def splitk_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                     block_tables: torch.Tensor, lens: torch.Tensor, n_splits: int,
                     side_k: Optional[torch.Tensor] = None,
                     side_v: Optional[torch.Tensor] = None, j: int = 0,
                     softmax_scale: Optional[float] = None,
                     kv_scales: Optional[torch.Tensor] = None,
                     with_lse: bool = False, window: Optional[int] = None,
                     alibi: bool = False):
    """Split-K decode attention: q [S, H, D] over the first ``lens[s]``
    tokens of each row's pages, cut into ``n_splits`` splits, plus (with
    ``side_k/side_v`` [S, C * Hkv, D]) the side rows ``cc <= j`` as one more
    piece; merged -> [S, H, D] in q's dtype (and the merged lse [S, H] f32
    with ``with_lse``). Pages are bf16, or int8 with ``kv_scales`` [NB, R8,
    128] and then f32 side rows. ``window``: the sliding window (None:
    none) and ``alibi``, over either pool.

    CPU tensors run :func:`splitk_attention_plain`; CUDA tensors launch the
    partials kernel (counted as :func:`kernel_name`, e.g.
    ``paged_splitk/<n_splits>`` or ``paged_splitk_int8_window/<n_splits>``;
    it cuts each sequence's visible range as :func:`piece_bounds` does) and
    the merge kernel or raise."""
    S, H, D = q.shape
    NB, _, Hkv, bs, _ = kv_pages.shape
    MB = block_tables.shape[1]
    n_splits = int(n_splits)
    if n_splits < 1:
        raise ValueError(f"{NAME}: n_splits must be >= 1, got {n_splits}")
    quant = kv_scales is not None
    C = check_paged_inputs(kernel_name(n_splits, window, alibi, quant=quant), q, kv_pages,
                           block_tables, lens, side_k, side_v, j, kv_scales)
    name = kernel_name(n_splits, window, alibi, side=C > 1, quant=quant)
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    sides = () if side_k is None else (side_k, side_v)
    extra = (kv_scales,) if quant else ()
    if _loader.on_cpu(name, q, kv_pages, block_tables, lens, *sides, *extra):
        return splitk_attention_plain(q, kv_pages, block_tables, lens, n_splits,
                                      side_k, side_v, j, scale, kv_scales, with_lse,
                                      window, alibi)
    side_kw = dict(zip(("side_k", "side_v"), sides))
    P = n_splits + (1 if sides else 0)
    out_p = torch.empty((S, P, H, D), dtype=torch.float32, device=q.device)
    lse_p = torch.empty((S, P, H), dtype=torch.float32, device=q.device)
    split_tokens = split_pages(MB, n_splits) * bs
    ptr = _loader.ptr
    slopes = alibi_slopes(H, q.device) if alibi else None
    slope_kw = {"slopes": slopes} if alibi else {}
    if quant:
        _loader.check_cuda(name, q.dtype, f32=("kv_scales", "side_k", "side_v", "slopes"),
                           i8=("kv_pages",), q=q, kv_pages=kv_pages, kv_scales=kv_scales,
                           block_tables=block_tables, lens=lens, **side_kw, **slope_kw)
        _loader.launch(name, "dstorch_paged_splitk_int8", q.device,
                       ptr(q), ptr(kv_pages), ptr(kv_scales), ptr(block_tables), ptr(lens),
                       ptr(side_k), ptr(side_v), ptr(slopes), ptr(out_p), ptr(lse_p), S, H,
                       Hkv, D, bs, MB, kv_scales.shape[1], C, int(j), n_splits,
                       split_tokens, _loader.window_arg(window), scale)
    else:
        _loader.check_cuda(name, q.dtype, f32=("slopes",), q=q, kv_pages=kv_pages,
                           block_tables=block_tables, lens=lens, **side_kw, **slope_kw)
        _loader.launch(name, "dstorch_paged_splitk_bf16", q.device,
                       ptr(q), ptr(kv_pages), ptr(block_tables), ptr(lens), ptr(side_k),
                       ptr(side_v), ptr(slopes), ptr(out_p), ptr(lse_p), S, H, Hkv, D, bs,
                       MB, C, int(j), n_splits, split_tokens, _loader.window_arg(window),
                       scale)
    return splitk_merge(out_p, lse_p, q.dtype, with_lse)


def splitk_attention_plain(q, kv_pages, block_tables, lens, n_splits: int,
                           side_k=None, side_v=None, j: int = 0,
                           softmax_scale: Optional[float] = None,
                           kv_scales: Optional[torch.Tensor] = None,
                           with_lse: bool = False, window: Optional[int] = None,
                           alibi: bool = False):
    """The same function in plain PyTorch: each piece's partial
    (:func:`piece_bounds`) in f32, then :func:`merge_splitk_partials`."""
    S, H, D = q.shape
    _, _, Hkv, bs, _ = kv_pages.shape
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    n_pages = max(1, -(-int(lens.max()) // bs)) if S else 1
    k, v = gather_rows(kv_pages, _padded_tables(block_tables, n_pages), n_pages, kv_scales)
    qg = q.float().view(S, Hkv, G, D)
    lo, hi = piece_bounds(lens, j, window, side_k is not None, n_splits)
    _, c_lo = window_starts(lens, j, window, side_k is not None)
    slope = alibi_slopes(H, q.device).view(1, Hkv, G, 1) if alibi else None
    pos = torch.arange(n_pages * bs, device=q.device)
    s = torch.einsum("shgd,shtd->shgt", qg, k) * scale
    if alibi:
        s = s + slope * pos.float()
    outs, lses = [], []
    for p in range(n_splits):
        mask = ((pos[None] >= lo[:, p:p + 1]) & (pos[None] < hi[:, p:p + 1]))[:, None, None, :]
        o, lse = _partial(s, mask, v, "shgt,shtd->shgd")
        outs.append(o.reshape(S, H, D))
        lses.append(lse.reshape(S, H))
    if side_k is not None:
        C = side_k.shape[1] // Hkv
        sk = side_k.view(S, C, Hkv, D)[:, :j + 1].float().transpose(1, 2)
        sv = side_v.view(S, C, Hkv, D)[:, :j + 1].float().transpose(1, 2)
        s = torch.einsum("shgd,shtd->shgt", qg, sk) * scale
        if alibi:
            s = s + slope * alibi_positions(S, 0, lens, j, True, q.device)[:, None, None]
        side_ok = torch.arange(j + 1, device=q.device) >= c_lo
        o, lse = _partial(s, side_ok.expand(s.shape), sv, "shgt,shtd->shgd")
        outs.append(o.reshape(S, H, D))
        lses.append(lse.reshape(S, H))
    out, lse = merge_splitk_partials(torch.stack(outs, 1), torch.stack(lses, 1))
    out = out.to(q.dtype)
    return (out, lse) if with_lse else out


# --------------------------------------------------------------------- #
# dispatchers
# --------------------------------------------------------------------- #

def paged_decode_attention_splitk(q, kv_pages, block_tables, ctx_lens,
                                  softmax_scale: Optional[float] = None,
                                  with_lse: bool = False,
                                  kv_scales: Optional[torch.Tensor] = None,
                                  n_splits: int = 1, window: Optional[int] = None,
                                  alibi: bool = False):
    """Decode attention at a split count: ``n_splits <= 1`` without lse is
    the base decode kernel; otherwise split-K (the base kernel has no lse
    output, so ``with_lse`` at one split runs the split-K pair at 1)."""
    if n_splits <= 1 and not with_lse:
        return paged_decode_attention(q, kv_pages, block_tables, ctx_lens,
                                      softmax_scale=softmax_scale, kv_scales=kv_scales,
                                      window=window, alibi=alibi)
    return splitk_attention(q, kv_pages, block_tables, ctx_lens, max(1, n_splits),
                            softmax_scale=softmax_scale, kv_scales=kv_scales,
                            with_lse=with_lse, window=window, alibi=alibi)


def paged_sidebuf_attention_splitk(q, kv_pages, block_tables, prefix_lens, side_k,
                                   side_v, j: int,
                                   softmax_scale: Optional[float] = None,
                                   kv_scales: Optional[torch.Tensor] = None,
                                   n_splits: int = 2, window: Optional[int] = None,
                                   alibi: bool = False):
    """Frozen prefix in pages, split ``n_splits`` ways, plus the side rows
    ``cc <= j`` of the slab ``[S, C * Hkv, D]`` as one more piece, merged
    as ``n_splits + 1`` pieces (int8 pools: the slab holds f32
    ``kv_write_dequant`` rows). Under a ``window`` the query sits at
    ``prefix + j``, so the pages' window start moves with ``j``; under
    ALiBi side row ``cc`` sits at ``prefix + cc``."""
    return splitk_attention(q, kv_pages, block_tables, prefix_lens, n_splits,
                            side_k, side_v, j, softmax_scale=softmax_scale,
                            kv_scales=kv_scales, window=window, alibi=alibi)


def paged_decode_attention_splitk_step(q, k_new, v_new, kv_pages, block_tables,
                                       ctx_lens, softmax_scale: Optional[float] = None,
                                       kv_scales: Optional[torch.Tensor] = None,
                                       n_splits: int = 2, window: Optional[int] = None,
                                       alibi: bool = False):
    """Scatter-first decode step: write the current token's K/V ([S, Hkv,
    D], position ``ctx - 1``; int8 pools quantize the rows and their
    scales) into the pages IN PLACE, then split-K decode over the full
    context, so the current token is attended at its pool value."""
    from deepspeed_tpu_torch.inference.v2.attention import write_token_rows
    write_token_rows(kv_pages, k_new, v_new, block_tables, ctx_lens - 1, kv_scales)
    return paged_decode_attention_splitk(q, kv_pages, block_tables, ctx_lens,
                                         softmax_scale=softmax_scale,
                                         kv_scales=kv_scales, n_splits=n_splits,
                                         window=window, alibi=alibi)


def paged_chunk_attention_splitk(q, kv_pages, block_tables, q_starts, ctx_lens,
                                 softmax_scale: Optional[float] = None,
                                 kv_scales: Optional[torch.Tensor] = None,
                                 n_splits: int = 1, window: Optional[int] = None,
                                 alibi: bool = False):
    """Chunk attention at a split count: ``n_splits <= 1`` is the batched
    chunk kernel; higher counts take :func:`paged_chunk_attention_xla`."""
    if n_splits <= 1:
        return paged_chunk_attention_batched(q, kv_pages, block_tables, q_starts,
                                             ctx_lens, softmax_scale=softmax_scale,
                                             kv_scales=kv_scales, window=window,
                                             alibi=alibi)
    return paged_chunk_attention_xla(q, kv_pages, block_tables, q_starts, ctx_lens,
                                     softmax_scale=softmax_scale, kv_scales=kv_scales,
                                     n_splits=n_splits, window=window, alibi=alibi)


def paged_chunk_attention_xla(q, kv_pages, block_tables, q_starts, ctx_lens,
                              softmax_scale: Optional[float] = None,
                              kv_scales: Optional[torch.Tensor] = None,
                              n_splits: int = 1, window: Optional[int] = None,
                              alibi: bool = False):
    """Split-K batched chunk attention in PyTorch ops: q [N, Cs, H, D], slot
    n's row i at position ``q_starts[n] + i`` sees keys ``k_pos <= q_pos``
    with ``k_pos < ctx`` (and ``k_pos > q_pos - window`` under a sliding
    window; ``alibi`` adds ``slope[h] * k_pos``); one partial per split,
    merged -> [N, Cs, H, D]."""
    N, Cs, H, D = q.shape
    _, _, Hkv, bs, _ = kv_pages.shape
    G = H // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    per = split_pages(block_tables.shape[1], n_splits)
    TL = per * bs
    bt = _padded_tables(block_tables, per * n_splits)
    qg = q.float().view(N, Cs, Hkv, G, D)
    q_pos = q_starts.long()[:, None] + torch.arange(Cs, device=q.device)[None]
    slope = alibi_slopes(H, q.device).view(1, 1, Hkv, G, 1) if alibi else None
    outs, lses = [], []
    for p in range(n_splits):
        k, v = gather_rows(kv_pages, bt[:, p * per:(p + 1) * per], per, kv_scales)
        pos = p * TL + torch.arange(TL, device=q.device)
        mask = ((pos[None, None] <= q_pos[:, :, None])
                & (pos[None, None] < ctx_lens.long()[:, None, None]))   # [N, Cs, T]
        if window is not None:
            mask &= pos[None, None] > q_pos[:, :, None] - window
        s = torch.einsum("nchgd,nhtd->nchgt", qg, k) * scale
        if alibi:
            s = s + slope * pos.float()
        o, lse = _partial(s, mask[:, :, None, None], v, "nchgt,nhtd->nchgd")
        outs.append(o.reshape(N * Cs, H, D))
        lses.append(lse.reshape(N * Cs, H))
    out, _ = merge_splitk_partials(torch.stack(outs, 1), torch.stack(lses, 1))
    return out.view(N, Cs, H, D).to(q.dtype)
