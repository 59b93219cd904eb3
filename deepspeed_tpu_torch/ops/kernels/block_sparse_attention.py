"""Block-sparse attention (K9): CUDA kernels ``csrc/block_sparse_fwd.cu`` and
``csrc/block_sparse_bwd.cu``, their host tables, their plain PyTorch
versions, and the autograd function that joins them.

Counterpart of the JAX package's ``ops/pallas/block_sparse_attention.py``
(``_BSA`` :201, ``block_sparse_attention_bhsd`` :352): attention over q, k,
v ``[B, H, S, D]`` restricted to a static ``[Hl, nb, nb]`` block layout (1 =
attend; head h reads layout head ``h % Hl``), optionally causal (top-left:
query i sees key j iff j <= i, as the Pallas kernel). A pair outside the
layout is excluded, so a row that sees no key gets o = 0, lse = -1e30 and
zero gradients.

Host tables (:class:`BlockSparseTables`, built once per layout, shape,
block, causal flag and device and kept in an ``LRUCache(32)``): identical
per-head layouts collapse to one table, as ``_BSA.__init__`` does. The
kernels tile S by 64; for every (layout head, q-tile) a CSR list of the
active k-tiles, each with a 16-bit mask of the layout's own 16 x 16
sub-blocks inside the tile (bit ``(row // 16) * 4 + key // 16``), and the
transposed list for the dk/dv kernel. Under causal the mask keeps only
sub-blocks on or below the diagonal, so the tile table is the tril of the
coarse layout. No ``[bq, bk]`` element masks are stored (the Pallas design's
``_fine_tiles`` :226).

The layout block must be a multiple of 16 and divide S; S itself may be any
such multiple (the kernels mask the last tile's ragged edge).

CPU tensors run the plain versions (dense masked attention in f32, or f64
for f64 input; p and ds rounded to the inputs' type before their products,
as the Pallas kernels cast them); CUDA tensors launch the kernels (bf16,
contiguous; head dims 16, 32, 64 and 128) or raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels import _loader
# K1's working type, kernel input check (head dims, bf16, contiguity) and
# delta apply unchanged
from deepspeed_tpu_torch.ops.kernels.flash_attention import _acc, _check_kernel, flash_delta
from deepspeed_tpu_torch.utils.caching import LRUCache

NEG_INF = -1e30
TILE = 64           # the kernels' q and k tile (kBQ = kBK in attn_common.cuh)
FINE = 16           # granularity of the in-tile bit mask
FWD, DQ, DKV = "block_sparse_fwd", "block_sparse_dq", "block_sparse_dkv"
_PALLAS = "deepspeed_tpu/ops/pallas/block_sparse_attention.py"
# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    FWD: ("deepspeed_tpu_torch/csrc/block_sparse_fwd.cu", f"{_PALLAS}:96"),
    DQ: ("deepspeed_tpu_torch/csrc/block_sparse_bwd.cu", f"{_PALLAS}:132"),
    DKV: ("deepspeed_tpu_torch/csrc/block_sparse_bwd.cu", f"{_PALLAS}:161"),
}


# --------------------------------------------------------------------------- #
# host tables
# --------------------------------------------------------------------------- #

def _tile_bits(layout: np.ndarray, block: int, causal: bool, seq_len: int) -> np.ndarray:
    """``[Hl, nt, nt]`` int64: for each (q-tile, k-tile) of 64 tokens the
    16-bit mask of its active 16 x 16 sub-blocks (0 = tile inactive)."""
    Hl, nb, _ = layout.shape
    rep = block // FINE
    fine = layout.astype(bool).repeat(rep, axis=1).repeat(rep, axis=2)
    n16 = seq_len // FINE
    if causal:
        fine &= np.tril(np.ones((n16, n16), bool))
    per = TILE // FINE
    nt = -(-seq_len // TILE)
    pad = nt * per - n16
    fine = np.pad(fine, ((0, 0), (0, pad), (0, pad)))
    sub = fine.reshape(Hl, nt, per, nt, per).transpose(0, 1, 3, 2, 4)
    sub = sub.reshape(Hl, nt, nt, per * per).astype(np.int64)
    return (sub << np.arange(per * per, dtype=np.int64)).sum(-1)


def _csr(bits: np.ndarray):
    """(ptr [Hl, n + 1], ent [nnz, 2]) int32 over the nonzero entries of
    ``bits [Hl, n, m]`` in row order; ``ptr`` indexes ``ent`` across heads,
    ``ent`` holds (column, bits). ``ent`` keeps one zero row when empty."""
    Hl, n, _ = bits.shape
    h, i, j = np.nonzero(bits)
    counts = (bits != 0).sum(-1).reshape(-1)
    flat = np.concatenate([[0], np.cumsum(counts)])
    ptr = np.stack([flat[x * n:x * n + n + 1] for x in range(Hl)]).astype(np.int32)
    ent = np.stack([j, bits[h, i, j]], axis=1).astype(np.int32)
    if not len(ent):
        ent = np.zeros((1, 2), np.int32)
    return ptr, ent


class BlockSparseTables:
    """The kernels' tables for one layout (collapsed to one head when all
    heads agree), layout block, causal flag and sequence length, on one
    device: ``row_ptr``/``row_ent`` per q-tile for the forward and dq
    kernels, ``col_ptr``/``col_ent`` per k-tile for the dk/dv kernel."""

    def __init__(self, layout: np.ndarray, block: int, causal: bool, seq_len: int,
                 device: torch.device):
        if layout.shape[0] > 1 and (layout == layout[0:1]).all():
            layout = layout[0:1]
        self.layout, self.block, self.causal, self.seq_len = layout, block, causal, seq_len
        self.num_layout_heads = layout.shape[0]
        self.num_tiles = -(-seq_len // TILE)
        bits = _tile_bits(layout, block, causal, seq_len)
        self.active_tiles = int((bits != 0).sum())
        as_t = lambda a: torch.from_numpy(a).to(device)
        self.row_ptr, self.row_ent = map(as_t, _csr(bits))
        self.col_ptr, self.col_ent = map(as_t, _csr(np.ascontiguousarray(
            bits.transpose(0, 2, 1))))

    def token_mask(self, device) -> torch.Tensor:
        """``[Hl, S, S]`` bool: which (query, key) pairs each layout head
        sees (the layout's blocks, and j <= i under causal)."""
        m = torch.from_numpy(self.layout.astype(bool)).to(device)
        m = m.repeat_interleave(self.block, 1).repeat_interleave(self.block, 2)
        if self.causal:
            m = m & torch.ones(self.seq_len, self.seq_len, dtype=torch.bool,
                               device=device).tril()
        return m


_CACHE: LRUCache = LRUCache(maxsize=32)


def get_tables(layout: np.ndarray, block: int, causal: bool, seq_len: int,
               device) -> BlockSparseTables:
    """The cached :class:`BlockSparseTables` of ``layout`` ([Hl, nb, nb] or
    [nb, nb], nonzero = attend) at ``seq_len`` tokens on ``device``."""
    layout = np.ascontiguousarray(np.asarray(layout).astype(np.uint8))
    if layout.ndim == 2:
        layout = layout[None]
    if block % FINE or block <= 0:
        raise ValueError(f"block-sparse attention: layout block {block} must be a "
                         f"multiple of {FINE}")
    if layout.shape[1:] != (seq_len // block,) * 2 or seq_len % block:
        raise ValueError(f"block-sparse attention: layout {layout.shape} does not "
                         f"tile S={seq_len} in blocks of {block}")
    device = torch.device(device)
    key = (layout.tobytes(), layout.shape, block, bool(causal), seq_len, TILE, str(device))
    return _CACHE.get_or_create(
        key, lambda: BlockSparseTables(layout, block, bool(causal), seq_len, device))


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def _in_type(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to ``like``'s type and back (the Pallas kernels' casts
    of p and ds before their products; no-op for f32 and f64 input)."""
    return t.to(like.dtype).to(t.dtype)


def _masked_scores(q, k, tables: BlockSparseTables, scale: float):
    """Scores [B, H, S, S] in the working type with excluded pairs at
    -1e30, and the mask (broadcast over B; head h reads layout head h % Hl)."""
    H, Hl = q.shape[1], tables.num_layout_heads
    mask = tables.token_mask(q.device)
    if Hl not in (1, H):
        mask = mask[torch.arange(H, device=q.device) % Hl]
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) * scale
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def block_sparse_fwd_plain(q, k, v, tables: BlockSparseTables, scale: float):
    """(o [B, H, S, D] in q's dtype, lse [B, H, S] f32 or f64) in plain
    PyTorch."""
    s, mask = _masked_scores(q, k, tables, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bhkd->bhqd", _in_type(p, v), _acc(v)) / safe_l
    lse = torch.where(l > 0, m + torch.log(safe_l), torch.full_like(l, NEG_INF))
    return o.to(q.dtype), lse[..., 0]


def _probs(q, k, lse, tables, scale):
    s, mask = _masked_scores(q, k, tables, scale)
    return torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))


def block_sparse_dq_plain(q, k, v, do, lse, delta, tables: BlockSparseTables,
                          scale: float):
    p = _probs(q, k, lse, tables, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", _acc(do), _acc(v))
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bhqk,bhkd->bhqd", _in_type(ds, k), _acc(k)).to(q.dtype)


def block_sparse_dkv_plain(q, k, v, do, lse, delta, tables: BlockSparseTables,
                           scale: float):
    p = _probs(q, k, lse, tables, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", _in_type(p, do), _acc(do))
    dp = torch.einsum("bhqd,bhkd->bhqk", _acc(do), _acc(v))
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", _in_type(ds, q), _acc(q))
    return dk.to(k.dtype), dv.to(v.dtype)


def block_sparse_delta(o, do):
    """rowsum(dO * O) [B, H, S] in f32 (f64 for f64 input): K1's
    ``flash_delta`` on the [B, S, H, D] views."""
    return flash_delta(o.transpose(1, 2), do.transpose(1, 2))


def block_sparse_bwd_plain(q, k, v, o, lse, do, tables: BlockSparseTables,
                           scale: float):
    """(dq, dk, dv) in plain PyTorch."""
    delta = block_sparse_delta(o, do)
    dq = block_sparse_dq_plain(q, k, v, do, lse, delta, tables, scale)
    dk, dv = block_sparse_dkv_plain(q, k, v, do, lse, delta, tables, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #

def _check_shapes(name, tables: BlockSparseTables, q, *rest) -> None:
    if q.dim() != 4 or any(t.shape != q.shape for t in rest) \
            or q.shape[2] != tables.seq_len:
        raise ValueError(f"{name}: q, k, v (and dO) must be [B, H, S={tables.seq_len}, D] "
                         f"alike, got {[tuple(t.shape) for t in (q, *rest)]}")


def block_sparse_fwd(q, k, v, tables: BlockSparseTables, scale: float):
    """(o [B, H, S, D] in q's dtype, lse [B, H, S] f32)."""
    _check_shapes(FWD, tables, q, k, v)
    if _loader.on_cpu(FWD, q, k, v, tables.row_ptr):
        return block_sparse_fwd_plain(q, k, v, tables, scale)
    _check_kernel(FWD, q, k=k, v=v, row_ptr=tables.row_ptr, ent=tables.row_ent)
    B, H, S, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    P = _loader.ptr
    _loader.launch(FWD, "dstorch_block_sparse_fwd_bf16", q.device, P(q), P(k), P(v), P(o),
                   P(lse), P(tables.row_ptr), P(tables.row_ent), B, H, S, D,
                   tables.num_layout_heads, scale, int(tables.causal))
    return o, lse


def block_sparse_dq(q, k, v, do, lse, delta, tables: BlockSparseTables, scale: float):
    """dq [B, H, S, D] in q's dtype."""
    _check_shapes(DQ, tables, q, k, v, do)
    if _loader.on_cpu(DQ, q, k, v, do, lse, delta, tables.row_ptr):
        return block_sparse_dq_plain(q, k, v, do, lse, delta, tables, scale)
    _check_kernel(DQ, q, k=k, v=v, do=do, lse=lse, delta=delta, row_ptr=tables.row_ptr,
                  ent=tables.row_ent)
    B, H, S, D = q.shape
    dq = torch.empty_like(q)
    P = _loader.ptr
    _loader.launch(DQ, "dstorch_block_sparse_dq_bf16", q.device, P(q), P(k), P(v), P(do),
                   P(lse), P(delta), P(dq), P(tables.row_ptr), P(tables.row_ent), B, H, S,
                   D, tables.num_layout_heads, scale, int(tables.causal))
    return dq


def block_sparse_dkv(q, k, v, do, lse, delta, tables: BlockSparseTables, scale: float):
    """(dk, dv) [B, H, S, D] in k's dtype."""
    _check_shapes(DKV, tables, q, k, v, do)
    if _loader.on_cpu(DKV, q, k, v, do, lse, delta, tables.col_ptr):
        return block_sparse_dkv_plain(q, k, v, do, lse, delta, tables, scale)
    _check_kernel(DKV, q, k=k, v=v, do=do, lse=lse, delta=delta, col_ptr=tables.col_ptr,
                  col_ent=tables.col_ent)
    B, H, S, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    P = _loader.ptr
    _loader.launch(DKV, "dstorch_block_sparse_dkv_bf16", q.device, P(q), P(k), P(v),
                   P(do), P(lse), P(delta), P(dk), P(dv), P(tables.col_ptr),
                   P(tables.col_ent), B, H, S, D, tables.num_layout_heads, scale,
                   int(tables.causal))
    return dk, dv


def block_sparse_bwd(q, k, v, o, lse, do, tables: BlockSparseTables, scale: float):
    """(dq, dk, dv): delta in plain torch, then the dq and dk/dv kernels
    (their plain versions for CPU tensors)."""
    delta = block_sparse_delta(o, do)
    dq = block_sparse_dq(q, k, v, do, lse, delta, tables, scale)
    dk, dv = block_sparse_dkv(q, k, v, do, lse, delta, tables, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# public entry
# --------------------------------------------------------------------------- #

class BlockSparseAttention(torch.autograd.Function):
    """o = attention(q, k, v) under ``tables``; the backward launches the
    dq and dk/dv kernels on the saved (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, tables: BlockSparseTables, scale: float):
        o, lse = block_sparse_fwd(q, k, v, tables, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.scale = tables, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_bwd(q, k, v, o, lse, do.contiguous(), ctx.tables,
                                      ctx.scale)
        return dq, dk, dv, None, None


def block_sparse_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                layout: np.ndarray, block: int, causal: bool = False,
                                softmax_scale: Optional[float] = None,
                                block_mult: int = 8) -> torch.Tensor:
    """Block-sparse attention over [B, H, S, D] tensors, differentiable in
    q, k, v. ``layout`` [H, nb, nb] or [nb, nb] (nonzero = attend) in blocks
    of ``block`` tokens. The scale is ``1/sqrt(D)`` unless ``softmax_scale``
    is given. ``block_mult`` chose the TPU kernel's tiling; it is accepted
    and changes nothing here (the CUDA kernels tile by 64)."""
    D = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D ** 0.5)
    tables = get_tables(layout, block, causal, q.shape[2], q.device)
    return BlockSparseAttention.apply(q, k, v, tables, scale)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           layout: np.ndarray, block: int, causal: bool = False,
                           softmax_scale: Optional[float] = None,
                           block_mult: int = 8) -> torch.Tensor:
    """[B, T, H, D] form of :func:`block_sparse_attention_bhsd` (the
    heads-second copies are made here)."""
    bhsd = lambda t: t.transpose(1, 2).contiguous()
    out = block_sparse_attention_bhsd(bhsd(q), bhsd(k), bhsd(v), layout, block,
                                      causal=causal, softmax_scale=softmax_scale,
                                      block_mult=block_mult)
    return out.transpose(1, 2)
