"""One attention-kernel interface for the v2 serving stack.

``AttentionKernelSpec`` is the single dispatch surface every pass forward in
``ragged_model.py`` routes its attention through, as in the JAX package:

  - ``packed`` -> the packed prefill kernel (``ops/kernels/flash_packed``);
  - ``chunk`` -> the paged chunk kernel (``ops/kernels/paged_chunk``);
  - ``decode`` -> the paged decode kernel with pages only;
  - ``sidebuf`` / ``decode_step`` -> the same decode kernel with side rows.

Four things key the kernel at the call or at construction:

  - the pool: every paged method takes ``kv_scales`` (None for a bf16/f32
    pool; the scale tiles ``[NB, R8, 128]`` of an int8 pool, which routes to
    the kernel's int8 variant);
  - the split rung ``n_splits`` (bound once, one spec per rung): above 1,
    decode and side-buffer attention run the split-K kernel (K7,
    ``ops/kernels/paged_splitk``); chunk attention runs the chunk kernel at
    every rung (JAX runs its split path there, so that verify streams keep
    the decode rung's compiled program; eager torch has none to keep, and
    the chunk kernel beats the split path at rungs 2, 4 and 8 on the H100:
    ``scripts/k5_timing.py``);
  - the model's sliding window ``spec.window`` (bound once, as in the JAX
    package): every kernel masks keys more than ``window - 1`` positions
    behind its query and skips the pages below the window start, over
    bf16 and int8 pools alike;
  - the model's ALiBi flag ``spec.alibi`` (bound once, as in the JAX
    package): every paged kernel adds ``slope[h] * k_pos`` to its scores,
    over either pool.
    The packed prefill kernel has no position bias, so an ALiBi model never
    calls :meth:`packed`.

int8 write semantics: every path attends a token at the value its int8
page stores. The ragged pass writes then attends; the decode step attends
the current token from a side row and writes it after, so its caller hands
it the ``kv_write_dequant`` rows (f32), whose re-quantization stores the
same page bytes.

:meth:`AttentionKernelSpec.validate_engine_build` is the build-time
capability table: it holds the int8 pool's alignment gate and the JAX
package's refusals in its words, and refuses, by name, every model
feature the port's kernels do not carry yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from deepspeed_tpu_torch.ops.kernels import (flash_attention_packed,
                                             paged_chunk_attention_batched,
                                             paged_decode_attention)
from deepspeed_tpu_torch.ops.kernels.kv_quant import (kv_quantize_rows,
                                                      scale_write_index)
from deepspeed_tpu_torch.ops.kernels.paged_splitk import (
    paged_decode_attention_splitk, paged_decode_attention_splitk_step,
    paged_sidebuf_attention_splitk)


class AttentionKernelSpec:
    """Kernel dispatch for one model spec at one split rung. Every paged
    method takes one layer's pool view ``kv_l`` [NB, 2, Hkv, bs, D] and, for
    an int8 pool, that layer's scale tiles ``kv_scales`` [NB, R8, 128]."""

    def __init__(self, spec: Any, n_splits: int = 1):
        self.spec = spec
        self.n_splits = int(n_splits)
        self.window = None if spec is None else spec.window
        self.alibi = False if spec is None else bool(spec.alibi)

    @staticmethod
    def validate_engine_build(spec: Any, cfg: Any) -> None:
        """The build-time capability table, in the JAX package's order and
        words (its ``validate_engine_build``, then its engine's ALiBi
        refusal): int8 KV pages with ``tensor_parallel > 1`` and the int8
        pool's alignment gate (``ValueError``), then ALiBi with
        ``tensor_parallel > 1``. What is absent composes: int8 pages under a
        sliding window and under ALiBi. Then MoE with packed int4 weights
        (``NotImplementedError``: the grouped expert products take int8 or
        model-dtype stacks). Last, ``NotImplementedError`` names every
        feature the port lacks (``tensor_parallel > 1``, MoE under it;
        engine-config features are refused by the config itself)."""
        if cfg.kv_quant.enabled:
            if cfg.tensor_parallel > 1:
                raise NotImplementedError("kv_quant with tensor_parallel > 1 is not wired")
            if (spec.head_dim % 128 != 0
                    or (spec.num_kv_heads * cfg.kv_cache.block_size) % 128 != 0):
                raise ValueError(
                    "kv_quant needs head_dim % 128 == 0 and "
                    "num_kv_heads * block_size % 128 == 0 (the kernels' "
                    "scale-tile lane alignment; got head_dim="
                    f"{spec.head_dim}, num_kv_heads={spec.num_kv_heads}, "
                    f"block_size={cfg.kv_cache.block_size})")
        if spec.alibi and cfg.tensor_parallel > 1:
            # the JAX package's refusal (engine_v2.py:216-226)
            raise NotImplementedError(
                "ALiBi models with tensor_parallel > 1 are not wired in the "
                "ragged engine (shard-local slope schedules would be wrong); "
                "run tp=1 or serve through init_inference")
        if spec.moe is not None and cfg.quantization.weight_bits == 4:
            # the JAX engine packs the expert stacks to int4 and then fails
            # in its _moe_ffn, whose grouped product reads only int8 stacks
            raise NotImplementedError(
                "MoE with quantization.weight_bits = 4: the grouped expert "
                "products take int8 or model-dtype stacks; use weight_bits 8")
        off = []
        if spec.moe is not None and cfg.tensor_parallel > 1:
            off.append("MoE with tensor_parallel > 1")
        if cfg.tensor_parallel > 1:
            off.append("tensor_parallel > 1")
        if off:
            raise NotImplementedError(
                f"{', '.join(off)}: not ported to deepspeed_tpu_torch yet")

    def packed(self, q, k, v, seg):
        """Packed segment-masked prefill attention over the pass's own rows
        (no paged reads)."""
        return flash_attention_packed(q, k, v, seg, window=self.window)

    def chunk(self, q, kv_l, block_tables, q_starts, ctx_lens,
              kv_scales: Optional[torch.Tensor] = None):
        """Batched prompt-chunk attention: one slot per chunk, causal by
        absolute position, through the chunk kernel at every rung."""
        return paged_chunk_attention_batched(q, kv_l, block_tables, q_starts,
                                             ctx_lens, kv_scales=kv_scales,
                                             window=self.window, alibi=self.alibi)

    def decode(self, q, kv_l, block_tables, ctx_lens,
               kv_scales: Optional[torch.Tensor] = None):
        """One query per sequence over the ``ctx_lens`` tokens in its
        pages."""
        if self.n_splits > 1:
            return paged_decode_attention_splitk(q, kv_l, block_tables, ctx_lens,
                                                 kv_scales=kv_scales,
                                                 n_splits=self.n_splits,
                                                 window=self.window, alibi=self.alibi)
        return paged_decode_attention(q, kv_l, block_tables, ctx_lens,
                                      kv_scales=kv_scales, window=self.window,
                                      alibi=self.alibi)

    def sidebuf(self, q, kv_l, block_tables, prefix_lens, side_k, side_v, j,
                kv_scales: Optional[torch.Tensor] = None):
        """Frozen prefix in pages plus side rows ``cc <= j`` of the slab
        ``[S, C * Hkv, D]`` (f32 ``kv_write_dequant`` rows for an int8
        pool)."""
        if self.n_splits > 1:
            return paged_sidebuf_attention_splitk(
                q, kv_l, block_tables, prefix_lens, side_k, side_v, j,
                kv_scales=kv_scales, n_splits=self.n_splits, window=self.window,
                alibi=self.alibi)
        return paged_decode_attention(q, kv_l, block_tables, prefix_lens,
                                      side_k, side_v, j, kv_scales=kv_scales,
                                      window=self.window, alibi=self.alibi)

    def decode_step(self, q, k_new, v_new, kv_l, block_tables, ctx_lens,
                    kv_scales: Optional[torch.Tensor] = None):
        """Decode step: attend pages ``[0, ctx - 1)`` plus the current token
        as one side row, then write the current token's K/V into its page at
        position ``ctx - 1`` (in place). Every row needs ``ctx >= 1`` (the
        decode batch pads with ctx 1 rows on the scratch page). For an int8
        pool, ``k_new``/``v_new`` are the ``kv_write_dequant`` rows."""
        out = self.sidebuf(q, kv_l, block_tables, ctx_lens - 1, k_new, v_new, 0,
                           kv_scales=kv_scales)
        write_token_rows(kv_l, k_new, v_new, block_tables, ctx_lens - 1, kv_scales)
        return out

    def decode_step_write(self, q, k_new, v_new, kv_l, block_tables, ctx_lens,
                          kv_scales: Optional[torch.Tensor] = None):
        """The per-step write path (K4's order, ``paged_decode_attention_step``
        and its split-K dispatcher): write the current token's K/V at
        position ``ctx - 1`` first, then attend pages ``[0, ctx)``. A
        windowed decode step takes it when the scheduler's page ring does
        not cover the side-buffer schedule (``ring_covers``)."""
        if self.n_splits > 1:
            return paged_decode_attention_splitk_step(
                q, k_new, v_new, kv_l, block_tables, ctx_lens, kv_scales=kv_scales,
                n_splits=self.n_splits, window=self.window, alibi=self.alibi)
        write_token_rows(kv_l, k_new, v_new, block_tables, ctx_lens - 1, kv_scales)
        return self.decode(q, kv_l, block_tables, ctx_lens, kv_scales=kv_scales)


def token_write_rows(block_tables: torch.Tensor, pos: torch.Tensor, Hkv: int,
                     bs: int) -> torch.Tensor:
    """Flat rows of one layer's pool view ``[NB * 2 * Hkv * bs, D]`` for the
    tokens at positions ``pos`` ([S] or [S, C], >= 0) of each row's
    sequence, through its block table: all K rows, then all V rows, each in
    (row, position, kv head) order."""
    S = block_tables.shape[0]
    pos = pos.long().reshape(S, -1)
    page = block_tables.long().gather(1, pos // bs)                # [S, C]
    base = (page * (2 * Hkv * bs) + pos % bs).reshape(-1)
    h = torch.arange(Hkv, device=block_tables.device) * bs
    return torch.cat([(base[:, None] + h).reshape(-1),
                      (base[:, None] + Hkv * bs + h).reshape(-1)])


def write_rows(kv_l: torch.Tensor, rows: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_scales: Optional[torch.Tensor] = None) -> None:
    """Write K/V rows (any shape ending in D, in :func:`token_write_rows`'
    order) at pool rows ``rows`` of the pool view ``kv_l``; an int8 pool
    (``kv_scales``) stores them quantized and their scales."""
    _, _, Hkv, bs, D = kv_l.shape
    new = torch.cat([k.reshape(-1, D), v.reshape(-1, D)])
    if kv_scales is None:
        kv_l.view(-1, D).index_copy_(0, rows, new.to(kv_l.dtype))
        return
    q8, s = kv_quantize_rows(new)
    kv_l.view(-1, D).index_copy_(0, rows, q8)
    kv_scales.view(-1).index_copy_(0, scale_write_index(rows, Hkv, bs), s)


def write_token_rows(kv_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block_tables: torch.Tensor, pos: torch.Tensor,
                     kv_scales: Optional[torch.Tensor] = None) -> None:
    """Write each row's K/V [S, Hkv, D] at position ``pos`` [S] (>= 0) of its
    sequence, through its block table, into the pool view ``kv_l``; an int8
    pool (``kv_scales``) stores the rows quantized and their scales."""
    _, _, Hkv, bs, _ = kv_l.shape
    write_rows(kv_l, token_write_rows(block_tables, pos, Hkv, bs), k, v, kv_scales)
