"""One attention-kernel interface for the v2 serving stack.

``AttentionKernelSpec`` is the single dispatch surface every pass forward in
``ragged_model.py`` routes its attention through, as in the JAX package:

  - ``packed`` -> the packed prefill kernel (``ops/kernels/flash_packed``);
  - ``chunk`` -> the paged chunk kernel (``ops/kernels/paged_chunk``);
  - ``decode`` -> the paged decode kernel with pages only;
  - ``sidebuf`` / ``decode_step`` -> the same decode kernel with side rows.

:meth:`AttentionKernelSpec.validate_engine_build` is the build-time
capability table: it refuses, by name, every model feature the port's
kernels do not carry yet.
"""

from __future__ import annotations

from typing import Any

import torch

from deepspeed_tpu_torch.ops.kernels import (flash_attention_packed,
                                             paged_chunk_attention_batched,
                                             paged_decode_attention)


class AttentionKernelSpec:
    """Kernel dispatch for one model spec. Every method takes one layer's
    pool view ``kv_l`` [NB, 2, Hkv, bs, D]."""

    def __init__(self, spec: Any):
        self.spec = spec

    @staticmethod
    def validate_engine_build(spec: Any, cfg: Any) -> None:
        """Raise ``NotImplementedError`` for every model feature the slice
        lacks (engine-config features are refused by the config itself)."""
        off = []
        if spec.window is not None:
            off.append("a sliding window")
        if spec.alibi:
            off.append("ALiBi")
        if spec.moe is not None:
            off.append("MoE")
        if cfg.tensor_parallel > 1:
            off.append("tensor_parallel > 1")
        if off:
            raise NotImplementedError(
                f"{', '.join(off)}: not ported to deepspeed_tpu_torch yet")

    def packed(self, q, k, v, seg):
        """Packed segment-masked prefill attention over the pass's own rows
        (no paged reads)."""
        return flash_attention_packed(q, k, v, seg)

    def chunk(self, q, kv_l, block_tables, q_starts, ctx_lens):
        """Batched prompt-chunk attention: one slot per chunk, causal by
        absolute position."""
        return paged_chunk_attention_batched(q, kv_l, block_tables, q_starts,
                                             ctx_lens)

    def decode(self, q, kv_l, block_tables, ctx_lens):
        """One query per sequence over the ``ctx_lens`` tokens in its
        pages."""
        return paged_decode_attention(q, kv_l, block_tables, ctx_lens)

    def sidebuf(self, q, kv_l, block_tables, prefix_lens, side_k, side_v, j):
        """Frozen prefix in pages plus side rows ``cc <= j`` of the slab
        ``[S, C * Hkv, D]``."""
        return paged_decode_attention(q, kv_l, block_tables, prefix_lens,
                                      side_k, side_v, j)

    def decode_step(self, q, k_new, v_new, kv_l, block_tables, ctx_lens):
        """Decode step: attend pages ``[0, ctx - 1)`` plus the current token
        as one side row, then write the current token's K/V into its page at
        position ``ctx - 1`` (in place). Every row needs ``ctx >= 1`` (the
        decode batch pads with ctx 1 rows on the scratch page)."""
        out = self.sidebuf(q, kv_l, block_tables, ctx_lens - 1, k_new, v_new, 0)
        write_token_rows(kv_l, k_new, v_new, block_tables, ctx_lens - 1)
        return out


def write_token_rows(kv_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block_tables: torch.Tensor, pos: torch.Tensor) -> None:
    """Write each row's K/V [S, Hkv, D] at position ``pos`` [S] (>= 0) of its
    sequence, through its block table, into the pool view ``kv_l``."""
    NB, _, Hkv, bs, D = kv_l.shape
    pos = pos.long()
    page = block_tables.long().gather(1, (pos // bs)[:, None])[:, 0]
    base = page * (2 * Hkv * bs) + pos % bs                       # [S]
    h = torch.arange(Hkv, device=kv_l.device) * bs
    rows = torch.cat([(base[:, None] + h).reshape(-1),
                      (base[:, None] + Hkv * bs + h).reshape(-1)])
    new = torch.cat([k.reshape(-1, D), v.reshape(-1, D)]).to(kv_l.dtype)
    kv_l.view(-1, D).index_copy_(0, rows, new)
