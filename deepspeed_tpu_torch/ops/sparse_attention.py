"""Block-sparse self-attention: sparsity configs and the op's entry point.

Counterpart of the JAX package's ``ops/sparse_attention.py`` (parity:
DeepSpeed's ``deepspeed/ops/sparse_attention/`` ``sparsity_config.py`` and
``SparseSelfAttention``). The five layout builders (Dense, Fixed, Variable,
BigBird, BSLongformer), :func:`layout_to_mask` and :func:`sparsity_ratio`
are copies of the JAX package's numpy code: the same config and seed give a
byte-equal ``[H, nb, nb]`` layout (BigBird and Variable draw their random
blocks from ``np.random.default_rng(seed)``).

:func:`sparse_self_attention` takes torch tensors ``[B, H, S, D]`` and
builds its layout and K9's tables once per config and S
(:func:`cached_layout`). With no mask it runs block-sparse attention (K9, ``ops.kernels.block_sparse_attention``:
the CUDA kernels for CUDA tensors, their plain versions for CPU tensors);
with a ``key_padding_mask`` or an ``attn_mask`` it takes the dense
additive-mask route in plain torch on either device, as the JAX package
computes it outside Pallas on every backend.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import (
    BlockSparseAttention, get_tables)
from deepspeed_tpu_torch.utils.caching import LRUCache


class SparsityConfig:
    """Parity: ``SparsityConfig`` (sparsity_config.py:10)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False, seed: int = 0):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1
        self.seed = seed
        self.attention = "bidirectional"  # subclasses may override

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} must be divisible by block "
                             f"{self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """Parity: sparsity_config.py:63 — all blocks active (testing/fallback)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Parity: ``FixedSparsityConfig`` (sparsity_config.py:95): local windows of
    ``num_local_blocks`` + each window's last ``num_global_blocks`` columns
    attended globally; optional horizontal global rows."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1, seed=0):
        super().__init__(num_heads, block, different_layout_per_head, seed)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be divisible by num_global_blocks")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError("attention must be uni/bidirectional")
        self.attention = attention
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "num_different_global_patterns > 1 requires "
                "different_layout_per_head (parity: sparsity_config.py)")
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        L = self.num_local_blocks
        G = self.num_global_blocks
        for h in range(self.num_layout_heads):
            # local windows (set_local_layout :153)
            for start in range(0, nb, L):
                end = min(start + L, nb)
                for i in range(start, end):
                    hi = (i + 1) if self.attention == "unidirectional" else end
                    layout[h, i, start:hi] = 1
            # global columns (set_global_layout :172): last G block-columns of
            # each window, rotated per head for different patterns
            pat = h % self.num_different_global_patterns
            first = max(0, L - (pat + 1) * G)
            for start in range(0, nb, L):
                gcols = range(start + first, min(start + first + G, nb))
                for c in gcols:
                    if self.attention == "unidirectional":
                        layout[h, c:, c] = 1
                    else:
                        layout[h, :, c] = 1
                        if self.horizontal_global_attention:
                            layout[h, c, :] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Parity: sparsity_config.py:239 — variable local window sizes, explicit
    global block index ranges, optional random blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head, seed)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError("attention must be uni/bidirectional")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_layout_heads):
            # variable local windows (:325): cycle the window-size list
            start = 0
            w = 0
            while start < nb:
                size = self.local_window_blocks[min(w, len(self.local_window_blocks) - 1)]
                end = min(start + size, nb)
                for i in range(start, end):
                    hi = (i + 1) if self.attention == "unidirectional" else end
                    layout[h, i, start:hi] = 1
                start = end
                w += 1
            # global blocks (:354)
            if self.global_block_end_indices is None:
                ranges = [(i, i + 1) for i in self.global_block_indices]
            else:
                ranges = list(zip(self.global_block_indices,
                                  self.global_block_end_indices))
            for lo, hi in ranges:
                lo, hi = max(0, lo), min(nb, hi)
                for c in range(lo, hi):
                    if self.attention == "unidirectional":
                        layout[h, c:, c] = 1
                    else:
                        layout[h, :, c] = 1
                        if self.horizontal_global_attention:
                            layout[h, c, :] = 1
            # random blocks (:303)
            for i in range(nb):
                hi = (i + 1) if self.attention == "unidirectional" else nb
                if hi <= 0 or self.num_random_blocks == 0:
                    continue
                cols = rng.choice(hi, size=min(self.num_random_blocks, hi),
                                  replace=False)
                layout[h, i, cols] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """Parity: sparsity_config.py:411 — sliding window + global + random."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head, seed)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError("attention must be uni/bidirectional")
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = np.random.default_rng(self.seed)
        w = self.num_sliding_window_blocks // 2
        G = self.num_global_blocks
        for h in range(self.num_layout_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = 1  # sliding
            layout[h, :, :G] = 1   # global columns (first blocks)
            layout[h, :G, :] = 1   # global rows
            for i in range(nb):
                hi = (i + 1) if self.attention == "unidirectional" else nb
                if self.num_random_blocks and hi > 0:
                    cols = rng.choice(hi, size=min(self.num_random_blocks, hi),
                                      replace=False)
                    layout[h, i, cols] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Parity: sparsity_config.py:508 — sliding window + designated global
    block indices (block-sparse Longformer)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head, seed)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = 1
            if self.global_block_end_indices is None:
                ranges = [(i, i + 1) for i in self.global_block_indices]
            else:
                ranges = list(zip(self.global_block_indices,
                                  self.global_block_end_indices))
            for lo, hi in ranges:
                lo, hi = max(0, lo), min(nb, hi)
                layout[h, :, lo:hi] = 1
                layout[h, lo:hi, :] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


_LAYOUTS: LRUCache = LRUCache(maxsize=32)
_TABLES: LRUCache = LRUCache(maxsize=32)


def _layout_key(config: SparsityConfig, seq_len: int) -> tuple:
    """The config's class and fields (``seed`` and ``block`` among them)
    and S."""
    return (type(config).__qualname__, repr(sorted(vars(config).items())), int(seq_len))


def cached_layout(config: SparsityConfig, seq_len: int) -> np.ndarray:
    """``config.make_layout(seq_len)``, built once per (the config's class
    and fields, ``seed`` and ``block`` among them; ``seq_len``) and kept
    read-only in an ``LRUCache(32)``. The builders are deterministic in
    those (the random blocks come from ``default_rng(seed)``), so a cached
    layout is the one a fresh call would build; the JAX op builds it once
    per trace for the same reason."""

    def build():
        layout = config.make_layout(seq_len)
        layout.setflags(write=False)
        return layout

    return _LAYOUTS.get_or_create(_layout_key(config, seq_len), build)


def _cached_tables(config: SparsityConfig, seq_len: int, causal: bool, device):
    """K9's tables of the cached layout, looked up by the same key (what
    ``get_tables`` keys by, the layout's bytes, costs milliseconds to hash
    at S = 4096)."""
    key = (_layout_key(config, seq_len), bool(causal), str(torch.device(device)))
    return _TABLES.get_or_create(key, lambda: get_tables(
        cached_layout(config, seq_len), config.block, causal, seq_len, device))


def layout_to_mask(layout: np.ndarray, block: int) -> np.ndarray:
    """[H, nb, nb] block layout -> [H, S, S] additive fp32 mask (0 / -inf)."""
    token = np.kron(layout, np.ones((block, block), layout.dtype))
    return np.where(token > 0, 0.0, -1e9).astype(np.float32)


def sparse_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sparsity_config: SparsityConfig,
                          key_padding_mask: Optional[torch.Tensor] = None,
                          attn_mask: Optional[torch.Tensor] = None,
                          causal_within_block: bool = True) -> torch.Tensor:
    """Block-sparse attention (parity: ``SparseSelfAttention.forward``).

    q/k/v: [B, H, S, D]. The block layout comes from ``sparsity_config``;
    unidirectional configs additionally mask token-level causality inside the
    diagonal blocks (``causal_within_block``). ``key_padding_mask`` [B, S]
    (> 0 = keep) and ``attn_mask`` (additive, broadcast to [B, H, S, S])
    select the dense route.
    """
    B, H, S, D = q.shape
    if key_padding_mask is None and attn_mask is None:
        causal = (sparsity_config.attention == "unidirectional"
                  and causal_within_block)
        tables = _cached_tables(sparsity_config, S, causal, q.device)
        return BlockSparseAttention.apply(q, k, v, tables, 1.0 / (D ** 0.5))

    mask = layout_to_mask(cached_layout(sparsity_config, S), sparsity_config.block)
    if sparsity_config.attention == "unidirectional" and causal_within_block:
        causal = np.triu(np.full((S, S), -1e9, np.float32), k=1)
        mask = mask + causal[None]
    bias = torch.from_numpy(mask).to(q.device)[None]  # [1, H, S, S]
    if key_padding_mask is not None:
        bias = bias + torch.where(key_padding_mask[:, None, None, :] > 0, 0.0, -1e9)
    if attn_mask is not None:
        bias = bias + attn_mask
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    scores = scores / np.sqrt(D) + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype), v)


def sparsity_ratio(layout: np.ndarray) -> float:
    """Fraction of active blocks (diagnostics; reference prints the same)."""
    return float(layout.sum()) / layout.size
