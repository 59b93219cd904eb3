"""Blocked (paged) KV cache.

The pool is ONE tensor ``[L, NB, 2, Hkv, bs, D]``: per layer and page, K
(index 0) and V (index 1) of every kv head, head-major, the same layout as
the JAX package's pool, so pages can move between the two packages. Each
pass writes its new K/V rows into the pool IN PLACE (``index_copy_``); the
kernels read pages through block tables.

A quantized pool (``kv_quant``) holds int8 values in the same layout and
one f32 scale per (token, kv head) row beside it, stored at rest in the
kernels' tile layout ``[L, NB, R8, 128]`` (``ops/kernels/kv_quant.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_scale_tiles_shape


@dataclass
class KVCacheConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    block_size: int = 128
    num_blocks: int = 256
    dtype: torch.dtype = torch.bfloat16
    quantized: bool = False

    def bytes_per_block(self) -> int:
        """At-rest bytes of one pool page across all layers, as the JAX
        package counts them; for an int8 pool also the page payload
        (``engine.page_payload_spec``): the int8 values, then the f32 scale
        tile in its padded layout."""
        values = 2 * self.num_kv_heads * self.block_size * self.head_dim
        if self.quantized:
            _, r8, lanes = kv_scale_tiles_shape(1, self.num_kv_heads, self.block_size)
            return self.num_layers * (values + r8 * lanes * 4)
        return self.num_layers * values * torch.empty((), dtype=self.dtype).element_size()


class BlockedKVCache:
    """Owns the combined page tensor ``kv`` [L, NB, 2, Hkv, bs, D] on
    ``device`` (int8 when quantized, with its scale tiles ``scales``
    [L, NB, R8, 128] f32; ``scales`` is None otherwise)."""

    def __init__(self, config: KVCacheConfig, device):
        self.config = config
        shape = (config.num_layers, config.num_blocks, 2,
                 config.num_kv_heads, config.block_size, config.head_dim)
        dtype = torch.int8 if config.quantized else config.dtype
        self.kv = torch.zeros(shape, dtype=dtype, device=device)
        self.scales: Optional[torch.Tensor] = None
        if config.quantized:
            self.scales = torch.zeros(
                (config.num_layers,) + kv_scale_tiles_shape(
                    config.num_blocks, config.num_kv_heads, config.block_size),
                dtype=torch.float32, device=device)

    def flat_write_index(self, block_id, slot) -> np.ndarray:
        """Host-side flat destination ``block * block_size + slot``."""
        return (np.asarray(block_id, np.int64) * self.config.block_size
                + np.asarray(slot, np.int64)).astype(np.int32)

    @property
    def oob_sentinel(self) -> int:
        """Destination of padding rows: one past the last pool token."""
        return self.config.num_blocks * self.config.block_size
