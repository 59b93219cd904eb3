"""Per-sequence tracking state: seen tokens, owned KV blocks, the host-side
block-table row, and the pending (unprocessed) prompt tail the scheduler
drains chunk by chunk (Dynamic SplitFuse)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class DSSequenceDescriptor:
    uid: int
    seen_tokens: int = 0                      # tokens whose KV is in the cache
    # logical page i -> physical block; under a sliding window's page ring
    # (scheduler.ring_pages) later pages repeat earlier physical ids
    blocks: List[int] = field(default_factory=list)
    pending: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    in_flight_tokens: int = 0                 # tokens scheduled in the current pass

    def kv_blocks_needed(self, new_tokens: int, block_size: int) -> int:
        """Extra blocks required to hold ``new_tokens`` more tokens."""
        total = self.seen_tokens + new_tokens
        needed = -(-total // block_size)      # ceil
        return max(0, needed - len(self.blocks))

    def extend_pending(self, tokens: np.ndarray) -> None:
        self.pending = np.concatenate([self.pending, np.asarray(tokens, np.int32)])

    def block_table(self, max_blocks: int) -> np.ndarray:
        bt = np.zeros((max_blocks,), np.int32)
        n = len(self.blocks)
        if n > max_blocks:
            raise ValueError(f"sequence {self.uid} needs {n} blocks > "
                             f"max_blocks_per_sequence {max_blocks}")
        bt[:n] = self.blocks
        return bt
