"""Per-sequence tracking state: seen tokens, owned KV blocks, the host-side
block-table row, the pending (unprocessed) prompt tail the scheduler
drains chunk by chunk (Dynamic SplitFuse), and the token history the
prefix cache keys pages by and the n-gram proposer drafts from (the JAX
package's ``sequence_descriptor.py`` :28-76)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

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
    # every token the host has seen for this sequence, in order (recorded
    # when a prefix cache is wired, or for spec decode's proposer): the
    # radix tree keys KV pages by the tokens that produced them. Tokens the
    # device generated without the host seeing them (pipeline runs, bursts)
    # are not here; pages beyond the history are freed, not cached. A part
    # list keeps the per-token append O(1); ``history()`` flattens it.
    history_parts: List[np.ndarray] = field(default_factory=list)
    history_len: int = 0
    # length of the CONTIGUOUS recorded prefix (None = all of history):
    # tokens recorded after a device-generated gap sit at later positions
    # than their history index, so ``scheduler.advance`` seals the valid
    # prefix at the gap and nothing past it keys a cached page
    history_valid: Optional[int] = None
    cached_tokens: int = 0                    # prompt tokens served from cache
    filed_tokens: int = 0                     # tokens already eager-inserted
    # the prefix cache's weight version at admission: a flush whose stamp
    # trails the cache's frees the pages instead of filing them
    weight_version: int = 0

    def kv_blocks_needed(self, new_tokens: int, block_size: int) -> int:
        """Extra blocks required to hold ``new_tokens`` more tokens."""
        total = self.seen_tokens + new_tokens
        needed = -(-total // block_size)      # ceil
        return max(0, needed - len(self.blocks))

    def extend_pending(self, tokens: np.ndarray) -> None:
        self.pending = np.concatenate([self.pending, np.asarray(tokens, np.int32)])

    def record_history(self, tokens: np.ndarray) -> None:
        t = np.asarray(tokens, np.int32)
        self.history_parts.append(t)
        self.history_len += len(t)

    def history(self, n: Optional[int] = None) -> np.ndarray:
        """The recorded token history (its first ``n`` tokens), flattened
        in place (called per prompt completion or flush, not per token)."""
        if len(self.history_parts) != 1:
            self.history_parts = [
                np.concatenate(self.history_parts) if self.history_parts
                else np.zeros((0,), np.int32)]
        h = self.history_parts[0]
        return h if n is None else h[:n]

    def block_table(self, max_blocks: int) -> np.ndarray:
        bt = np.zeros((max_blocks,), np.int32)
        n = len(self.blocks)
        if n > max_blocks:
            raise ValueError(f"sequence {self.uid} needs {n} blocks > "
                             f"max_blocks_per_sequence {max_blocks}")
        bt[:n] = self.blocks
        return bt
