"""Host-side pass descriptor arrays.

Pass layout (see ``ragged_model.py`` for how each section is used):

  - **chunk section** (``num_slots`` slots of ``slot_size`` rows): several
    sequences' prompt chunks prefill together in one pass; Dynamic SplitFuse
    composes them with the ready decode tokens.
  - **decode section** (``max_sequences`` rows): one query token per
    sequence, served by the paged decode kernel.

The scheduler fills slots and decode rows from index 0, so
:meth:`RaggedBatch.device_arrays` ships only the filled prefix of each
section: eager execution has no use for the static padded shapes a compiled
program needs, and the projections then run over real rows only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import numpy as np
import torch


@dataclass
class RaggedBatch:
    # static capacities
    num_slots: int                            # chunk slots per pass
    slot_size: int                            # tokens per slot
    max_sequences: int
    max_blocks: int

    # chunk section (slot-major rows). A sequence may span several
    # consecutive slots in one pass: chunk_uids and chunk_is_final are per
    # SEQUENCE (scheduling order); slot_uid is per filled SLOT (the logits row
    # for a finished prompt is its last slot).
    chunk_uids: List[int] = field(default_factory=list)   # per sequence
    slot_uid: List[int] = field(default_factory=list)     # per filled slot
    chunk_tokens: np.ndarray = None           # [NC * Cs] int32
    chunk_positions: np.ndarray = None        # [NC * Cs] int32
    chunk_ntok: np.ndarray = None             # [NC] int32 (0 = empty slot)
    chunk_block_tables: np.ndarray = None     # [NC, MB] int32
    chunk_q0: np.ndarray = None               # [NC] int32
    chunk_ctx_lens: np.ndarray = None         # [NC] int32 (0 = empty slot)
    chunk_is_final: List[bool] = field(default_factory=list)  # per sequence

    # decode section
    decode_uids: List[int] = field(default_factory=list)
    decode_tokens: np.ndarray = None          # [S] int32
    decode_positions: np.ndarray = None       # [S] int32
    decode_block_tables: np.ndarray = None    # [S, MB] int32
    decode_ctx_lens: np.ndarray = None        # [S] int32 (0 => inactive row)

    # flat KV destinations (page * block_size + slot) for every new token,
    # chunk rows then decode rows; padding rows hold ``kv_sentinel``
    kv_dest: np.ndarray = None                # [NC * Cs + S] int32
    kv_sentinel: int = 0

    # per-chunk-row sequence index (position in chunk_uids; -1 = padding row)
    # for the packed prefill fast path
    row_seg: np.ndarray = None                # [NC * Cs] int32
    # True when this pass is prefill-from-zero only (no decode rows, every
    # chunk sequence starts at position 0): attention then needs no paged
    # reads and the engine routes to the packed prefill forward
    pure_prefill: bool = False
    # page-granular KV write plan for pure-prefill passes: each written page
    # is one contiguous run of chunk rows. page_ids: page written;
    # page_rows: chunk-row index of the page's first token; page_fill: tokens
    # written to that page (0 = unused entry).
    page_ids: np.ndarray = None               # [PW] int32
    page_rows: np.ndarray = None              # [PW] int32
    page_fill: np.ndarray = None              # [PW] int32

    def __post_init__(self):
        NC, Cs = self.num_slots, self.slot_size
        S, MB = self.max_sequences, self.max_blocks
        if self.chunk_tokens is None:
            self.chunk_tokens = np.zeros((NC * Cs,), np.int32)
        if self.chunk_positions is None:
            self.chunk_positions = np.zeros((NC * Cs,), np.int32)
        if self.chunk_ntok is None:
            self.chunk_ntok = np.zeros((NC,), np.int32)
        if self.chunk_block_tables is None:
            self.chunk_block_tables = np.zeros((NC, MB), np.int32)
        if self.chunk_q0 is None:
            self.chunk_q0 = np.zeros((NC,), np.int32)
        if self.chunk_ctx_lens is None:
            self.chunk_ctx_lens = np.zeros((NC,), np.int32)
        if self.decode_tokens is None:
            self.decode_tokens = np.zeros((S,), np.int32)
        if self.decode_positions is None:
            self.decode_positions = np.zeros((S,), np.int32)
        if self.decode_block_tables is None:
            self.decode_block_tables = np.zeros((S, MB), np.int32)
        if self.decode_ctx_lens is None:
            self.decode_ctx_lens = np.zeros((S,), np.int32)
        if self.kv_dest is None:
            self.kv_dest = np.zeros((NC * Cs + S,), np.int32)
        if self.row_seg is None:
            self.row_seg = np.full((NC * Cs,), -1, np.int32)
        # page_ids/page_rows/page_fill stay None here: their size needs the
        # cache block size, so the scheduler allocates them

    @property
    def current_sequences(self) -> int:
        return len(self.chunk_uids) + len(self.decode_uids)

    def host_arrays(self) -> Dict[str, np.ndarray]:
        """Every descriptor trimmed to the filled slots and decode rows.

        ``kv_src``/``kv_dest`` list only the pass rows whose KV destination
        is real: padding rows carry ``kv_sentinel`` and are dropped HERE, on
        the host, so the device-side ``index_copy_`` never sees an
        out-of-range row. Unused page-plan entries (fill 0) drop the same
        way."""
        NC, Cs = self.num_slots, self.slot_size
        ncu, su = len(self.slot_uid), len(self.decode_uids)
        rows = ncu * Cs
        dest = np.concatenate([self.kv_dest[:rows],
                               self.kv_dest[NC * Cs:NC * Cs + su]])
        src = np.flatnonzero(dest < self.kv_sentinel).astype(np.int32)
        out = {
            "chunk_tokens": self.chunk_tokens[:rows],
            "chunk_positions": self.chunk_positions[:rows],
            "chunk_ntok": self.chunk_ntok[:ncu],
            "chunk_block_tables": self.chunk_block_tables[:ncu],
            "chunk_q0": self.chunk_q0[:ncu],
            "chunk_ctx_lens": self.chunk_ctx_lens[:ncu],
            "decode_tokens": self.decode_tokens[:su],
            "decode_positions": self.decode_positions[:su],
            "decode_block_tables": self.decode_block_tables[:su],
            "decode_ctx_lens": self.decode_ctx_lens[:su],
            "kv_src": src,
            "kv_dest": dest[src],
            "row_seg": self.row_seg[:rows],
        }
        if self.page_fill is not None:
            used = self.page_fill > 0
            out["page_ids"] = self.page_ids[used]
            out["page_rows"] = self.page_rows[used]
            out["page_fill"] = self.page_fill[used]
        return out

    def device_arrays(self, device, keys: Iterable[str]) -> Dict[str, torch.Tensor]:
        """The ``keys`` of :meth:`host_arrays` as int32 tensors on ``device``
        (each pass forward reads only its own keys)."""
        host = self.host_arrays()
        return {k: to_device(host[k], device) for k in keys}


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host int32 array -> tensor on ``device``. On CUDA the array is staged
    in pinned memory and copied without a host sync (the caching host
    allocator keeps the staging buffer until the copy has run); on the CPU
    it is a copy. Either way the caller may reuse the array at once."""
    return host_to_device(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)),
                          device)


def host_to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device`` without a host sync: pinned staging and
    a non-blocking copy on CUDA, a copy on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)


@dataclass
class DecodeBatch:
    """BUCKETED decode-only descriptor set for the pipelined decode step.

    Row count is padded to ``bucket = next_pow2(len(uids))``. Pad rows are
    inert fake sequences — position 0 (context 1), and a block table that
    is ALL the engine's scratch page, so whatever they read is garbage that
    never reaches a real row and whatever they write lands in the scratch
    page no real sequence maps. This relies on decode being row-independent.

    The pipeline uploads these arrays once per run and advances positions
    (and contexts, position + 1) on the device, so no host array is ever in
    flight while the host changes it.
    """
    uids: List[int]
    bucket: int
    positions: np.ndarray       # [bucket] int32; pad rows 0
    block_tables: np.ndarray    # [bucket, MB] int32; pad rows all-scratch
