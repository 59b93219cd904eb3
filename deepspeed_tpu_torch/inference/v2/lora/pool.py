"""Paged adapter-weight pool for multi-tenant LoRA serving (the JAX
package's ``inference/v2/lora/pool.py``).

ONE dense tensor ``[num_pages + 2, elements]`` in the model dtype on the
engine's device, managed like the KV pool:

- a **page** is one rank slice of a whole adapter (column j of every
  targeted projection's A and row j of its B, all layers:
  ``ragged_model.lora_page_layout``), so every page has the same size and
  a rank-r adapter owns r pages anywhere in the pool;
- index ``num_pages`` is the **zero page**: read-only zeros behind unbound
  rows, rank padding below the dispatch bucket and gather pad slots, which
  therefore add exact-zero deltas;
- index ``num_pages + 1`` is the **junk page**: where pad writes land.

Host round trips go through pow2-bucketed movers (the KV page fabric's
pattern): :meth:`fetch_pages` gathers with ``index_select`` and copies the
rows to the host through one pinned buffer; :meth:`put_pages` scatters with
``index_copy_``. The decode and verify steps read the pool tensor directly
(``ragged_model.lora_layer_operands``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
from deepspeed_tpu_torch.inference.v2.ragged_model import lora_page_layout
from deepspeed_tpu_torch.utils.caching import next_pow2


class LoraPagePool:
    """Fixed-size adapter-weight pages on the device and a free list.

    Allocation and refcount policy live in ``LoraAdapterRegistry``; this
    class owns the device tensor, the free list and the host movers."""

    def __init__(self, spec, targets: Tuple[str, ...], num_pages: int, device):
        self.spec = spec
        self.targets = tuple(targets)
        self.elements, self.in_max, self.out_max = lora_page_layout(spec, self.targets)
        self.num_pages = int(num_pages)
        self.zero_page = self.num_pages
        self.junk_page = self.num_pages + 1
        self.dtype = spec.dtype
        self.device = torch.device(device)
        self.pool = torch.zeros((self.num_pages + 2, self.elements), dtype=self.dtype,
                                device=self.device)
        self._free: List[int] = list(range(self.num_pages))

    # -- allocator ------------------------------------------------------- #

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def page_nbytes(self) -> int:
        return self.elements * self.pool.element_size()

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"LoRA pool exhausted: need {n} pages, {len(self._free)} "
                f"free of {self.num_pages} — evict an idle adapter first "
                "(registry handles this; a direct caller raced it)")
        return [self._free.pop() for _ in range(n)]

    def free(self, ids: Sequence[int]) -> None:
        for b in ids:
            b = int(b)
            assert 0 <= b < self.num_pages, f"freeing non-pool page {b}"
            assert b not in self._free, f"double free of LoRA page {b}"
            self._free.append(b)

    # -- bucketed host movers (the KV page-fabric pattern) --------------- #

    def _index(self, ids: List[int], pad: int) -> torch.Tensor:
        """``ids`` padded to a power of two with ``pad``, on the device."""
        idx = [pad] * next_pow2(len(ids))
        idx[:len(ids)] = ids
        return to_device(idx, self.device).long()

    def fetch_pages(self, ids: Sequence[int]) -> torch.Tensor:
        """Pages to the host in one bucketed gather (pad slots read the zero
        page) and one copy through a pinned buffer: a CPU tensor ``[n,
        elements]`` in the pool dtype, byte-exact with :meth:`put_pages`.
        Waits for the copy (between runs, never inside one)."""
        ids = [int(b) for b in ids]
        rows = self.pool.index_select(0, self._index(ids, self.zero_page))
        cuda = self.device.type == "cuda"
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=cuda)
        host.copy_(rows, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return host[:len(ids)]

    def put_pages(self, rows: torch.Tensor, ids: Sequence[int]) -> None:
        """Scatter host rows ``[n, elements]`` into pool pages ``ids`` (one
        bucketed ``index_copy_``); pad slots write zeros into the junk
        page."""
        ids = [int(b) for b in ids]
        if not ids:
            return
        rows = torch.as_tensor(rows).to(self.dtype)
        if tuple(rows.shape) != (len(ids), self.elements):
            raise ValueError(
                f"LoRA page payload shape {tuple(rows.shape)} does not match "
                f"({len(ids)}, {self.elements}) — pages are fixed-size "
                "rank slices (lora_page_layout)")
        bucket = next_pow2(len(ids))
        if bucket != len(ids):
            rows = torch.cat([rows, rows.new_zeros((bucket - len(ids), self.elements))])
        self.pool.index_copy_(0, self._index(ids, self.junk_page), rows.to(self.device))
