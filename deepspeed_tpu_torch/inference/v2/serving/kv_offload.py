"""Preempt-by-offload: a victim's KV pages round-trip through pinned host
buffers (the JAX package's ``serving/kv_offload.py``, ported).

The serving frontend's admission controller (``admission.py``) relieves
KV-pool pressure by preempting low-priority victims. Instead of dropping the
victim's KV and re-running its prefill on readmit (drop-and-recompute), the
victim's pages are copied to host memory and scattered back when capacity
returns: PCIe traffic proportional to the pages moved, not a prefill.

What moves: ONLY the victim's *private tail*, the longest suffix of its
block table at allocator refcount 1 (``scheduler.private_tail``). Pages
shared through the prefix cache are never offloaded: the victim keeps its
references across the preemption, the refcount keeps them allocated, and
their content is stable (full shared pages are read-only; a partial page is
private through copy-on-write adoption). So the refcounted allocator stays
consistent across offload -> restore -> cancel: offload frees refcount-1
pages after their content is copied out, restore allocates fresh ids and
scatters the bytes back in the same logical order, cancel releases the host
buffers and lets ``scheduler.flush`` settle the kept references.

Beside the pages, the victim's *last logits row* is parked on the host
(``engine._materialize``): restore re-seeds ``engine._last_logits`` with it,
so the decode pipeline's first sample resumes the stream bit for bit.

The pages travel as the engine's page payload (``page_payload_spec``) in
``SwapBufferPool`` buffers, one a page, page-pinned when the engine runs on
the card: ``engine.fetch_pages(out=)`` copies each page from the device
straight into its buffer and ``engine.put_pages`` copies the buffers
straight back, with no pageable staging copy, and steady-state preemption
allocates no host memory.
``max_bytes`` caps residency; past it the frontend falls back to
recompute-preemption for that victim. The same payload is the cluster's
cross-engine fabric: ``engine.export_kv`` is an offload record shipped to
another pool and ``engine.import_kv`` its restore.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.swap_tensor.buffer_pool import SwapBufferPool


@dataclass
class _OffloadRecord:
    kept: int                       # shared-prefix blocks the seq still holds
    bufs: List[torch.Tensor]        # one pooled host buffer per offloaded page
    logits: np.ndarray              # last logits row (restore re-seeds it)
    nbytes: int


def _page_view(buf: torch.Tensor, shape, dtype) -> np.ndarray:
    """A payload-typed numpy window into a pooled uint8 buffer (no copy)."""
    dtype = np.dtype(dtype)
    count = int(np.prod(shape)) if len(shape) else 1
    return buf.numpy()[:count * dtype.itemsize].view(dtype).reshape(shape)


class KVOffloadManager:
    """Owns the offloaded-page store of one engine's serving frontend."""

    def __init__(self, engine, max_bytes: Optional[int] = None,
                 max_buffers: int = 16):
        self.engine = engine
        self.max_bytes = max_bytes
        self.pool = SwapBufferPool(max_buffers,
                                   pin_memory=engine.device.type == "cuda")
        self._recs: Dict[int, _OffloadRecord] = {}
        self.bytes_held = 0
        # cumulative counters (FrontendStats mirrors them into serve/frontend)
        self.offload_bytes_total = 0
        self.restore_bytes_total = 0

    @property
    def page_nbytes(self) -> int:
        # bytes_per_block IS the host page payload for every pool layout
        # (an int8 pool ships packed value + scale-tile rows of this size)
        return self.engine.kv.config.bytes_per_block()

    @property
    def uids(self) -> List[int]:
        return list(self._recs)

    def pages_held(self, uid: int) -> int:
        return len(self._recs[uid].bufs)

    def can_offload(self, n_pages: int) -> bool:
        """Would ``n_pages`` more pages fit under ``max_bytes``? The frontend
        checks this BEFORE preempting, and falls back to recompute-preemption
        for the victim when host capacity is exhausted."""
        if self.max_bytes is None:
            return True
        return self.bytes_held + n_pages * self.page_nbytes <= self.max_bytes

    # ------------------------------------------------------------------ #

    def offload(self, uid: int, kept: int, tail: List[int]) -> int:
        """Offload ``tail`` (uid's private-suffix page ids, split off by
        ``scheduler.private_tail``) to pooled host buffers, free the device
        pages, and park the last logits row. Returns bytes moved. The
        sequence keeps its shared prefix; the uid must already be retired
        from the decode pipeline."""
        e = self.engine
        assert uid not in self._recs, f"uid {uid} already offloaded"
        # the last logits row first: materializing pops the device ref
        e._materialize([uid])
        logits = e._last_logits.pop(uid)
        # ONE bucketed gather for the whole tail, copied into the pooled
        # buffers BEFORE the ids are freed; one buffer a page, so restore
        # releases buffers whatever the tail's length
        bufs = [self.pool.get(self.page_nbytes) for _ in tail]
        try:
            if tail:
                e.fetch_pages(tail, out=bufs)
        except BaseException:
            for buf in bufs:
                self.pool.put(buf)
            raise
        nbytes = len(tail) * self.page_nbytes
        e.scheduler.drop_tail(uid, kept)
        e._last_ref.pop(uid, None)
        self._recs[uid] = _OffloadRecord(kept=kept, bufs=bufs, logits=logits,
                                         nbytes=nbytes)
        self.bytes_held += nbytes
        self.offload_bytes_total += nbytes
        return nbytes

    def restore(self, uid: int) -> int:
        """Scatter the offloaded pages into fresh pool blocks (appended to
        the block table in the original logical order), release the host
        buffers, and re-seed the last logits row. Returns bytes moved. The
        caller readmits the uid to the decode pipeline after."""
        e = self.engine
        rec = self._recs.pop(uid)
        ids = e.scheduler.grow_tail(uid, len(rec.bufs))
        if ids:
            # ONE bucketed scatter for the whole tail, original logical order
            e.put_pages(rec.bufs, ids)
            for buf in rec.bufs:
                self.pool.put(buf)
        e._last_logits[uid] = rec.logits
        self.bytes_held -= rec.nbytes
        self.restore_bytes_total += rec.nbytes
        return rec.nbytes

    def salvageable(self, uid: int) -> bool:
        """Can ``uid``'s record seed a CROSS-REPLICA import? Only when it
        covers the sequence's whole KV (``kept == 0``: no shared-prefix page
        was left behind on the failed replica)."""
        rec = self._recs.get(uid)
        return rec is not None and rec.kept == 0 and bool(rec.bufs)

    def export_record(self, uid: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Failover salvage (``health.py``): turn ``uid``'s record into the
        ``(pages, logits, nbytes)`` payload ``submit_handoff`` ships to a
        survivor's ``import_kv``. Copies the pages out, releases the pooled
        buffers and drops the record."""
        assert self.salvageable(uid), f"uid {uid} is not salvageable"
        rec = self._recs[uid]
        shape, dtype = self.engine.page_payload_spec
        pages = np.stack([_page_view(b, shape, dtype)
                          for b in rec.bufs])      # stack copies out
        logits, nbytes = rec.logits, rec.nbytes
        self.drop(uid)
        return pages, logits, nbytes

    def drop(self, uid: int) -> None:
        """Cancel-while-offloaded: release the host buffers; the caller
        flushes the sequence (its kept shared-prefix references settle
        through ``scheduler.flush``)."""
        rec = self._recs.pop(uid)
        for buf in rec.bufs:
            self.pool.put(buf)
        self.bytes_held -= rec.nbytes

    def close(self) -> None:
        for uid in list(self._recs):
            self.drop(uid)
