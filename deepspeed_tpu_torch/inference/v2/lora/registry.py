"""Adapter registry: the lifecycle and refcount half of multi-tenant LoRA
(the JAX package's ``inference/v2/lora/registry.py``).

State machine per adapter::

    REGISTERED --fault-in--> RESIDENT --evict--> EVICTED
         \\______________________________________/
                   (restore = fault-in from pinned buffers)

- **REGISTERED**: the validated payload lives as a host master copy
  (``[rank, elements]``, a CPU tensor in the pool dtype); no device pages.
- **RESIDENT**: the adapter owns ``rank`` pool pages the decode and verify
  steps gather from. Residency outlasts the last request that released it
  (an LRU cache, like the prefix cache's pages).
- **EVICTED**: its pages were copied into pinned ``SwapBufferPool``
  buffers and freed; a restore scatters the same bytes back and returns
  the buffers.

Refcounts gate eviction as they gate KV pages: an adapter bound to an
in-flight request is never evicted, so a decode run's gather is always
backed. A fault-in under pool pressure evicts idle adapters LRU;
``maybe_fail("serve.lora_fault")`` sits inside it so a chaos plan can
cancel mid-fault (rollback: pages freed, binding undone, refcounts at
baseline). Each fault-in and eviction takes one pair of ``perf_counter``
stamps, which feed both :class:`LoraStats` and the ``serve/lora/fault``
and ``serve/lora/swap`` tracer spans (lane ``serve/lora``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.engine_v2 import LoraStats
from deepspeed_tpu_torch.inference.v2.lora.pool import LoraPagePool
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.runtime.swap_tensor.buffer_pool import SwapBufferPool
from deepspeed_tpu_torch.utils.caching import next_pow2
from deepspeed_tpu_torch.utils.fault_injection import maybe_fail as _maybe_fail
from deepspeed_tpu_torch.utils.threads import make_lock

REGISTERED = "registered"
RESIDENT = "resident"
EVICTED = "evicted"


@dataclass
class _Adapter:
    name: str
    rank: int
    master: Optional[torch.Tensor]        # [rank, elements] host master
    state: str = REGISTERED
    page_ids: List[int] = field(default_factory=list)
    bufs: List[torch.Tensor] = field(default_factory=list)   # pinned (EVICTED)
    refcount: int = 0
    last_used: int = 0                    # LRU clock stamp


class LoraAdapterRegistry:
    """Adapter lifecycle over one :class:`LoraPagePool` (``engine.lora``).

    One mutator thread by design (the engine's), but the metadata readers
    (``names``, ``rank``, ``is_resident``, ``refcount``, ``can_admit``,
    ``binding``) may be called from other threads, so the maps they read
    are guarded by a lock; device work (fault-in scatter, eviction fetch,
    the residency sync) always runs outside it."""

    def __init__(self, pool: LoraPagePool, swap_buffers: int = 16,
                 max_rank: Optional[int] = None,
                 stats: Optional[LoraStats] = None):
        self.pool = pool
        self.max_rank = max_rank
        self.swap = SwapBufferPool(max_buffers=swap_buffers,
                                   pin_memory=pool.device.type == "cuda")
        self.stats = stats if stats is not None else LoraStats()
        # guards the maps' shape and the adapters' metadata fields for
        # readers on other threads; device work and payload copies stay out
        self._meta = make_lock("serving.lora.registry")
        self._adapters: Dict[str, _Adapter] = {}
        self._bindings: Dict[int, str] = {}   # uid -> adapter name
        self._clock = 0

    # -- registration ----------------------------------------------------- #

    def register(self, name: str, pages) -> None:
        """Register a validated adapter payload (``module_inject.lora``
        packs checkpoints into this page layout).

        ``pages``: ``[rank, elements]`` rank-slice rows (a tensor or an
        array, cast to the pool dtype), or None / empty for a rank-0 (no-op)
        adapter, which owns no pages, is trivially resident and never
        joins the rank bucket. A duplicate name with an IDENTICAL payload
        re-registers as a no-op; a different payload replaces an idle
        adapter and is refused while any request holds the old one."""
        rows = None
        rank = 0
        if pages is not None:
            if not isinstance(pages, torch.Tensor):
                pages = torch.from_numpy(np.asarray(pages))
            rows = pages.detach().to("cpu", self.pool.dtype)
            if rows.numel() == 0:
                rows = None
            elif rows.ndim != 2 or rows.shape[1] != self.pool.elements:
                raise ValueError(
                    f"adapter {name!r} payload shape {tuple(rows.shape)} does not "
                    f"match this pool's page layout (rank, "
                    f"{self.pool.elements}) — pack it with "
                    "module_inject.load_lora_adapter against THIS engine")
            else:
                rank = rows.shape[0]
        if rank > self.pool.num_pages:
            raise ValueError(
                f"adapter {name!r} rank {rank} exceeds the pool "
                f"({self.pool.num_pages} pages) — raise lora.pool_pages or "
                "reduce the adapter rank")
        if self.max_rank is not None and rank > self.max_rank:
            raise ValueError(
                f"adapter {name!r} rank {rank} exceeds lora.max_rank "
                f"({self.max_rank}) — the warmed (bucket, rank-bucket) "
                "program grid stops there, so admitting it would compile "
                "mid-steady-state; raise lora.max_rank (and re-warm)")
        with self._meta:
            old = self._adapters.get(name)
        if old is not None:
            same = (old.rank == rank
                    and (rows is None if old.master is None
                         else (rows is not None and torch.equal(old.master, rows))))
            if same:
                return                      # idempotent re-register
            if old.refcount > 0:
                raise ValueError(
                    f"adapter {name!r} is bound to {old.refcount} in-flight "
                    "request(s) — a re-register with a DIFFERENT payload "
                    "must wait until they finish (or use a new name)")
            self.unregister(name)
        with self._meta:
            self._adapters[name] = _Adapter(name=name, rank=rank, master=rows)
        self.stats.set_resident(name, rank == 0)

    def unregister(self, name: str) -> None:
        """Drop an IDLE adapter entirely (device pages freed, pinned buffers
        returned, master forgotten)."""
        ad = self._get(name)
        if ad.refcount > 0:
            raise ValueError(
                f"adapter {name!r} is bound to {ad.refcount} in-flight "
                "request(s) — cannot unregister")
        if ad.state == RESIDENT and ad.page_ids:
            self.pool.free(ad.page_ids)
        for buf in ad.bufs:
            self.swap.put(buf)
        with self._meta:
            del self._adapters[name]
        self.stats.drop(name)

    def drain_swap(self) -> int:
        """Return every EVICTED adapter's pinned buffers to the swap pool
        (the adapter drops back to REGISTERED: its next fault-in uploads the
        master, the same bytes); returns the number of buffers drained. The
        quiescent baseline (``swap.outstanding == 0``) that leak checks
        compare against."""
        with self._meta:
            evicted = [ad for ad in self._adapters.values() if ad.state == EVICTED]
        drained = 0
        for ad in evicted:
            for buf in ad.bufs:
                self.swap.put(buf)
            drained += len(ad.bufs)
            with self._meta:
                ad.bufs = []
                ad.state = REGISTERED
        return drained

    def _get(self, name: str) -> _Adapter:
        try:
            return self._adapters[name]
        except KeyError:
            raise KeyError(
                f"unknown LoRA adapter {name!r} (registered: "
                f"{sorted(self._adapters)}) — register it via "
                "module_inject.load_lora_adapter first") from None

    # -- introspection ---------------------------------------------------- #

    @property
    def names(self) -> List[str]:
        with self._meta:
            return sorted(self._adapters)

    @property
    def rank_bucket(self) -> int:
        """The pow2 rank bucket every LoRA decode and verify step runs at:
        ``next_pow2(max registered rank)``, 0 when only rank-0 adapters (or
        none) exist. Fixed by registration, not by a batch, so churn inside
        the registered set builds no new step."""
        with self._meta:
            ranks = [a.rank for a in self._adapters.values() if a.rank > 0]
        return next_pow2(max(ranks)) if ranks else 0

    def rank(self, name: str) -> int:
        with self._meta:
            return self._get(name).rank

    def is_resident(self, name: str) -> bool:
        with self._meta:
            ad = self._get(name)
            return ad.rank == 0 or ad.state == RESIDENT

    def refcount(self, name: str) -> int:
        with self._meta:
            return self._get(name).refcount

    def binding(self, uid: int) -> Optional[str]:
        with self._meta:
            return self._bindings.get(int(uid))

    def can_admit(self, name: str, releasing=()) -> bool:
        """Could ``acquire`` succeed now without shedding anyone? True when
        resident, rank-0, or free plus idle-evictable pages cover the rank.
        ``releasing`` simulates uids whose bindings are about to drop: an
        adapter becomes evictable when those releases take its refcount to
        zero."""
        with self._meta:
            ad = self._get(name)
            if ad.rank == 0 or ad.state == RESIDENT:
                return True
            rel = {int(u) for u in releasing}
            held = {}
            for u, n in self._bindings.items():
                if u not in rel:
                    held[n] = held.get(n, 0) + 1
            evictable = sum(a.rank for a in self._adapters.values()
                            if a.state == RESIDENT and held.get(a.name, 0) == 0)
        return self.pool.free_pages + evictable >= ad.rank

    # -- request lifecycle ------------------------------------------------ #

    def acquire(self, uid: int, name: str) -> None:
        """Bind request ``uid`` to adapter ``name`` and make it resident
        (faulting in, evicting idle adapters LRU, as needed). A failure
        mid-fault (pool pressure, an injected ``serve.lora_fault``) rolls
        the binding and refcount back and frees the pages allocated."""
        uid = int(uid)
        with self._meta:
            assert uid not in self._bindings, \
                f"uid {uid} already bound to {self._bindings[uid]!r}"
            ad = self._get(name)
            hit = ad.rank == 0 or ad.state == RESIDENT
            ad.refcount += 1
            self._bindings[uid] = name
        try:
            self._ensure_resident(ad)     # device work: not under _meta
        except BaseException:
            with self._meta:
                ad.refcount -= 1
                del self._bindings[uid]
            raise
        with self._meta:
            self._clock += 1
            ad.last_used = self._clock
        self.stats.record_acquire(name, hit)

    def release(self, uid: int) -> None:
        """Unbind a finished or cancelled request. The adapter stays
        resident (LRU-cached) until pool pressure evicts it."""
        uid = int(uid)
        with self._meta:
            name = self._bindings.pop(uid, None)
            if name is None:
                return
            ad = self._adapters[name]
            ad.refcount -= 1
            assert ad.refcount >= 0
        self.stats.record_release(name)

    # -- residency (fault-in / evict) ------------------------------------- #

    def _sync(self) -> None:
        if self.pool.device.type == "cuda":
            torch.cuda.current_stream(self.pool.device).synchronize()

    def _ensure_resident(self, ad: _Adapter) -> None:
        if ad.rank == 0 or ad.state == RESIDENT:
            return
        t0 = time.perf_counter()
        while self.pool.free_pages < ad.rank:
            victim = self._lru_victim(exclude=ad.name)
            if victim is None:
                raise RuntimeError(
                    f"LoRA pool pressure: adapter {ad.name!r} needs "
                    f"{ad.rank} pages, {self.pool.free_pages} free and "
                    "every resident adapter is bound to in-flight requests "
                    "— admission should defer this request (can_admit)")
            self.evict(victim.name)
        ids = self.pool.alloc(ad.rank)
        try:
            # chaos site: cancel-while-faulting rolls back to baseline
            _maybe_fail("serve.lora_fault")
            if ad.state == EVICTED:
                rows = torch.stack([self.swap.view(buf, (self.pool.elements,),
                                                   self.pool.dtype) for buf in ad.bufs])
            else:
                rows = ad.master
            self.pool.put_pages(rows, ids)
        except BaseException:
            self.pool.free(ids)
            raise
        with self._meta:
            ad.page_ids = ids
            if ad.state == EVICTED:
                for buf in ad.bufs:
                    self.swap.put(buf)
                ad.bufs = []
            ad.state = RESIDENT
        # the stamp waits for the scatter (the JAX package's
        # block_until_ready): fault-in runs between runs, never inside one
        self._sync()
        t1 = time.perf_counter()
        nbytes = ad.rank * self.pool.page_nbytes
        # one stamp pair feeds the span AND the counters (stats == spans)
        self.stats.record_fault(ad.name, nbytes, t1 - t0)
        if _tracer.enabled:
            _tracer.add("serve/lora/fault", t0, t1, lane="serve/lora",
                        adapter=ad.name, pages=ad.rank, nbytes=nbytes)

    def _lru_victim(self, exclude: str) -> Optional[_Adapter]:
        best = None
        for a in self._adapters.values():
            if (a.name == exclude or a.state != RESIDENT or a.refcount > 0
                    or a.rank == 0):
                continue
            if best is None or a.last_used < best.last_used:
                best = a
        return best

    def evict(self, name: str) -> None:
        """Device -> pinned host buffers, pages freed (refcount must be 0).
        The restore half is ``acquire``'s fault-in; the round trip is
        byte-exact (``fetch_pages`` / ``put_pages``)."""
        ad = self._get(name)
        if ad.state != RESIDENT or ad.rank == 0:
            return
        if ad.refcount > 0:
            raise RuntimeError(
                f"adapter {name!r} is bound to {ad.refcount} in-flight "
                "request(s) — cannot evict (the refcount gate that keeps "
                "decode gathers backed)")
        t0 = time.perf_counter()
        rows = self.pool.fetch_pages(ad.page_ids)     # waits for the copy
        bufs = []
        for i in range(ad.rank):
            buf = self.swap.get(self.pool.page_nbytes)
            self.swap.view(buf, (self.pool.elements,), self.pool.dtype).copy_(rows[i])
            bufs.append(buf)
        with self._meta:
            self.pool.free(ad.page_ids)
            ad.page_ids = []
            ad.bufs = bufs
            ad.state = EVICTED
        t1 = time.perf_counter()
        nbytes = ad.rank * self.pool.page_nbytes
        self.stats.record_evict(name, nbytes, t1 - t0)
        if _tracer.enabled:
            _tracer.add("serve/lora/swap", t0, t1, lane="serve/lora",
                        adapter=name, pages=ad.rank, nbytes=nbytes)

    # -- decode dispatch --------------------------------------------------- #

    def page_table(self, uids: Sequence[int], bucket: int, rb: int) -> np.ndarray:
        """The run's ``adapter_pt [bucket, rb]`` int32 operand: each row's
        bound adapter's page ids (rank-padded with the zero page); unbound,
        rank-0 and bucket-pad rows read the zero page only (an exact-zero
        delta)."""
        pt = np.full((bucket, rb), self.pool.zero_page, np.int32)
        with self._meta:
            for i, uid in enumerate(uids):
                name = self._bindings.get(int(uid))
                if name is None:
                    continue
                ad = self._adapters[name]
                if ad.rank == 0:
                    continue
                assert ad.state == RESIDENT, \
                    f"bound adapter {name!r} not resident (refcount gate broken)"
                pt[i, :ad.rank] = ad.page_ids
        return pt

    def close(self) -> None:
        """Drop everything (engine teardown): frees device pages and returns
        pinned buffers; refuses while requests are in flight."""
        for name in list(self._adapters):
            if self._adapters[name].refcount > 0:
                raise RuntimeError(f"adapter {name!r} still bound at close()")
            self.unregister(name)
