"""Optimizer-state swappers (the JAX package's
``runtime/swap_tensor/optimizer_swapper.py``): named fp32 tensors that live
in files on disk, swapped into host buffers around the step.

``OptimizerStateSwapper`` swaps synchronously: ``register`` writes a
tensor's first value to its file, ``swap_in(names)`` reads the named
tensors into pooled buffers and returns writable numpy views,
``swap_out`` writes them back and returns the buffers. Transient IO
failures get ``io_retries`` bounded re-attempts with backoff and then
surface; ``io_timeout_s`` puts a deadline on each wait, and a wait that
timed out is joined (it may still write into its buffer) before any buffer
is recycled. ``PipelinedOptimizerSwapper`` runs a group walk
double-buffered: while the step function runs on group i, group i+1's
reads are in flight on a second AIO handle and group i-1's writes drain on
a third (``pipeline_read`` / ``pipeline_write``). Each tensor owns one file
under the swap directory, read and written whole through the native AIO
engine (``ops/native/aio.py``). The pooled buffers are the port's
``SwapBufferPool`` (torch uint8 host tensors), viewed as numpy arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.ops.native.aio import AsyncIOHandle
from deepspeed_tpu_torch.runtime.swap_tensor.buffer_pool import SwapBufferPool
from deepspeed_tpu_torch.utils.resilience import DeferredCall, IOTimeout, retry_call


@dataclass
class SwappedTensorMeta:
    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    path: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize if self.shape \
            else np.dtype(self.dtype).itemsize


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class OptimizerStateSwapper:
    """Synchronous swap-in/step/swap-out of named tensors.

    ``register(name, array)`` writes the initial value to its file and drops the
    host copy; ``swap_in(names)`` returns name -> writable array views backed by
    pooled buffers; ``swap_out(views)`` persists them and releases the buffers.
    """

    def __init__(self, swap_dir: str, aio_config: Optional[dict] = None,
                 max_pooled_buffers: int = 16, io_retries: int = 2,
                 io_timeout_s: float = 0.0):
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        aio = dict(aio_config or {})
        self.handle = AsyncIOHandle(
            block_size=aio.get("block_size", 1 << 20),
            queue_depth=aio.get("queue_depth", 32),
            thread_count=aio.get("thread_count", 4),
            single_submit=aio.get("single_submit", False),
            overlap_events=aio.get("overlap_events", True),
            use_o_direct=aio.get("use_o_direct", False))
        self.pool = SwapBufferPool(max_buffers=max_pooled_buffers)
        self.meta: Dict[str, SwappedTensorMeta] = {}
        self._views: Dict[str, np.ndarray] = {}   # name -> typed view
        self._buffers: Dict[str, np.ndarray] = {}  # name -> raw pooled buffer
        # IO failure discipline: transient failures get
        # io_retries bounded re-attempts with backoff, then SURFACE; waits get
        # an io_timeout_s deadline (0 = none) so a dead disk raises IOTimeout
        # instead of hanging the step forever
        self.io_attempts = 1 + max(0, int(aio.get("io_retries", io_retries)))
        self.io_timeout_s = float(aio.get("io_timeout_s", io_timeout_s))
        #: cumulative retries taken (observability; never resets)
        self.io_retries_taken = 0
        # stragglers: DeferredCall-wrapped waits that timed out — the IO is
        # STILL RUNNING on its thread, so a buffer release must re-join them
        # first (recycled memory must never be a live DMA target)
        self._stragglers: List[DeferredCall] = []

    # -- IO discipline helpers --------------------------------------------- #
    def _count_retry(self, attempt, exc) -> None:
        self.io_retries_taken += 1

    def _retry(self, fn, describe: str):
        # IOTimeout subclasses OSError (via TimeoutError) but must NOT be
        # retried: the timed-out wait is STILL RUNNING, and re-submitting the
        # same names would claim fresh pool buffers while the straggler DMAs
        # into the old ones — it surfaces to the except-IOTimeout paths
        return retry_call(fn, attempts=self.io_attempts,
                          retry_on=(OSError,), no_retry_on=(IOTimeout,),
                          describe=describe, on_retry=self._count_retry)

    def _wait(self, handle: AsyncIOHandle, describe: str) -> int:
        """``handle.wait()`` under the deadline. On timeout the real wait keeps
        running on its thread; it is recorded as a straggler (``_join_
        stragglers`` re-joins it before any buffer recycles) and IOTimeout
        SURFACES to the caller. Each wait records an ``aio/wait`` span —
        the swapper's disk stalls get their own timeline track instead of
        silently widening whatever phase happened to contain them."""
        with _tracer.span("aio/wait", lane="aio", op=describe):
            if self.io_timeout_s <= 0:
                return handle.wait()
            call = DeferredCall(handle.wait, describe=describe)
            try:
                return call.result(self.io_timeout_s)
            except IOTimeout:
                self._stragglers.append(call)
                raise

    def _join_stragglers(self) -> None:
        """Block until every timed-out wait actually retires (no deadline:
        correctness over promptness — buffers are about to be recycled)."""
        stragglers, self._stragglers = self._stragglers, []
        for call in stragglers:
            try:
                call.result(None)
            except Exception:   # the IOTimeout already surfaced to the caller
                pass

    # -- registration ----------------------------------------------------- #
    def register(self, name: str, array: np.ndarray) -> SwappedTensorMeta:
        safe = name.replace("/", "__")
        meta = SwappedTensorMeta(name=name, shape=tuple(array.shape),
                                 dtype=np.dtype(array.dtype),
                                 path=os.path.join(self.swap_dir, f"{safe}.swp"))
        arr = np.ascontiguousarray(array)

        def _once():
            rc = self.handle.sync_pwrite(arr, meta.path)
            if rc != 0:
                raise OSError(-rc, f"swap register write failed for {meta.path}")

        self._retry(_once, f"register {name}")
        self.meta[name] = meta
        return meta

    def element_count(self) -> int:
        return sum(int(np.prod(m.shape)) for m in self.meta.values())

    # -- sync swap --------------------------------------------------------- #
    def swap_in(self, names: Sequence[str]) -> Dict[str, np.ndarray]:
        """A failed submit or read gets ``io_retries`` bounded re-attempts,
        then surfaces HERE (never swallowed) — and the failed call releases
        every buffer it claimed — ``pool.outstanding`` is back where it
        started after an aborted swap-in."""

        def _attempt():
            self._submit_reads(names)
            try:
                n = self._wait(self.handle, "swap-in wait")
            except IOTimeout:
                raise   # the outer handler releases AFTER the straggler joins
            except BaseException:
                # a wait that RAISES (not just a negative rc) has still
                # drained the handle — release the claimed buffers so the
                # failed attempt leaves the pool at baseline
                self._release(names)
                raise
            if n < 0:
                self._release(names)
                raise OSError(-n, "swap-in read failed")

        try:
            self._retry(_attempt, "swap-in")
        except IOTimeout:
            # the straggling wait may still DMA into the claimed buffers:
            # join it for real before handing them back to the pool
            self._join_stragglers()
            self._release(names)
            raise
        return {name: self._views[name] for name in names}

    def swap_out(self, names: Optional[Sequence[str]] = None) -> None:
        names = list(self._views) if names is None else list(names)

        def _attempt():
            self._submit_writes(names)
            n = self._wait(self.handle, "swap-out wait")
            if n < 0:
                raise OSError(-n, "swap-out write failed")

        try:
            self._retry(_attempt, "swap-out")
        except IOTimeout:
            self._join_stragglers()
            raise
        finally:
            # release even on failure: the swap files may be torn, but the
            # pooled buffers must not leak (outstanding back to baseline)
            self._release(names)

    # -- internals shared with the pipelined swapper ----------------------- #
    def _submit_reads(self, names: Sequence[str], handle=None) -> None:
        handle = handle or self.handle
        submitted: List[str] = []
        for name in names:
            meta = self.meta[name]
            buf = self.pool.get(meta.nbytes)
            view = self.pool.view(buf, meta.shape, _torch_dtype(meta.dtype)).numpy()
            self._buffers[name] = buf
            self._views[name] = view
            try:
                rc = handle.async_pread(view, meta.path)
            except BaseException:
                # a submit that RAISES (not just a negative rc) must leave
                # the pool at baseline too — same drain-then-release path
                if submitted:
                    handle.wait()
                self._release(submitted + [name])
                raise
            if rc != 0:
                # drain whatever this call already queued before releasing its
                # buffers — in-flight reads must not land in recycled memory
                if submitted:
                    handle.wait()
                self._release(submitted + [name])
                raise OSError(-rc, f"swap-in submit failed for {meta.path}")
            submitted.append(name)

    def _submit_writes(self, names: Sequence[str], handle=None) -> None:
        handle = handle or self.handle
        for name in names:
            meta = self.meta[name]
            try:
                rc = handle.async_pwrite(self._views[name], meta.path)
            except BaseException:
                handle.wait()   # drain earlier submits; caller releases
                raise
            if rc != 0:
                handle.wait()   # drain earlier submits; caller releases
                raise OSError(-rc, f"swap-out submit failed for {meta.path}")

    def _release(self, names: Iterable[str]) -> None:
        for name in names:
            self._views.pop(name, None)
            buf = self._buffers.pop(name, None)
            if buf is not None:
                self.pool.put(buf)

    # -- whole-state materialisation (checkpoint save) --------------------- #
    def read_all(self) -> Dict[str, np.ndarray]:
        out = {}
        for name, meta in self.meta.items():
            if name in self._views:
                out[name] = np.array(self._views[name])
                continue
            arr = np.empty(meta.shape, meta.dtype)

            def _once(arr=arr, meta=meta):
                rc = self.handle.sync_pread(arr, meta.path)
                if rc != 0:
                    raise OSError(-rc, f"swap read_all failed for {meta.path}")

            self._retry(_once, f"read_all {name}")
            out[name] = arr
        return out

    def write(self, name: str, array: np.ndarray) -> None:
        """Overwrite a registered tensor's file (checkpoint load)."""
        meta = self.meta[name]
        if tuple(array.shape) != meta.shape:
            raise ValueError(f"swap write shape mismatch for {name}")
        arr = np.ascontiguousarray(array, meta.dtype)

        def _once():
            rc = self.handle.sync_pwrite(arr, meta.path)
            if rc != 0:
                raise OSError(-rc, f"swap write failed for {meta.path}")

        self._retry(_once, f"write {name}")

    def close(self):
        self.handle.close()


class PipelinedOptimizerSwapper(OptimizerStateSwapper):
    """Double-buffered group pipeline over sub-groups of tensors.

    ``run(groups, step_fn)`` iterates groups of names; while ``step_fn`` runs on
    group i's views, group i+1's reads are already in flight on a second AIO
    handle and group i-1's writes drain on a third (parity:
    pipelined_optimizer_swapper.py ``pipeline_read``/``pipeline_write``).
    """

    def __init__(self, swap_dir: str, aio_config: Optional[dict] = None,
                 max_pooled_buffers: int = 16, pipeline_read: bool = True,
                 pipeline_write: bool = True, io_retries: int = 2,
                 io_timeout_s: float = 0.0):
        super().__init__(swap_dir, aio_config, max_pooled_buffers,
                         io_retries=io_retries, io_timeout_s=io_timeout_s)
        self.pipeline_read = pipeline_read
        self.pipeline_write = pipeline_write
        aio = dict(aio_config or {})
        kw = dict(block_size=aio.get("block_size", 1 << 20),
                  queue_depth=aio.get("queue_depth", 32),
                  thread_count=aio.get("thread_count", 4),
                  single_submit=aio.get("single_submit", False),
                  overlap_events=aio.get("overlap_events", True),
                  use_o_direct=aio.get("use_o_direct", False))
        self._read_handle = AsyncIOHandle(**kw) if pipeline_read else self.handle
        self._write_handle = AsyncIOHandle(**kw) if pipeline_write else self.handle

    def run(self, groups: Sequence[Sequence[str]], step_fn) -> None:
        """``step_fn(group_views: Dict[str, np.ndarray])`` mutates views in place.

        Abort-safe: a failed ``async_pread``/``async_pwrite`` submit, a failed
        wait, or an exception out of ``step_fn`` surfaces HERE — the overlap
        machinery never swallows it — and the abort path drains every handle
        and releases every pooled buffer, so ``pool.outstanding`` returns to
        its pre-``run`` value."""
        groups = [list(g) for g in groups if g]
        if not groups:
            return
        try:
            inflight_writes: List[str] = []
            for i, group in enumerate(groups):
                if any(name not in self._views for name in group):
                    self._read_group(group)  # not prefetched (first group / no pipeline)
                if self.pipeline_read and i + 1 < len(groups):
                    self._prefetch_group(groups[i + 1])
                step_fn({name: self._views[name] for name in group})
                if inflight_writes:
                    n = self._wait(self._write_handle, "pipelined swap-out")
                    if n < 0:
                        raise OSError(-n, "pipelined swap-out failed")
                    self._release(inflight_writes)
                    inflight_writes = []
                if self.pipeline_write:
                    self._submit_writes(group, handle=self._write_handle)
                    inflight_writes = list(group)
                else:
                    self._write_group_sync(group)
                if self.pipeline_read and i + 1 < len(groups):
                    n = self._wait(self._read_handle, "pipelined swap-in")
                    if n < 0:
                        raise OSError(-n, "pipelined swap-in failed")
            if inflight_writes:
                n = self._wait(self._write_handle, "pipelined swap-out")
                if n < 0:
                    raise OSError(-n, "pipelined swap-out failed")
                self._release(inflight_writes)
        except BaseException:
            self._abort()
            raise

    def _abort(self) -> None:
        """Drain in-flight IO on every handle and release every held buffer
        (the views' swap files may be torn — the error already surfaced).
        Timed-out waits are re-joined FIRST: their IO may still be running
        against buffers this abort is about to hand back to the pool."""
        self._join_stragglers()
        for handle in {id(h): h for h in
                       (self.handle, self._read_handle, self._write_handle)
                       }.values():
            try:
                handle.wait()
            except Exception:  # the original error is what the caller sees
                pass
        self._release(list(self._views))

    # -- helpers ----------------------------------------------------------- #
    def _read_group(self, names: Sequence[str]) -> None:
        self._submit_reads(names, handle=self._read_handle)
        n = self._wait(self._read_handle, "swap-in wait")
        if n < 0:
            raise OSError(-n, "swap-in read failed")

    def _prefetch_group(self, names: Sequence[str]) -> None:
        self._submit_reads(names, handle=self._read_handle)

    def _write_group_sync(self, names: Sequence[str]) -> None:
        self._submit_writes(names, handle=self._write_handle)
        n = self._wait(self._write_handle, "swap-out write")
        if n < 0:
            raise OSError(-n, "swap-out write failed")
        self._release(names)

    def close(self):
        if self._read_handle is not self.handle:
            self._read_handle.close()
        if self._write_handle is not self.handle:
            self._write_handle.close()
        super().close()
