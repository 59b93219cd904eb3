"""Pluggable checkpoint engines, sync and async (the JAX package's
``checkpoint/engine.py``).

``CheckpointEngine`` (create/save/load/commit) with
``NativeCheckpointEngine`` (synchronous) and ``AsyncCheckpointEngine``: a
host thread pool where ``save`` queues the file write and ``commit(tag)``
drains the queue before the ``latest`` tag flips, so a crash mid-save never
leaves a ``latest`` pointing at a torn checkpoint. Writers touch numpy
arrays only, never a CUDA tensor: the snapshot hands them fresh host
copies, and each writer computes its file's crc32 table itself.

Failure discipline: every writer runs under bounded retry-with-backoff
(``writer_retries`` / ``writer_backoff_s`` config keys — transient IO
failures recover, persistent ones SURFACE at ``commit``), the write path
carries the ``ckpt.writer`` / ``ckpt.stall`` fault-injection sites, and the
async engine registers an atexit flush so in-flight writers finish before
interpreter teardown even when ``engine.destroy()`` was never called.
"""

from __future__ import annotations

import atexit
import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.utils import fault_injection
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.resilience import retry_call
from deepspeed_tpu_torch.utils.threads import make_lock


class CheckpointEngine:
    """The engine surface: create/save/load/commit."""

    def __init__(self, config_params: Optional[dict] = None):
        self.config_params = config_params
        cp = config_params or {}
        # bounded retry budget for one file write (1 = no retries)
        self.writer_attempts = 1 + max(0, int(cp.get("writer_retries", 2)))
        self.writer_backoff_s = float(cp.get("writer_backoff_s", 0.05))
        #: total writer retries taken (CheckpointStats feeds on this)
        self.retries = 0
        # path -> per-array crc32 of the state_dict the writer was GIVEN,
        # recorded by _write (the writer thread for the async engine — the
        # O(state-bytes) checksum scan never runs on the step loop) and
        # collected by commit_checkpoint via take_checksums
        self._checksums: Dict[str, Dict[str, int]] = {}
        self._ck_lock = make_lock("checkpoint.checksum")

    def create(self, tag: str) -> None:
        """Start a checkpoint under ``tag`` (bookkeeping only)."""

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        os.makedirs(path, exist_ok=exist_ok)

    def _write(self, path: str, state_dict: Dict[str, np.ndarray]) -> None:
        """One file write under the bounded-retry policy; the retry budget
        exhausting re-raises the last failure (never swallowed). Records the
        crc32 table of the handed-in arrays for the tag manifest."""
        def bump(attempt, exc):
            self.retries += 1

        from deepspeed_tpu_torch.checkpoint.state import checksum_flat
        # one span per file write on the WRITER's track (the 'ckpt-writer'
        # threads of the async engine; the caller's otherwise)
        with _tracer.span("ckpt/write", file=os.path.basename(path)):
            crc = checksum_flat(state_dict)
            retry_call(lambda: _atomic_savez(path, state_dict),
                       attempts=self.writer_attempts,
                       backoff_s=self.writer_backoff_s,
                       retry_on=(OSError,), describe=f"checkpoint write {path}",
                       on_retry=bump)
        with self._ck_lock:
            self._checksums[path] = crc

    def take_checksums(self, path: str) -> Dict[str, int]:
        """Pop the crc32 table a completed write recorded for ``path``
        (commit_checkpoint calls this AFTER the commit barrier, so a present
        table is guaranteed for every successfully committed save)."""
        with self._ck_lock:
            return self._checksums.pop(path)

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        """Write ``state_dict`` to ``path``. Ownership passes to the engine:
        the caller does not mutate the arrays until ``commit`` returns
        (``save_engine_checkpoint`` hands over the snapshot's fresh host
        copies, so no engine copies them again)."""
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Dict[str, np.ndarray]:
        """Loads route through the engine too, so a non-filesystem engine
        can serve both directions."""
        return dict(np.load(path, allow_pickle=False))

    def commit(self, tag: str) -> bool:
        """All saves for ``tag`` are durable once this returns True."""
        return True

    def queue_depth(self) -> int:
        """Writes queued but not yet durable (0 for synchronous engines)."""
        return 0


class NativeCheckpointEngine(CheckpointEngine):
    """Synchronous writes."""

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        self._write(path, state_dict)


class AsyncCheckpointEngine(CheckpointEngine):
    """Background-thread writes with a commit barrier."""

    def __init__(self, config_params: Optional[dict] = None, max_workers: int = 2):
        super().__init__(config_params)
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="ckpt-writer")
        # tag -> queued futures; saves issued outside a create(tag) scope
        # land under None and drain at ANY commit (back-compat with direct
        # save()/commit() callers). Tag scoping matters for ROLLING saves:
        # tag k+1's writes may queue while tag k commits on the committer
        # thread, and k's commit must neither wait on nor consume k+1's
        # results (a k+1 write failure must surface at k+1's commit, not
        # vanish into k's).
        self._inflight: Dict[Optional[str], List[Future]] = {}
        self._cur_tag: Optional[str] = None
        self._lock = make_lock("checkpoint.async.inflight")
        self._closed = False
        # Process exit must not abandon queued writers: a "completed" save
        # whose bytes never hit disk is the silent-corruption case the
        # commit barrier exists to prevent. engine.destroy() closes us
        # explicitly; this is the safety net for everything else.
        atexit.register(self._atexit_flush)

    def create(self, tag: str) -> None:
        with self._lock:
            self._cur_tag = tag
            self._inflight.setdefault(tag, [])

    def save(self, state_dict: Dict[str, np.ndarray], path: str) -> None:
        """Queue the write. The arrays are the engine's until commit; a
        second copy here would transiently double host RAM on multi-GB
        states."""
        fut = self._pool.submit(self._write, path, state_dict)
        with self._lock:
            self._inflight.setdefault(self._cur_tag, []).append(fut)

    def commit(self, tag: str) -> bool:
        with self._lock:
            pending = self._inflight.pop(tag, [])
            pending += self._inflight.pop(None, [])
            if self._cur_tag == tag:
                # the create() scope ends here: a later bare save() must
                # land under None (drained at ANY commit), not file under a
                # committed tag whose bucket no future commit will pop
                self._cur_tag = None
        errs = []
        for fut in pending:
            try:
                fut.result()
            except Exception as e:  # surface the first writer failure
                errs.append(e)
        if errs:
            raise errs[0]
        return True

    def queue_depth(self) -> int:
        with self._lock:
            return sum(1 for futs in self._inflight.values()
                       for f in futs if not f.done())

    def close(self):
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self._atexit_flush)
        try:
            with self._lock:
                tags = list(self._inflight)
            errs = []
            for tag in tags:
                try:
                    self.commit(tag if tag is not None else "close")
                except Exception as e:
                    errs.append(e)
            if errs:
                raise errs[0]
        finally:
            self._pool.shutdown(wait=True)

    def _atexit_flush(self):
        """Interpreter-teardown flush: drain the writers, but never raise —
        an exception here would mask the process's real exit status."""
        try:
            self.close()
        except Exception as e:  # pragma: no cover - depends on failing writer
            logger.warning(f"async checkpoint engine: writer failed during "
                           f"atexit flush: {type(e).__name__}: {e}")


def _atomic_savez(path: str, state_dict: Dict[str, np.ndarray]) -> None:
    """Write-then-rename so readers never observe a torn file; a writer
    exception (disk full, bad array) must never leave a ``.tmp`` behind —
    a later save's rename would otherwise race a stale partial file."""
    fault_injection.maybe_fail("ckpt.writer")   # crash-before-write
    tmp = path + ".tmp"
    try:
        np.savez(tmp, **state_dict)
        fault_injection.maybe_fail("ckpt.stall")   # slow writer / slow disk
        # np.savez appends .npz to names without it
        if not tmp.endswith(".npz") and os.path.exists(tmp + ".npz"):
            tmp = tmp + ".npz"
        os.replace(tmp, path)
    finally:
        for leftover in (tmp, tmp + ".npz"):
            if os.path.exists(leftover):
                try:
                    os.remove(leftover)
                except OSError:
                    pass


def build_checkpoint_engine(name: str, config_params: Optional[dict] = None
                            ) -> CheckpointEngine:
    """Engine selection from the ``checkpoint`` config block
    (``{"checkpoint": {"engine": "async", "writers": N}}`` in the JSON
    config reaches here through the training engine's
    ``_checkpoint_engine``)."""
    key = (name or "native").lower()
    if key in ("native", "torch", "sync"):
        return NativeCheckpointEngine(config_params)
    if key in ("async", "nebula"):
        workers = int((config_params or {}).get("writers", 2) or 2)
        return AsyncCheckpointEngine(config_params, max_workers=workers)
    raise ValueError(f"unknown checkpoint engine '{name}' (native|async)")
