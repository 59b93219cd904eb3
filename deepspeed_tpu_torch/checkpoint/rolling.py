"""Rolling async checkpoints: continuous saves on a step cadence (the JAX
package's ``checkpoint/rolling.py``).

A run on preemptible capacity is only as durable as its newest COMPLETE
checkpoint, so the engine snapshots every ``rolling.every_n_steps`` global
steps and keeps writing while training continues. Division of labor per
save:

- **snapshot** (caller's thread, the step loop): flush the deferred metric
  queue (a checkpoint boundary must not leave step k-1's metrics stranded)
  and materialise the state flats host-side in ONE policed drain
  (the engine's ``checkpoint_flats``, shared with user saves).
- **write** (checkpoint-engine writer threads, async engine): the npz
  writes, queued.
- **commit** (the single FIFO committer thread owned here): writer drain ->
  manifest -> atomic ``latest`` flip -> retention pruning, strictly in that
  order and strictly in TAG order — one committer means a slow older tag
  can never have its ``latest`` flip land after a newer tag's and roll the
  resume point backwards.

Backpressure is the part that keeps this honest: at most
``rolling.max_pending`` snapshots may be queued-but-uncommitted; the next
save BLOCKS until the committer catches up (time charged to
``train/ckpt/backpressure_ms_per_save``), so a disk slower than the cadence
degrades into a slower cadence — never into unbounded host-memory growth.

The committer touches host arrays and files only, never a CUDA tensor.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
import time
from typing import List, Optional, TYPE_CHECKING

from deepspeed_tpu_torch.checkpoint.state import (commit_checkpoint,
                                                  read_latest_tag,
                                                  write_checkpoint_files)
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.threads import make_semaphore, thread_role

if TYPE_CHECKING:  # pragma: no cover - typing only
    from deepspeed_tpu_torch.config import RollingCheckpointConfig


class RollingCheckpointer:
    """Owns the cadence, the committer thread, and retention for one engine.

    Built by the training engine when ``config.checkpoint.rolling`` is
    enabled; ``maybe_save()`` is called from ``_after_step`` (the counters
    are already bumped, so a tag named ``rolling_step{N}`` holds the state
    after step N — a resume from it continues with global_steps == N).
    """

    def __init__(self, engine, cfg: "RollingCheckpointConfig", stats=None):
        if cfg.every_n_steps > 0 and not cfg.save_dir:
            from deepspeed_tpu_torch.config import ConfigError
            raise ConfigError(
                "checkpoint.rolling.every_n_steps is set but "
                "checkpoint.rolling.save_dir is empty")
        self.engine = engine
        self.cfg = cfg
        self.stats = stats
        self.saves = 0
        # FIFO commit lane: (tag, files) jobs. Backpressure is enforced
        # by the semaphore, NOT queue maxsize: a job the committer has
        # get()'d is out of the queue but still uncommitted, so queue size
        # alone under-counts pending work by one
        self._jobs: queue.Queue = queue.Queue()
        self._pending = make_semaphore("checkpoint.rolling.pending",
                                       max(1, int(cfg.max_pending)))
        self._commit_errs: List[BaseException] = []
        self._committer: Optional[threading.Thread] = None
        self._closed = False

    # ------------------------------------------------------------------ #
    # cadence
    # ------------------------------------------------------------------ #

    def maybe_save(self) -> bool:
        every = self.cfg.every_n_steps
        if every <= 0 or self.engine.global_steps % every != 0:
            return False
        self.save()
        return True

    def save(self) -> str:
        """One rolling save; returns the tag. A PREVIOUS save's commit
        failure raises here (bounded lag means at most ``max_pending``
        snapshots ride an error window — and the error is never swallowed)."""
        perf = time.perf_counter
        engine = self.engine
        tag = f"{self.cfg.tag_prefix}{engine.global_steps}"

        # checkpoint boundary: step k-1's deferred metrics must land before
        # the snapshot (same contract as save_checkpoint)
        engine.drain_metrics()
        t0 = perf()
        # (an offload engine's snapshot drains its host step and adds the
        # host-flow master and moments under the same flat keys)
        model_flat, optim_flat = engine.checkpoint_flats()
        t1 = perf()
        client_state = {
            "global_steps": engine.global_steps,
            "global_samples": engine.global_samples,
            "micro_steps": engine.micro_steps,
            "skipped_steps": engine.get_skipped_steps(),
            "rolling": True,
        }

        cke = engine._checkpoint_engine()
        files = write_checkpoint_files(cke, self.cfg.save_dir, tag,
                                       model_flat, optim_flat, client_state)
        t_write = perf()
        self._ensure_committer()
        # backpressure: blocks while max_pending snapshots are queued OR in
        # the committer's hands — uncommitted work is bounded either way.
        # Clocked from HERE, not from the snapshot: write_checkpoint_files
        # is submission time (the full npz write on a sync engine), and
        # charging it to backpressure_ms would read as committer contention
        # on every save
        t_acq = perf()
        # the permit transfers WITH the job: the committer releases it when
        # the commit lands (or fails) — hence no release on the success
        # path here. But a put() that raises (teardown race: Queue
        # subclassed/closed) must hand the permit back, or every failed
        # save leaks backpressure budget until save() wedges permanently.
        self._pending.acquire()
        try:
            self._jobs.put((tag, files))
        except BaseException:
            self._pending.release()
            raise
        t2 = perf()
        self._raise_commit_errors()
        if self.stats is not None:
            self.stats.record_save(snapshot_s=t1 - t0, write_s=t_write - t1,
                                   backpressure_s=t2 - t_acq,
                                   queue_depth=cke.queue_depth())
            self.stats.retries = cke.retries
        if _tracer.enabled:
            # the step loop's view of this save, from the same stamps as the
            # stats: the snapshot (the only phase on the critical path under
            # the async engine) and any committer backpressure
            _tracer.add("ckpt/snapshot", t0, t1, lane="ckpt", tag=tag)
            _tracer.add("ckpt/backpressure", t_acq, t2, lane="ckpt", tag=tag)
            _tracer.counter("ckpt/writer_queue_depth", cke.queue_depth(), lane="ckpt")
        self.saves += 1
        return tag

    # ------------------------------------------------------------------ #
    # committer
    # ------------------------------------------------------------------ #

    def _ensure_committer(self):
        if self._committer is not None and self._committer.is_alive():
            return
        self._committer = threading.Thread(target=self._commit_loop,
                                           name="dstpu-ckpt-commit",
                                           daemon=True)
        self._committer.start()

    @thread_role("dstpu-ckpt-commit")
    def _commit_loop(self):
        while True:
            job = self._jobs.get()
            if job is None:   # close() sentinel
                # account the sentinel, or a committer restarted by a
                # post-close save() leaves join() waiting on it forever
                self._jobs.task_done()
                return
            tag, files = job
            start = time.perf_counter()
            try:
                cke = self.engine._checkpoint_engine()
                # monotonic: an inline user save may have flipped `latest`
                # to a NEWER step while this tag waited in the queue — the
                # background commit must never roll the resume point back
                commit_checkpoint(cke, self.cfg.save_dir, tag, files,
                                  save_latest=True, monotonic=True)
                t_commit = time.perf_counter()
                pruned = self._prune(committed=tag)
                end = time.perf_counter()
                if self.stats is not None:
                    # host-only IO timing: the committer never touches device
                    # tensors, so there is no device work to sync before the clock
                    self.stats.record_commit(commit_s=end - start, pruned=pruned)
                    self.stats.retries = cke.retries
                if _tracer.enabled:
                    _tracer.add("ckpt/commit", start, t_commit, tag=tag)
                    _tracer.add("ckpt/prune", t_commit, end, pruned=pruned)
            except BaseException as e:
                logger.warning(f"rolling checkpoint '{tag}' commit failed: "
                               f"{type(e).__name__}: {e}")
                self._commit_errs.append(e)
            finally:
                self._pending.release()
                self._jobs.task_done()

    def _raise_commit_errors(self):
        if self._commit_errs:
            errs, self._commit_errs = self._commit_errs, []
            raise errs[0]

    def _prune(self, committed: str) -> int:
        """Delete rolling tags beyond ``keep_last``, newest-first by step.
        Only tags at or below the just-committed step are candidates: commits
        run FIFO in tag order, so anything newer on disk is a QUEUED save
        whose files are still being written — deleting it would tear an
        in-flight checkpoint. The tag ``latest`` currently names is never
        deleted (a reader may be mid-follow), nor are non-rolling (user)
        tags."""
        prefix = self.cfg.tag_prefix
        save_dir = self.cfg.save_dir
        committed_step = int(committed[len(prefix):]) \
            if committed[len(prefix):].isdigit() else -1
        try:
            entries = os.listdir(save_dir)
        except OSError:
            return 0
        tags = []
        for d in entries:
            if not d.startswith(prefix):
                continue
            suffix = d[len(prefix):]
            if suffix.isdigit() and int(suffix) <= committed_step \
                    and os.path.isdir(os.path.join(save_dir, d)):
                tags.append((int(suffix), d))
        tags.sort(reverse=True)
        latest = read_latest_tag(save_dir)
        pruned = 0
        for _, tag in tags[max(1, int(self.cfg.keep_last)):]:
            if tag == latest:
                continue
            try:
                shutil.rmtree(os.path.join(save_dir, tag))
                pruned += 1
            except OSError as e:
                logger.warning(f"rolling prune of '{tag}' failed: {e}")
        return pruned

    # ------------------------------------------------------------------ #
    # shutdown
    # ------------------------------------------------------------------ #

    def flush(self):
        """Block until every queued commit has run; surfaces commit errors."""
        if self._committer is not None and self._committer.is_alive():
            self._jobs.join()
        self._raise_commit_errors()

    def close(self):
        """Flush, then stop the committer. Idempotent; called from
        ``engine.destroy()`` BEFORE the checkpoint engine closes (commits
        need live writers). The committer stops even when the flush surfaces
        a commit error — a raising close must not leave a live thread that
        can still flip ``latest`` behind the caller's back."""
        if self._closed:
            self.flush()
            return
        self._closed = True
        try:
            self.flush()
        finally:
            if self._committer is not None and self._committer.is_alive():
                self._jobs.put(None)
                self._committer.join(timeout=30.0)
            self._committer = None
