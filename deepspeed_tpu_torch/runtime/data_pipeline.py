"""The training input pipeline, as the JAX package's
``runtime/data_pipeline.py``: host staging helpers and a prefetching
loader that stages the next batches onto the device from a producer thread::

    producer:  | pull | collate | truncate/PLD | pinned copy, own stream |  ->  queue(N)
    consumer:          | dequeue | wait on the copy's event | step k |

The staging helpers (``as_host_tree``, ``truncate_to_seqlen``,
``inject_pld``, ``stage_tree``) are module functions, so the engine's
synchronous path (``train_pipeline.prefetch = 0``, or an explicit
``train_batch(batch)``) runs the same code the producer runs, and the two
give the same batches bit for bit.

On the card a batch is copied from pinned host memory on a stream of its
own (``stage_tree``); the step's stream waits on an event recorded after
the copy, and each staged tensor is ``record_stream``-ed onto that stream
(``StagedBatch.wait``), so the caching allocator hands its memory out again
only once the step that reads it is done.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.utils.threads import thread_role

#: batch keys the model reads on the host (progressive layer drop's theta
#: and seeds): staged as CPU tensors, never copied to the device
HOST_KEYS = ("pld_theta", "pld_rng")


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_host_tree(batch):
    """Every leaf of a batch tree as a numpy array (collated batches are
    numpy already: no copy; tensors are read to the host)."""
    return _tree_map(_host, batch)


def needs_truncation(batch, seqlen: int) -> bool:
    """True when a rank >= 2 leaf is wider than ``seqlen`` (shapes only)."""
    return any(len(np.shape(x)) >= 2 and np.shape(x)[1] > seqlen for x in _leaves(batch))


def truncate_to_seqlen(batch, seqlen: int):
    """Curriculum-seqlen truncation: rank >= 2 leaves sliced to ``[:,
    :seqlen]`` (numpy views, no copy); the host tree unchanged when no
    leaf is wider."""
    host = as_host_tree(batch)
    if not needs_truncation(host, seqlen):
        return host
    return _tree_map(lambda x: x[:, :seqlen] if x.ndim >= 2 and x.shape[1] > seqlen else x,
                     host)


def inject_pld(batch, leading: int, theta: float, seed: int):
    """Progressive layer drop's inputs put in the batch: ``pld_theta``
    ([leading] f32) and ``pld_rng`` ([leading] int64 seeds, one a row,
    drawn from a ``torch.Generator`` seeded with ``seed``). ``seed`` must
    already be mixed from (base seed, step), so that synchronous and
    prefetched staging draw the same layers for a step, whichever thread
    runs first. The model reads row 0 of its micro-batch."""
    if not isinstance(batch, dict):
        return batch
    batch = dict(batch)
    batch["pld_theta"] = np.full((leading,), theta, np.float32)
    gen = torch.Generator().manual_seed(int(seed))
    batch["pld_rng"] = torch.randint(0, 2 ** 62, (leading,), generator=gen,
                                     dtype=torch.int64).numpy()
    return batch


def stage_tree(tree: Mapping[str, Any], device: torch.device,
               stream: Optional["torch.cuda.Stream"] = None):
    """(device tree, copy event) of a flat host batch: each leaf copied to
    ``device`` (on the card: from pinned memory, on ``stream``, with an
    event recorded after the copies; None elsewhere). ``HOST_KEYS`` stay
    CPU tensors."""
    host = {k: torch.from_numpy(np.ascontiguousarray(x)) for k, x in tree.items()}
    if device.type != "cuda":
        return {k: t if k in HOST_KEYS else t.to(device) for k, t in host.items()}, None
    out = {}
    with torch.cuda.device(device), torch.cuda.stream(stream):
        for k, t in host.items():
            out[k] = t if k in HOST_KEYS else t.pin_memory().to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


@dataclass
class StagedBatch:
    """A device-resident global batch staged for step ``step``.

    ``tree`` is the flat dict of tensors ``train_batch`` steps on; ``raw``
    keeps the original host batch (before truncation and PLD) for
    restaging when the step counter moved outside the pipeline; ``ready``
    is the copy's event on the card."""

    tree: Any
    step: int
    raw: Any = None
    ready: Any = None

    def wait(self) -> Dict[str, torch.Tensor]:
        """The tree, once the current stream waits on the copy (and each
        staged tensor is recorded as used there)."""
        cuda = [t for t in self.tree.values() if t.is_cuda]
        if self.ready is not None and cuda:
            cur = torch.cuda.current_stream(cuda[0].device)
            cur.wait_event(self.ready)
            for t in cuda:
                t.record_stream(cur)
        self.ready = None
        return self.tree


class _Item:
    """Queue envelope: exactly one of batch / exc / end is set."""

    __slots__ = ("batch", "exc", "end")

    def __init__(self, batch=None, exc=None, end=False):
        self.batch = batch
        self.exc = exc
        self.end = end


class PrefetchLoader:
    """A producer thread staging the next ``prefetch`` prepared batches.

    Wraps any iterable of host batches. ``prepare(batch, step)`` is the
    staging hook (the engine's ``_prepare_batch``); ``step`` counts
    consumed batches from ``start_step``, so schedule-dependent staging is
    computed for the step the batch is TRAINED at.

    - ``prefetch >= 1``: a daemon thread fills a bounded queue (2 is double
      buffering: one batch on the device, one staged behind it);
    - ``prefetch = 0``: no thread, ``prepare`` runs inline on ``__next__``
      (the same code, the same results).

    An exception of the loader or of ``prepare`` re-raises on the consumer
    at the ``__next__`` that would have returned the failed batch; a finite
    loader ends with ``StopIteration``; ``close()`` stops the producer
    without consuming the rest.
    """

    def __init__(self, loader: Iterable, prepare: Optional[Callable] = None,
                 prefetch: int = 2, start_step: int = 0):
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.loader = loader
        self.prepare = prepare or (lambda batch, step: batch)
        self.prefetch = int(prefetch)
        # stepped by the consumer inline (prefetch 0) or by the producer
        # thread: the two paths never run together
        self._next_step = int(start_step)
        self._iter = None
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self.prefetch == 0:
            if self._iter is None:
                self._iter = iter(self.loader)
            batch = next(self._iter)
            staged = self.prepare(batch, self._next_step)
            self._next_step += 1
            return staged
        self._ensure_started()
        item = self._queue.get()
        if item.end:
            self._closed = True
            raise StopIteration
        if item.exc is not None:
            self.close()
            raise item.exc
        return item.batch

    def __len__(self):
        return len(self.loader)

    def __bool__(self):
        # truthiness would otherwise call __len__, which a RepeatingLoader lacks
        return True

    @property
    def depth(self) -> int:
        """Staged batches waiting in the queue (an empty queue a step means
        the producer, not the device, sets the pace)."""
        return self._queue.qsize() if self._queue is not None else 0

    def _ensure_started(self):
        if self._thread is not None:
            return
        self._queue = queue.Queue(maxsize=self.prefetch)
        self._thread = threading.Thread(target=self._produce, name="dstpu-prefetch",
                                        daemon=True)
        self._thread.start()

    @thread_role("dstpu-prefetch")
    def _produce(self):
        try:
            for batch in self.loader:
                if self._stop.is_set():
                    return
                # the producer's staging on its own timeline track (thread
                # 'dstpu-prefetch'), beside the consumer's train/step spans
                with _tracer.span("train/prefetch/stage", step=self._next_step):
                    staged = self.prepare(batch, self._next_step)
                self._next_step += 1
                if not self._put(_Item(batch=staged)):
                    return
            self._put(_Item(end=True))
        except BaseException as exc:  # surfaces on the consumer
            self._put(_Item(exc=exc))

    def _put(self, item: _Item) -> bool:
        """Bounded put that stays responsive to ``close()``."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def close(self):
        """Stop the producer and drop staged batches. Idempotent; called by
        ``engine.destroy()`` and on checkpoint load (a restored step counter
        invalidates schedule-dependent staging)."""
        self._closed = True
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)
