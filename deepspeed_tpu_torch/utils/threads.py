"""Named concurrency primitives + thread-role declarations (the JAX
package's ``utils/threads.py``).

The multi-threaded paths (serving loops, the health monitor, the prefetch
producer, the offload lanes, checkpoint committer and writers, the
telemetry pump) build their locks through the factories here with a dotted
name, so each lock keeps the identity the JAX package gives it::

    self._lock = make_lock("checkpoint.async.inflight")

- Normally ``make_lock`` returns a plain ``threading.Lock``: no overhead.
- Under ``DSTPU_LOCKSAN=1`` (or ``utils.locksan.arm()``) it returns an
  order-recording :class:`~deepspeed_tpu_torch.utils.locksan.SanLock`
  proxy carrying the same name, so the runtime acquisition graph speaks in
  these names.

Names are lockdep-style CLASSES, not instances: every per-key lock minted
by ``utils/caching.py`` shares one name.

:func:`thread_role` declares which long-lived thread runs a function (the
decorator only attaches an attribute)::

    @thread_role("dstpu-ckpt-commit")
    def _commit_loop(self): ...
"""

from __future__ import annotations

import threading

from deepspeed_tpu_torch.utils import locksan

__all__ = ["thread_role", "make_lock", "make_rlock", "make_semaphore",
           "make_condition"]


def thread_role(name: str):
    """Declare that the decorated function is the entry point of the
    ``name`` thread role (e.g. ``"dstpu-ckpt-commit"``). Purely
    declarative: the attribute names the thread for readers and lint
    tools."""
    def deco(fn):
        fn.__thread_role__ = name
        return fn
    return deco


def make_lock(name: str) -> threading.Lock:
    """A ``threading.Lock`` under a stable dotted name. With locksan armed
    the lock is wrapped in an order-recording proxy."""
    lock = threading.Lock()
    if locksan.enabled():
        return locksan.SanLock(name, lock)
    return lock


def make_rlock(name: str) -> threading.RLock:
    """Reentrant variant of :func:`make_lock`."""
    lock = threading.RLock()
    if locksan.enabled():
        return locksan.SanLock(name, lock, reentrant=True)
    return lock


def make_semaphore(name: str, value: int = 1) -> threading.Semaphore:
    """A counting semaphore under a stable name. Semaphores are WAITED on,
    not lock-ordered (a release may come from another thread), so locksan
    records them only as blocking sites, never as held locks."""
    sem = threading.Semaphore(value)
    if locksan.enabled():
        return locksan.SanSemaphore(name, sem)
    return sem


def make_condition(name: str, lock=None) -> threading.Condition:
    """A condition variable over a (named) lock."""
    return threading.Condition(lock)
