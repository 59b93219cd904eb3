"""Named concurrency primitives + thread-role declarations (the JAX
package's ``utils/threads.py``, without its lock-order sanitizer).

The checkpoint committer and writer threads build their locks through the
factories here with a dotted name, so each lock keeps the identity the JAX
package gives it::

    self._lock = make_lock("checkpoint.async.inflight")

The factories return plain ``threading`` primitives; the name is for
readers. :func:`thread_role` declares which long-lived thread runs a
function (the decorator only attaches an attribute)::

    @thread_role("dstpu-ckpt-commit")
    def _commit_loop(self): ...
"""

from __future__ import annotations

import threading

__all__ = ["thread_role", "make_lock", "make_rlock", "make_semaphore"]


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
    """A ``threading.Lock`` under a stable dotted name."""
    return threading.Lock()


def make_semaphore(name: str, value: int = 1) -> threading.Semaphore:
    """A counting semaphore under a stable dotted name."""
    return threading.Semaphore(value)


def make_rlock(name: str) -> threading.RLock:
    """A ``threading.RLock`` under a stable dotted name."""
    return threading.RLock()
