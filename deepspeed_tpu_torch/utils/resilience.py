"""Bounded-retry and timeout primitives for the IO recovery paths (the
JAX package's ``utils/resilience.py``).

The contract every caller here enforces: transient IO failures get a
BOUNDED number of retries with backoff, and anything that survives the
budget SURFACES — nothing is ever swallowed, and nothing is ever retried
forever. The checkpoint writer path (``checkpoint/engine.py``) is the
consumer in the port.

:class:`DeferredCall` is the timeout wrapper for calls that cannot be
interrupted from Python (an AIO ``wait()`` stuck on a dead disk): the call
runs on a daemon thread and ``result(timeout)`` raises :class:`IOTimeout`
while the call keeps running. The caller can later ``result(None)`` to
re-join it (the swapper's abort path does, so pooled buffers are only
recycled after the straggling IO actually retires — a buffer handed back to
the pool while a kernel thread still DMAs into it is silent corruption).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional, Tuple, Type

from deepspeed_tpu_torch.utils.logging import logger


class IOTimeout(TimeoutError):
    """A wrapped call exceeded its deadline (the call may still be running)."""


def retry_call(fn: Callable[[], Any], *, attempts: int = 3,
               backoff_s: float = 0.02, backoff_mult: float = 2.0,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               no_retry_on: Tuple[Type[BaseException], ...] = (),
               describe: str = "", on_retry: Optional[Callable] = None) -> Any:
    """Run ``fn()`` up to ``attempts`` times; sleep ``backoff_s * mult**i``
    between tries. Only ``retry_on`` exceptions are retried — anything else
    (and the last failure) propagates unchanged. ``no_retry_on`` carves
    subclasses back OUT of ``retry_on`` (:class:`IOTimeout` IS an OSError —
    via TimeoutError — but re-running a timed-out call that is still running
    is never the right move). ``on_retry(attempt, exc)`` lets callers count
    retries into their stats."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delay = backoff_s
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if isinstance(e, no_retry_on) or attempt == attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            logger.warning(
                f"retry {attempt}/{attempts - 1} after {type(e).__name__}: {e}"
                + (f" ({describe})" if describe else ""))
            time.sleep(delay)
            delay *= backoff_mult


def call_with_deadline(fn: Callable[[], Any], timeout_s: Optional[float],
                       describe: str = "") -> Any:
    """One-shot deadline wrapper: ``fn()`` inline when ``timeout_s`` is
    None, else through a :class:`DeferredCall` — raising :class:`IOTimeout`
    past the deadline while the call keeps running on its daemon thread.
    The serving router's disaggregated handoff path uses this so a wedged
    decode replica cannot stall a prefill worker unboundedly; callers that
    may retry elsewhere must make the abandoned call's side effects inert
    themselves (the handoff path flags the attempt abandoned before
    retrying against a different replica)."""
    if timeout_s is None:
        return fn()
    return DeferredCall(fn, describe=describe).result(timeout_s)


class DeferredCall:
    """Run ``fn()`` on a daemon thread; join with a deadline.

    ``result(timeout)`` returns the value, re-raises the call's exception,
    or raises :class:`IOTimeout` — in which case the call is STILL RUNNING
    and a later ``result()`` (no deadline) will join it for real. ``done``
    reports completion without blocking."""

    def __init__(self, fn: Callable[[], Any], describe: str = ""):
        self.describe = describe
        self._value: Any = None
        self._exc: Optional[BaseException] = None
        self._finished = threading.Event()

        def runner():
            try:
                self._value = fn()
            except BaseException as e:  # re-raised at result()
                self._exc = e
            finally:
                self._finished.set()

        # deliberately abandonable: a deadline miss leaves the call
        # running on this daemon thread, and a LATER result() may still
        # join it — there is no close() by design
        self._thread = threading.Thread(
            target=runner, daemon=True, name="dstpu-deferred")
        self._thread.start()

    @property
    def done(self) -> bool:
        return self._finished.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._finished.wait(timeout):
            raise IOTimeout(
                f"call did not complete within {timeout}s"
                + (f" ({self.describe})" if self.describe else ""))
        if self._exc is not None:
            raise self._exc
        return self._value
