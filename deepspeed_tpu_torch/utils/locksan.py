"""Runtime lock-order sanitizer (the JAX package's ``utils/locksan.py``).

Armed by ``DSTPU_LOCKSAN=1`` (or :func:`arm` in tests), every lock built
through ``utils/threads.make_lock``/``make_rlock`` becomes a
:class:`SanLock` proxy that records, per thread, the stack of held lock
NAMES and grows a global acquisition graph: taking ``B`` while holding
``A`` adds the edge ``A -> B``. At ``report()`` time the graph is checked
for cycles: a cycle is a potential deadlock two threads can interleave
into even if this run never did.

Two more signals ride along:

- **held-lock blocking**: the policed device-to-host drains (and anything
  else that calls :func:`note_blocking`) record when a blocking call runs
  with locks held.
- **static cross-check**: :func:`check_static` returns the observed edges
  a static lock graph did not predict.

Only locks built after :func:`arm` are proxies: a lock built at import
(``checkpoint.latest``, the kernel loader's) stays a plain lock.

Everything here is process-global on purpose: lock ordering is a
whole-process property. ``reset()`` clears the tables.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["enabled", "arm", "disarm", "reset", "SanLock", "SanSemaphore",
           "note_blocking", "held_locks", "edges", "blocking_events",
           "find_cycles", "report", "check_static"]

_armed: Optional[bool] = None          # tri-state: None = read the env
_tables = threading.Lock()             # guards the global tables below
_edges: Dict[Tuple[str, str], str] = {}     # (held, acquired) -> thread name
_blocking: List[Tuple[Tuple[str, ...], str, str]] = []  # (held, what, thread)
_tls = threading.local()               # .stack: per-thread held-name list


def enabled() -> bool:
    """Is the sanitizer armed? Resolved once from ``DSTPU_LOCKSAN`` unless
    :func:`arm`/:func:`disarm` forced it."""
    global _armed
    if _armed is None:
        _armed = os.environ.get("DSTPU_LOCKSAN", "") not in ("", "0")
    return _armed


def arm() -> None:
    """Force the sanitizer on; clears recorded state."""
    global _armed
    _armed = True
    reset()


def disarm() -> None:
    """Force the sanitizer off; clears recorded state. Locks already built
    as proxies keep working — they just stop mattering to new factories."""
    global _armed
    _armed = False
    reset()


def reset() -> None:
    with _tables:
        _edges.clear()
        del _blocking[:]


def _stack() -> List[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def held_locks() -> Tuple[str, ...]:
    """Names of sanitized locks the CURRENT thread holds, outermost first."""
    return tuple(_stack())


def _note_acquired(name: str) -> None:
    stack = _stack()
    holding = [h for h in dict.fromkeys(stack) if h != name]
    if holding:
        thread = threading.current_thread().name
        with _tables:
            for h in holding:
                _edges.setdefault((h, name), thread)
    stack.append(name)


def _note_released(name: str) -> None:
    stack = _stack()
    # innermost matching entry: releases may interleave for RLocks and
    # hand-over-hand patterns
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == name:
            del stack[i]
            return


def note_blocking(what: str) -> None:
    """Record a blocking call (``fetch_to_host``, an AIO wait, ...) made
    while sanitized locks are held — the runtime TL002 signal. Cheap no-op
    when nothing is held."""
    held = held_locks()
    if not held:
        return
    with _tables:
        _blocking.append((held, what, threading.current_thread().name))


class SanLock:
    """Order-recording proxy over a ``threading.Lock``/``RLock``.

    Same surface the stack uses (``acquire``/``release``/context manager/
    ``locked``); records the acquisition graph on the way through. A
    reentrant re-acquire records no edge (holding A under A is not an
    ordering)."""

    def __init__(self, name: str, inner, reentrant: bool = False):
        self.name = name
        self._inner = inner
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquired(self.name)
        return got

    def release(self) -> None:
        _note_released(self.name)
        self._inner.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return locked() if locked is not None else False

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"SanLock({self.name!r})"


class SanSemaphore:
    """Semaphore proxy: a blocked-or-not WAIT, not a held lock. Acquiring
    one with locks held is recorded as a blocking event (its release may
    depend on another thread making progress — the committer-backpressure
    shape), but the semaphore itself never enters the held stack."""

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: Optional[float] = None) -> bool:
        if blocking:
            note_blocking(f"semaphore:{self.name}")
        return self._inner.acquire(blocking, timeout)

    def release(self, n: int = 1) -> None:
        self._inner.release(n)

    def __enter__(self) -> "SanSemaphore":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"SanSemaphore({self.name!r})"


# --------------------------------------------------------------------------- #
# reporting
# --------------------------------------------------------------------------- #

def edges() -> Set[Tuple[str, str]]:
    with _tables:
        return set(_edges)


def blocking_events() -> List[Tuple[Tuple[str, ...], str, str]]:
    with _tables:
        return list(_blocking)


def find_cycles(edge_set: Optional[Set[Tuple[str, str]]] = None) -> List[List[str]]:
    """Elementary cycles in the acquisition graph (DFS back-edge walk; the
    graphs here are a handful of nodes). Each cycle is a name list with the
    start repeated last: ``["a", "b", "a"]``."""
    es = edges() if edge_set is None else edge_set
    adj: Dict[str, List[str]] = {}
    for a, b in es:
        adj.setdefault(a, []).append(b)
    cycles: List[List[str]] = []
    seen_keys: Set[Tuple[str, ...]] = set()

    def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
        for nxt in adj.get(node, ()):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                # canonicalize rotation so each cycle reports once
                body = cyc[:-1]
                i = body.index(min(body))
                key = tuple(body[i:] + body[:i])
                if key not in seen_keys:
                    seen_keys.add(key)
                    cycles.append(list(key) + [key[0]])
            else:
                dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(adj):
        dfs(start, [start], {start})
    return cycles


def report() -> dict:
    """Snapshot of everything recorded: the edge list (with the acquiring
    thread), blocking-under-lock events, and any cycles."""
    with _tables:
        edge_rows = [{"from": a, "to": b, "thread": t}
                     for (a, b), t in sorted(_edges.items())]
        blocking_rows = [{"held": list(held), "call": what, "thread": t}
                         for held, what, t in _blocking]
    return {"armed": bool(enabled()), "edges": edge_rows,
            "blocking": blocking_rows, "cycles": find_cycles()}


def check_static(static_edges: Set[Tuple[str, str]]) -> Set[Tuple[str, str]]:
    """Observed edges the static analyzer did NOT predict (empty = the
    static graph is a superset)."""
    return edges() - set(static_edges)
