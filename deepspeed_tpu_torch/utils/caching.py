"""Shape bucketing and a bounded LRU cache for the serving and kernel paths.

:func:`next_pow2` is the canonical shape-bucketing function: every count-keyed
decode dimension (live decode rows, sampler rows) rounds the count up to a
power of two first, so the set of distinct shapes is log-sized instead of
linear in the count.

:class:`LRUCache` bounds host-built tables kept per key (block-sparse layout
tables): a long-lived process that sees many distinct keys evicts the least
recently used instead of holding them all.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Generic, Hashable, TypeVar

V = TypeVar("V")


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n``, with ``next_pow2(0) == 1``.

    Zero maps to 1 because every padded batch needs at least one row."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


class LRUCache(Generic[V]):
    def __init__(self, maxsize: int):
        assert maxsize > 0
        self.maxsize = maxsize
        self._d: "OrderedDict[Hashable, V]" = OrderedDict()
        # The cache-wide lock only guards the dict; factories run under a
        # per-key lock so two threads racing the SAME cold key share one
        # build while hits and other keys never block behind it.
        self._lock = threading.Lock()
        self._key_locks: dict = {}

    def get_or_create(self, key: Hashable, factory: Callable[[], V]) -> V:
        with self._lock:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
                return hit
            klock = self._key_locks.setdefault(key, threading.Lock())
        with klock:
            with self._lock:  # a racer may have built it while we waited
                hit = self._d.get(key)
            if hit is None:
                hit = factory()
            with self._lock:
                self._d[key] = hit
                self._d.move_to_end(key)
                while len(self._d) > self.maxsize:
                    self._d.popitem(last=False)
                self._key_locks.pop(key, None)
            return hit

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d
