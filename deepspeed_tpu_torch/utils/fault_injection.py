"""Deterministic fault injection (the JAX package's
``utils/fault_injection.py``), for the robustness paths of the port.

Every **site** (a string like ``"serve.lora_fault"``) keeps its own hit
counter; a :class:`FaultSpec` fires at an exact hit index (``at``), on a
cadence (``every``), or with a seeded per-hit probability (``p``, keyed by
``(seed, site, hit)``, so the same plan and seed fail the same hits). The
**action** is ``raise`` (an :class:`InjectedFault`), ``errno`` (a negative
errno for return-code sites), ``stall`` (sleep ``delay_s``, then proceed)
or ``kill`` (``os._exit(KILL_EXIT_CODE)``).

Nothing is installed by default and :func:`maybe_fail` is a no-op while
inactive. A plan comes from :func:`parse_plan` (grammar
``site:key=val:key=val;site2:...``, e.g. ``"serve.lora_fault:at=1"``) and
is armed with :func:`install`. The JAX package's environment arming
(``DSTPU_FAULTS``) and its return-code sites (``maybe_rc``, the AIO
surface) wait for the port's callers of them.

Sites in the port:

========================  ===================================================
``serve.lora_fault``      ``LoraAdapterRegistry._ensure_resident``: inside an
                          adapter fault-in, after its pages are allocated and
                          before the scatter lands (cancel-while-faulting
                          rolls refcounts, bindings and free pages back).
========================  ===================================================

The JAX package's flight recorder (a tracer dump before a fault surfaces)
waits for the port's tracer.
"""

from __future__ import annotations

import errno as _errno
import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

logger = logging.getLogger("deepspeed_tpu_torch")

#: exit status of an injected ``action=kill``, told apart from a crash
KILL_EXIT_CODE = 17


class InjectedFault(OSError):
    """The exception an ``action=raise`` site surfaces. An OSError, so
    IO-shaped retry policies treat injected and real IO failures alike."""


@dataclass
class FaultSpec:
    """When and how one site fails. ``at`` is 1-based (the Nth hit);
    ``every`` fires on hits that are multiples of it; ``p`` is a seeded
    per-hit probability. Triggers OR together; ``max_fires`` bounds the
    firings (0 = unbounded)."""

    site: str
    at: int = 0
    every: int = 0
    p: float = 0.0
    action: str = "raise"          # raise | errno | stall | kill
    errno: int = _errno.EIO
    delay_s: float = 0.2
    max_fires: int = 0
    fires: int = 0

    def should_fire(self, hit: int, seed: int) -> bool:
        if self.max_fires and self.fires >= self.max_fires:
            return False
        if self.at and hit == self.at:
            return True
        if self.every and hit % self.every == 0:
            return True
        if self.p > 0.0:
            # keyed, not sequential: the decision for (site, hit) does not
            # depend on how many other sites drew before it
            return random.Random(f"{seed}:{self.site}:{hit}").random() < self.p
        return False


class FaultInjector:
    """The active plan and the per-site hit counters (thread-safe)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.seed = int(seed)
        self._specs: Dict[str, List[FaultSpec]] = {}
        for s in specs:
            self._specs.setdefault(s.site, []).append(s)
        self._hits: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: (site, hit, action) of every firing, for assertions
        self.fired: List[tuple] = []

    def hit(self, site: str) -> Optional[FaultSpec]:
        """Count a hit at ``site``; return the spec to execute, if any."""
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            for spec in self._specs.get(site, ()):
                if spec.should_fire(n, self.seed):
                    spec.fires += 1
                    self.fired.append((site, n, spec.action))
                    return spec
        return None

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)


_active: Optional[FaultInjector] = None


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install (or clear, with None) the process-wide injector."""
    global _active
    _active = injector
    return injector


def active() -> Optional[FaultInjector]:
    return _active


def clear() -> None:
    install(None)


def parse_plan(plan: str, seed: int = 0) -> FaultInjector:
    """``site:key=val:key=val;site2:...`` -> injector. Keys: at, every, p,
    action, errno, delay_s, max_fires."""
    specs = []
    for part in plan.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        spec = FaultSpec(site=fields[0])
        for kv in fields[1:]:
            key, _, val = kv.partition("=")
            key = key.strip()
            if key == "action":
                spec.action = val.strip()
            elif key in ("at", "every", "errno", "max_fires"):
                setattr(spec, key, int(val))
            elif key in ("p", "delay_s"):
                setattr(spec, key, float(val))
            else:
                raise ValueError(f"unknown fault-spec key '{key}' in {part!r}")
        if spec.action not in ("raise", "errno", "stall", "kill"):
            raise ValueError(f"unknown fault action '{spec.action}'")
        specs.append(spec)
    return FaultInjector(specs, seed=seed)


def _execute(spec: FaultSpec, site: str):
    if spec.action == "stall":
        logger.warning(f"fault injection: stalling {spec.delay_s}s at {site}")
        time.sleep(spec.delay_s)
        return None
    if spec.action == "kill":
        logger.warning(f"fault injection: killing process at {site}")
        os._exit(KILL_EXIT_CODE)
    if spec.action == "errno":
        return -abs(spec.errno)
    raise InjectedFault(spec.errno, f"injected fault at {site}")


def maybe_fail(site: str) -> None:
    """Exception-contract sites: raises :class:`InjectedFault`, stalls or
    kills when the active plan says so; free when none is installed."""
    if _active is None:
        return
    spec = _active.hit(site)
    if spec is None:
        return
    rc = _execute(spec, site)
    if rc is not None:  # an errno spec on an exception-contract site
        raise InjectedFault(-rc, f"injected fault at {site}")
