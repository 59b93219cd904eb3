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
is armed with :func:`install`, or from the ``DSTPU_FAULTS`` environment
variable by :func:`install_from_env`, which ``deepspeed_tpu_torch.initialize``
calls. Return-code sites (the AIO surface) call :func:`maybe_rc`.

Sites in the port:

========================  ===================================================
``step.kill``             top of ``engine.train_batch`` (mid-run preemption;
                          pair with ``action=kill``).
``agent.run``             ``DSElasticAgent`` before each (re)start attempt.
``serve.engine_step``     top of ``ServingFrontend.step()``: ``raise``
                          crashes the replica's serving loop, ``stall``
                          wedges it (the health monitor's stall case). The
                          form ``serve.engine_step.<replica>`` (the name a
                          ``ServingCluster`` gives) targets ONE replica.
``serve.prefill_worker``  ``PrefillWorker`` batch loop (disaggregated
                          prefill), also as
                          ``serve.prefill_worker.<replica>``.
``serve.handoff``         inside each deadline-wrapped prefill->decode
                          handoff attempt (``raise`` spends the retry
                          budget; ``stall`` past ``handoff_timeout_s``
                          surfaces ``IOTimeout``).
``serve.kv_fetch``        ``engine.fetch_pages`` (the page gather of
                          preempt-offload and ``export_kv``).
``serve.kv_put``          ``engine.put_pages`` (the page scatter of restore
                          and ``import_kv``).
``serve.lora_fault``      ``LoraAdapterRegistry._ensure_resident``: inside an
                          adapter fault-in, after its pages are allocated and
                          before the scatter lands (cancel-while-faulting
                          rolls refcounts, bindings and free pages back).
``ckpt.writer``           ``checkpoint.engine._atomic_savez`` before the
                          write (a writer crash).
``ckpt.stall``            ``checkpoint.engine._atomic_savez`` after the temp
                          file is written, before its rename (a slow writer
                          or disk; pair with ``action=stall``).
``aio.read``/``aio.write``  ``ops.native.aio.AsyncIOHandle`` submit (return
                          code: a negative errno before the request queues).
``aio.wait``              ``AsyncIOHandle.wait`` after the real drain.
========================  ===================================================

A ``raise`` or ``kill`` first dumps the span tracer's flight recorder
(``monitor/trace.Tracer.crash_dump``; a no-op with tracing off).
"""

from __future__ import annotations

import errno as _errno
import logging
import os
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.threads import make_lock

logger = logging.getLogger("deepspeed_tpu_torch")

#: exit status of an injected ``action=kill``, told apart from a crash
KILL_EXIT_CODE = 17

_ENV_VAR = "DSTPU_FAULTS"


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
        self._lock = make_lock("utils.fault.hits")
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


def install_from_env() -> Optional[FaultInjector]:
    """Install a plan from ``DSTPU_FAULTS`` (no-op when unset). Called by
    ``deepspeed_tpu_torch.initialize`` so a subprocess arms faults without
    touching user code; idempotent: an already-installed injector wins.
    ``DSTPU_SEED`` seeds the plan's probabilistic triggers."""
    if _active is not None:
        return _active
    plan = os.environ.get(_ENV_VAR, "").strip()
    if not plan:
        return None
    seed = int(os.environ.get("DSTPU_SEED", "0") or 0)
    inj = install(parse_plan(plan, seed=seed))
    logger.warning(f"fault injection ARMED from ${_ENV_VAR}: {plan!r}")
    return inj


def _flight_record(site: str, action: str) -> None:
    """Dump the span tracer's flight recorder before a fault surfaces (a
    kill skips atexit, so this is the only timeline it leaves). Never
    raises: the fault must still fire."""
    try:
        from deepspeed_tpu_torch.monitor.trace import tracer
        tracer.crash_dump(f"injected {action} at {site}")
    except Exception:   # pragma: no cover - the fault must still fire
        pass


def _execute(spec: FaultSpec, site: str):
    if spec.action == "stall":
        logger.warning(f"fault injection: stalling {spec.delay_s}s at {site}")
        time.sleep(spec.delay_s)
        return None
    if spec.action == "kill":
        logger.warning(f"fault injection: killing process at {site}")
        _flight_record(site, "kill")
        os._exit(KILL_EXIT_CODE)
    if spec.action == "errno":
        return -abs(spec.errno)
    _flight_record(site, "raise")
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


def maybe_rc(site: str) -> int:
    """Return-code sites (the AIO surface): a negative errno when firing
    with ``action=errno``; a stall returns 0 after sleeping; ``raise`` and
    ``kill`` behave as in :func:`maybe_fail`."""
    if _active is None:
        return 0
    spec = _active.hit(site)
    if spec is None:
        return 0
    rc = _execute(spec, site)
    return rc if rc is not None else 0
