"""Replica management for multi-replica serving (the JAX package's
``serving/cluster.py``, ported).

A :class:`ServingCluster` turns N data-parallel ``InferenceEngineV2``
instances (same model, same weights, independent KV pools) into the replica
set a :class:`~deepspeed_tpu_torch.inference.v2.serving.router.ServingRouter`
fronts:

- builds one ``ServingFrontend`` per serving replica from ONE shared
  ``ServingConfig`` (uniform priority classes — federation compares
  like-for-like SLO state);
- labels every replica's monitor surfaces (``FrontendStats.replica``,
  ``SpecDecodeStats.replica``, ``AttnSplitStats.replica``) so N frontends
  fanning into one monitor backend emit ``serve/frontend/<replica>/*``
  (``serve/spec/<replica>/*``, ``serve/attn/<replica>/*``) rows instead of
  colliding;
- validates the KV page fabric is uniform (block size + page layout), the
  precondition for byte-exact cross-engine handoffs
  (``engine.export_kv``/``import_kv``);
- under a disaggregated topology, runs a :class:`PrefillWorker` per
  ``prefill`` replica: queued requests prefill in SplitFuse-composed batches
  through the engine's scheduler passes, then each finished sequence's KV
  pages + bootstrap logits row move to a decode replica over the bucketed
  page gather — the same pinned-host round trip preempt-offload rides
  (``kv_offload.py``), re-seeding ``_last_logits`` exactly like a
  preemption restore.

Roles: ``"serve"`` (prefill + decode — the colocated default),
``"prefill"`` (SplitFuse passes only, no frontend), ``"decode"``
(handoff-fed decode frontend).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.utils.fault_injection import maybe_fail
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.resilience import call_with_deadline

_ROLES = ("serve", "prefill", "decode")


class Replica:
    """One engine (+ its serving frontend, unless role ``prefill``) under a
    stable name — the unit the router places requests on."""

    def __init__(self, name: str, engine, role: str = "serve",
                 frontend=None):
        self.name = name
        self.engine = engine
        self.role = role
        self.frontend = frontend

    def __repr__(self) -> str:
        return f"Replica({self.name!r}, role={self.role!r})"


class ServingCluster:

    def __init__(self, engines: Sequence, serving=None,
                 roles: Optional[Sequence[str]] = None,
                 names: Optional[Sequence[str]] = None):
        engines = list(engines)
        if not engines:
            raise ValueError("a cluster needs at least one engine")
        roles = list(roles) if roles is not None else ["serve"] * len(engines)
        names = list(names) if names is not None \
            else [f"r{i}" for i in range(len(engines))]
        if not (len(engines) == len(roles) == len(names)):
            raise ValueError(
                f"engines ({len(engines)}), roles ({len(roles)}) and names "
                f"({len(names)}) must align")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        bad = [r for r in roles if r not in _ROLES]
        if bad:
            raise ValueError(f"unknown replica roles {bad}; valid: {_ROLES}")
        # the page fabric is only byte-exact between identical layouts:
        # block size, page shape and dtype must match across every replica
        ref = engines[0].kv.config
        for e, name in zip(engines[1:], names[1:]):
            c = e.kv.config
            mismatched = [f for f in ("num_layers", "num_kv_heads", "head_dim",
                                      "block_size", "dtype", "quantized")
                          if getattr(c, f) != getattr(ref, f)]
            if mismatched:
                raise ValueError(
                    f"replica {name!r} KV layout differs from "
                    f"{names[0]!r} on {mismatched} — cross-replica KV "
                    "handoff would not be byte-exact")
        self.replicas: List[Replica] = []
        # disjoint per-frontend uid spaces ((1 << 24)-spaced — 16.7M
        # requests per frontend lifetime): a request migrated off a failed
        # replica keeps its uid on the survivor, so two frontends must
        # never mint the same one; a rejoin-rebuilt frontend draws a FRESH
        # space (alloc_uid_base) for the same reason
        self._uid_spaces = itertools.count(1)
        for engine, role, name in zip(engines, roles, names):
            frontend = None
            if role != "prefill":
                frontend = engine.serving_frontend(
                    config=serving, uid_base=self.alloc_uid_base())
                frontend.stats.replica = name
            engine.spec_stats.replica = name
            engine.attn_stats.replica = name
            self.replicas.append(Replica(name, engine, role, frontend))

    def alloc_uid_base(self) -> int:
        """A fresh, never-reused uid space for one frontend lifetime."""
        return (1 << 24) * next(self._uid_spaces)

    # ------------------------------------------------------------------ #

    @property
    def block_size(self) -> int:
        return self.replicas[0].engine.kv.config.block_size

    @property
    def frontends(self) -> List[Replica]:
        return [r for r in self.replicas if r.frontend is not None]

    @property
    def prefill_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.role == "prefill"]

    @property
    def decode_replicas(self) -> List[Replica]:
        """Replicas that can decode handed-off sequences."""
        return [r for r in self.replicas if r.role == "decode"]

    @property
    def serve_replicas(self) -> List[Replica]:
        """Colocated (prefill + decode) replicas."""
        return [r for r in self.replicas if r.role == "serve"]

    def replica(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"unknown replica {name!r}; configured: "
                       f"{[r.name for r in self.replicas]}")

    def start(self) -> "ServingCluster":
        """Start every replica frontend (idempotent per frontend — a bench
        or test may warm frontends before handing the cluster to a
        router)."""
        for r in self.frontends:
            if r.frontend._thread is None and not r.frontend._closed:
                r.frontend.start()
        return self

    def close(self, ignore: Sequence[str] = ()) -> None:
        """Close every frontend; the FIRST replica whose close raises (a
        died engine thread) is re-raised NAMED after all replicas are torn
        down — a dead replica must not leave its siblings running.
        ``ignore`` names replicas whose failure was already HANDLED (the
        router's health monitor migrated their requests) — their close
        still runs, but a died-loop re-raise is suppressed rather than
        reported twice."""
        failed = []
        for r in self.frontends:
            try:
                r.frontend.close()
            except BaseException as exc:
                if r.name not in ignore:
                    failed.append((r.name, exc))
        if failed:
            name, exc = failed[0]
            raise RuntimeError(f"replica {name!r} failed at close") from exc


class PrefillWorker:
    """Dedicated prefill executor for one ``prefill``-role replica.

    Drains its queue in batches: every queued request's prompt enters the
    scheduler together, so the SplitFuse passes COMPOSE concurrent prompts
    (multiple chunk slots per pass — the same batching a colocated frontend
    gets, without a decode set to interfere with). Each finished sequence is
    exported (``engine.export_kv``: one bucketed page gather + the bootstrap
    logits row) and handed to the least-loaded decode replica
    (``ServingFrontend.submit_handoff``). Client disconnects are polled at
    pass boundaries exactly like ``ServingFrontend._prefill``.

    A worker that dies surfaces at the ROUTER's ``drain()``/``close()`` with
    the replica named (``exc``), and every request it still held has its
    stream closed so clients never hang."""

    def __init__(self, replica: Replica, router):
        self.replica = replica
        self.router = router
        self.q: "queue.Queue" = queue.Queue()
        self.exc: Optional[BaseException] = None
        # requests this worker currently owns (popped from the queue, not
        # yet handed off / finalized) — the crash handler closes exactly
        # these streams, never one a decode replica already adopted
        self._owned: Dict[int, object] = {}
        self._stop = threading.Event()
        self._fenced = False
        self._site = f"serve.prefill_worker.{replica.name}"
        self._thread: Optional[threading.Thread] = None

    @property
    def queued(self) -> int:
        return self.q.qsize()

    @property
    def fenced(self) -> bool:
        return self._fenced

    def submit(self, req) -> None:
        if self._fenced:
            raise RuntimeError(
                f"prefill worker {self.replica.name!r} is fenced")
        self.q.put(req)

    def fence(self) -> None:
        """Declare this worker DOWN (serving/health.py): even a wedged
        thread that wakes later bails at the next batch/pass boundary
        without exporting or handing anything off — its queue and owned
        requests now belong to the failover migration."""
        self._fenced = True
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"dstpu-prefill-{self.replica.name}",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # abandon whatever is still queued: close the streams (cancelled)
        while True:
            try:
                req = self.q.get_nowait()
            except queue.Empty:
                break
            self.router._finalize_external(req, "cancelled")

    # -- the worker thread --------------------------------------------- #

    def _finalize(self, req, status: str) -> None:
        self._owned.pop(req.uid, None)
        self.router._finalize_external(req, status)

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    req = self.q.get(timeout=0.02)
                except queue.Empty:
                    continue
                batch = [req]
                while True:            # batch everything already queued
                    try:
                        batch.append(self.q.get_nowait())
                    except queue.Empty:
                        break
                # own the batch BEFORE the chaos site: a crash (or wedge)
                # here must leave every popped request reachable by the
                # failover sweep, never stranded in a dead thread's locals
                for r in batch:
                    self._owned[r.uid] = r
                # chaos site (raise = crash this worker, stall = wedge it);
                # the fence check follows so a stalled thread that wakes
                # post-failover re-queues the batch untouched and exits
                maybe_fail(self._site)
                if self._fenced:
                    for r in batch:    # migration drains the queue
                        self._owned.pop(r.uid, None)
                        self.q.put(r)
                    return
                self._process(batch)
        except BaseException as exc:   # surface at router drain()/close()
            # (or at the health monitor, which migrates _owned instead)
            self.exc = exc
            if not self.router.health.enabled:
                for req in list(self._owned.values()):
                    self._finalize(req, "cancelled")

    def _process(self, batch: List) -> None:
        e = self.replica.engine
        pending = list(batch)
        while pending:
            if self._fenced:
                for req in pending:    # migration takes them back
                    self._owned.pop(req.uid, None)
                    self.q.put(req)
                return
            live = []
            while pending:
                req = pending[0]
                if req.cancelled:
                    self._finalize(req, "cancelled")
                    pending.pop(0)
                    continue
                if not e.can_schedule([req.uid], [len(req.prompt)]):
                    if not live:
                        # router.submit validated the prompt against the
                        # pool, so an empty engine always fits one — a
                        # stuck full pool here is a real bug, not load
                        raise RuntimeError(
                            f"prefill replica {self.replica.name!r} cannot "
                            f"fit prompt of {len(req.prompt)} tokens")
                    break              # drain what we have, then continue
                t = time.perf_counter()
                # from the phase stamp, not arrival: a failover-requeued
                # request already attributed arrival..migration — this
                # stint is only the wait in THIS worker's queue
                req._ledger_add("queued", req._phase_t0, t)
                if _tracer.enabled:
                    _tracer.add("serve/req/queued", req._phase_t0, t,
                                lane=f"serve/req/u{req.uid}", uid=req.uid,
                                trace_id=req.trace_id)
                e.scheduler.add_tokens(req.uid, req.prompt)
                req.status = "prefill"
                req._phase_t0 = t
                live.append(req)
                pending.pop(0)
            self._prefill_and_handoff(live)

    def _prefill_and_handoff(self, live: List) -> None:
        e = self.replica.engine
        t0 = time.perf_counter()
        tokens = sum(len(r.prompt) for r in live)
        while e.scheduler.has_pending():
            e._run_pass()
            for req in live:
                if req.cancelled and req.status == "prefill":
                    e.flush([req.uid])
                    self._finalize(req, "cancelled")
        live = [r for r in live if r.status == "prefill"]
        t1 = time.perf_counter()
        if live:
            # same loop-observed cadence the colocated frontend feeds its
            # cost model — the router's federation reads this replica's rate
            self.router._note_prefill(self.replica, tokens, t1 - t0)
        for req in live:
            req._ledger_add("prefill", req._phase_t0, t1)
            if _tracer.enabled:
                _tracer.add("serve/req/prefill", req._phase_t0, t1,
                            lane=f"serve/req/u{req.uid}", uid=req.uid,
                            trace_id=req.trace_id)
            # the decode replica's handoff_wait stint starts here: the
            # ledger must cover export + fabric wait + import as one span
            req._phase_t0 = t1
            self._handoff(req)

    def _handoff(self, req) -> None:
        """Export one prefilled sequence and hand it to a decode replica
        under the router's bounded retry/timeout budget
        (``RouterConfig.handoff_retries`` / ``handoff_timeout_s`` /
        ``handoff_backoff_s``; ``utils/resilience``): each attempt is
        deadline-wrapped (a wedged decode replica raises
        :class:`~deepspeed_tpu_torch.utils.resilience.IOTimeout` here instead of
        stalling this worker unboundedly) and RE-PLANNED against a decode
        replica the earlier attempts have not seen fail. A request that
        exhausts the budget is shed with the error NAMED on its handle
        (``req.error`` — re-raised by ``result()``), never swallowed."""
        e = self.replica.engine
        cfg = self.router.config
        h0 = time.perf_counter()
        pages, logits = e.export_kv(req.uid)
        tried: List[str] = []
        delay = cfg.handoff_backoff_s
        last: Optional[BaseException] = None
        for attempt in range(cfg.handoff_retries):
            try:
                # prefer a replica earlier attempts have NOT seen fail;
                # with every one tried (or only one configured), retry the
                # least-loaded anyway — attempt-scoped faults are transient
                try:
                    target = self.router._pick_decode(exclude=tried)
                except LookupError:
                    target = self.router._pick_decode()
            except LookupError as exc:
                last = exc
                break
            # `abandoned` makes a timed-out attempt inert: if the wedged
            # call wakes after we moved on, it must not ALSO submit — two
            # replicas serving one stream is worse than a retry. The lock
            # makes submit-vs-abandon atomic: a late waker either finds
            # `abandoned` set and raises, or its submit LANDED before the
            # flag flipped — in which case `submitted` tells this loop the
            # attempt actually succeeded and there is nothing to retry.
            state = {"abandoned": False, "submitted": False}
            state_lock = threading.Lock()

            def _attempt(target=target, state=state):
                maybe_fail("serve.handoff")
                maybe_fail(f"serve.handoff.{self.replica.name}")
                with state_lock:
                    if state["abandoned"]:
                        raise RuntimeError("handoff attempt abandoned "
                                           "after timeout")
                    target.frontend.submit_handoff(req, pages, logits)
                    state["submitted"] = True

            try:
                call_with_deadline(
                    _attempt, cfg.handoff_timeout_s,
                    describe=f"handoff uid {req.uid} "
                             f"{self.replica.name!r}->{target.name!r}")
            except (OSError, RuntimeError) as exc:   # incl. IOTimeout,
                with state_lock:                     # InjectedFault, fenced
                    state["abandoned"] = True
                    landed = state["submitted"]
                if not landed:
                    last = exc
                    tried.append(target.name)
                    if attempt < cfg.handoff_retries - 1:
                        time.sleep(delay)
                        delay *= 2.0
                    continue
            self._owned.pop(req.uid, None)
            self.router._note_handoff(self.replica, target, req,
                                      int(pages.nbytes), h0)
            return
        err = RuntimeError(
            f"handoff of request {req.uid} from prefill replica "
            f"{self.replica.name!r} exhausted its retry budget "
            f"({cfg.handoff_retries} attempts, tried {tried or 'none'})")
        err.__cause__ = last
        req.error = err
        log_dist(f"{err} — shedding the request", ranks=[0])
        with self.router._lock:
            self.router.stats.handoff_failures += 1
        self._finalize(req, "shed")
