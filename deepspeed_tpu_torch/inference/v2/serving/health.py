"""Replica failure detection, request failover and self-healing membership
for the multi-replica serving router (the JAX package's
``serving/health.py``, ported).

**Detection.** A ``dstpu-health`` thread polls every replica on a fixed
interval: engine-thread / prefill-worker LIVENESS (a died loop is ``down``
at once) plus a PROGRESS heartbeat from counters the engine already keeps:
the decode pipelines' step and token counters (``engine.pipeline_stats``,
and ``engine.spec_stats`` for the speculative pipeline) and the
scheduler's prefill-token counter. A replica with work in flight
whose counters freeze is *wedged*, not idle: it turns ``suspect`` after
``HealthConfig.suspect_after_s`` and ``down`` after ``down_after_s``
(states: ``healthy -> suspect -> down -> draining -> rejoining``). The
stall clock is ``HealthMonitor(clock=)``, ``time.perf_counter`` by
default; a test passes its own clock and advances it by hand.

**Failover.** ``down`` FENCES the replica (``ServingFrontend.fence`` /
``PrefillWorker.fence``): even a wedged thread that wakes later emits
nothing. Each request is SEALED under its handle's emit lock (an exact
prompt + emitted snapshot no straggling emission can race), then moved:

- a preempt-offloaded victim whose WHOLE KV sits in pinned host buffers
  (``KVOffloadManager.salvageable``) is SALVAGED: the buffers become a
  survivor's ``import_kv`` payload, with no recompute;
- a queued disaggregated handoff (pages already on the host) is RE-PLANNED
  to another decode replica;
- everything else RE-PREFILLS its sealed history on a survivor through the
  recompute-restore path (``ServingFrontend.submit_resume``); where the
  cluster prefix index steered it onto a replica holding the prefix, the
  radix match skips that span;

and the stream resumes from the last emitted token, with a
``RequestHandle.migrated`` marker. No survivor able to fund it means a
clean shed, never a hung stream. The dead replica's chain-hash entries
leave the ``ClusterPrefixIndex`` at fence time.

**Self-healing.** Once the failed thread has exited, ``rejoin`` resets the
engine (flushes stranded sequences, drops stranded offload records),
rebuilds a frontend in a FRESH uid space, re-runs ``engine.warmup()`` off
the routing hot path (on a warm engine it adds no step-cache entry),
re-registers the prefix-index feed (replaying the engine's radix tree) and
only then returns the replica to routing.

Observability: ``monitor/serving.HealthStats`` (``serve/health/*``) and
``serve/health/{detect,migrate,rejoin}`` trace spans.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.inference.v2.config_v2 import HealthConfig
from deepspeed_tpu_torch.inference.v2.serving.frontend import (CANCELLED, FINISHED,
                                                         SHED, _DONE)
from deepspeed_tpu_torch.monitor.serving import HealthStats
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.threads import make_rlock, thread_role

# replica health states (docs/SERVING.md "Failure semantics")
HEALTHY = "healthy"        # in routing rotation
SUSPECT = "suspect"        # progress stalled past suspect_after_s
DOWN = "down"              # declared failed (liveness, or stall deadline)
DRAINING = "draining"      # fenced; in-flight requests migrating / migrated
REJOINING = "rejoining"    # frontend rebuilt, warming off the hot path


class _ReplicaRecord:
    __slots__ = ("name", "state", "progress", "stall_since", "last_ok",
                 "handled", "want_rejoin", "busy")

    def __init__(self, name: str, now: float):
        self.name = name
        self.state = HEALTHY
        self.progress: Optional[Tuple] = None
        self.stall_since: Optional[float] = None
        self.last_ok = now
        self.handled = False           # a failure this monitor failed over
        self.want_rejoin = False
        self.busy = False              # claimed by a failover/rejoin actor


class HealthMonitor:
    """Owns the replica health state machine for one ``ServingRouter``.

    ``poll()`` is ONE detection pass — the background thread calls it on
    ``HealthConfig.interval_s``, ``router.drain`` calls it through
    ``check()``, and tests drive it synchronously for determinism.

    ``clock`` is the stall clock (``time.perf_counter``): a test seam, so
    a test advances time by hand instead of waiting out wall-clock
    deadlines.

    Locking discipline: detection and every
    state transition run under ``_lock``, but the BLOCKING legs of a
    failover/rejoin — fence joins, ``old.close()``, ``engine.warmup()`` —
    run with the lock RELEASED. A record is CLAIMED (``rec.busy``) under
    the lock before any actor starts handling it and released when the
    actor finishes, so a failure is still handled exactly once no matter
    who observed it, while ``all_healthy()``/``handled_replicas()`` never
    wait out a wedged replica's join timeout behind the monitor lock."""

    def __init__(self, router, config: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.perf_counter):
        cfg = config if config is not None else HealthConfig()
        if isinstance(cfg, dict):
            cfg = HealthConfig(**cfg)
        self.router = router
        self.config = cfg
        self._clock = clock
        self.stats = HealthStats([r.name for r in router.cluster.replicas])
        self._recs: Dict[str, _ReplicaRecord] = {
            r.name: _ReplicaRecord(r.name, clock())
            for r in router.cluster.replicas}
        self._lock = make_rlock("serving.health.monitor")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="dstpu-health", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @thread_role("dstpu-health")
    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.poll()
            except BaseException as exc:    # surfaced at check()/drain()
                self._exc = exc
                return

    def check(self) -> None:
        """Router-facing health check: run a poll inline and re-raise a
        monitor-thread failure (the monitor dying must not silently turn
        back into hung streams)."""
        if self._exc is not None:
            raise RuntimeError("health monitor died") from self._exc
        self.poll()

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #

    def state(self, name: str) -> str:
        return self._recs[name].state

    def handled_replicas(self) -> List[str]:
        """Replicas whose failure this monitor already failed over —
        ``router.close`` suppresses their died-loop re-raise."""
        with self._lock:
            return [r.name for r in self._recs.values() if r.handled]

    def all_healthy(self) -> bool:
        with self._lock:
            return all(r.state == HEALTHY for r in self._recs.values())

    def wait_all_healthy(self, timeout: float) -> bool:
        """Poll until every replica is back in rotation (benches wait for
        self-healing to complete before scoring baselines)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.poll()
            if self.all_healthy():
                return True
            time.sleep(min(self.config.interval_s, 0.02))
        return self.all_healthy()

    # ------------------------------------------------------------------ #
    # detection
    # ------------------------------------------------------------------ #

    def _liveness_exc(self, replica) -> Optional[BaseException]:
        if replica.role == "prefill":
            return self.router._workers[replica.name].exc
        fe = replica.frontend
        return None if fe is None else fe._loop_exc

    def _progress(self, replica) -> Tuple[Tuple, bool]:
        """(progress snapshot, busy?). The snapshot folds the counters the
        replica moves when it COMPLETES work — the decode and speculative
        pipelines' step / token counters and prefill tokens completed — so forward motion
        resets the stall clock; ``busy`` gates the clock so an idle replica
        is never suspected. Deliberately NOT in the snapshot: the in-flight
        count — new arrivals landing on a wedged replica would reset its
        stall clock forever (measured: a stalled replica under steady
        Poisson traffic was never declared down)."""
        e = replica.engine
        if replica.role == "prefill":
            w = self.router._workers[replica.name]
            return ((e.scheduler.prefill_tokens_completed,),
                    w.queued > 0 or bool(w._owned))
        fe = replica.frontend
        snap = (e.pipeline_stats.steps, e.pipeline_stats.tokens,
                e.spec_stats.steps, e.spec_stats.tokens,
                e.scheduler.prefill_tokens_completed)
        return snap, fe._inflight > 0

    def _transition(self, rec: _ReplicaRecord, new: str) -> None:
        with self._lock:
            old = rec.state
            if old == new:
                return
            rec.state = new
            self.stats.record_transition(rec.name, old, new)
        if _tracer.enabled:
            _tracer.instant("serve/health/state", lane="serve/health",
                            replica=rec.name, frm=old, to=new)

    def poll(self) -> None:
        """One detection pass over every replica (reentrant-safe). The
        scan CLAIMS records needing a failover/rejoin under the lock; the
        blocking handling runs after the lock is released."""
        # the scan's SUSPECT/HEALTHY transitions emit tracer instants while
        # the monitor lock is held; a thread's first record registers its
        # ring under monitor.trace.registry — pre-register outside the lock
        # so that acquisition order never exists
        _tracer.register_thread()
        actions: List[Tuple[str, object, _ReplicaRecord, str]] = []
        with self._lock:
            now = self._clock()
            for replica in self.router.cluster.replicas:
                rec = self._recs[replica.name]
                if rec.busy:
                    continue           # another actor is mid-handling
                if rec.state in (DOWN, DRAINING):
                    if rec.want_rejoin:
                        rec.busy = True
                        actions.append(("rejoin", replica, rec, ""))
                    continue
                if rec.state == REJOINING:
                    continue               # rejoin completes synchronously
                exc = self._liveness_exc(replica)
                if exc is not None:
                    rec.busy = True
                    actions.append(("down", replica, rec, "liveness"))
                    continue
                prog, busy = self._progress(replica)
                if prog != rec.progress or not busy:
                    rec.progress = prog
                    rec.stall_since = None
                    rec.last_ok = now
                    if rec.state == SUSPECT:
                        self._transition(rec, HEALTHY)
                    continue
                if rec.stall_since is None:
                    rec.stall_since = now
                    continue
                # intentionally async: the stall clock measures HOST wall
                # time since the counters froze — no device work is timed
                stalled = now - rec.stall_since
                if stalled >= self.config.down_after_s:
                    rec.busy = True
                    actions.append(("down", replica, rec, "stall"))
                elif stalled >= self.config.suspect_after_s \
                        and rec.state == HEALTHY:
                    self._transition(rec, SUSPECT)
        for act, replica, rec, kind in actions:
            try:
                if act == "down":
                    self._declare_down(replica, rec, kind, now)
                else:
                    self._try_rejoin(replica, rec)
            finally:
                rec.busy = False

    def _declare_down(self, replica, rec: _ReplicaRecord, kind: str,
                      now: float) -> None:
        """Handle one declared failure. The caller has CLAIMED ``rec``
        (``rec.busy``); everything blocking here runs without the monitor
        lock."""
        t0 = rec.stall_since if kind == "stall" else rec.last_ok
        self._transition(rec, DOWN)
        with self._lock:
            self.stats.record_detection(kind, now - t0)
        if _tracer.enabled:
            _tracer.add("serve/health/detect", t0, now, lane="serve/health",
                        replica=rec.name, kind=kind)
        log_dist(f"health: replica {rec.name!r} is DOWN ({kind}); "
                 "fencing and migrating its requests", ranks=[0])
        self._failover(replica, rec)
        with self._lock:
            rec.handled = True
            rec.want_rejoin = bool(self.config.auto_rejoin)
        if rec.want_rejoin:
            self._try_rejoin(replica, rec)

    # ------------------------------------------------------------------ #
    # failover
    # ------------------------------------------------------------------ #

    def _failover(self, replica, rec: _ReplicaRecord) -> None:
        self.router._drop_replica_routing(replica.name)
        if replica.role == "prefill":
            self._failover_prefill(replica, rec)
            return
        fe = replica.frontend
        fe.fence()
        fe.join(self.config.fence_join_s)   # best effort; seal covers races
        self._transition(rec, DRAINING)
        self._collect_and_migrate(replica, fe)

    def _collect_and_migrate(self, replica, fe) -> None:
        """Migrate every request a fenced/dead frontend still holds — its
        filed dicts plus control messages the loop never drained (each was
        counted in ``_inflight`` at submit but never filed). Re-run at
        rejoin time to catch a straggler a wedged thread raced past the
        first scrape."""
        items: List[Tuple] = []             # (req, handoff_rec)
        for kind, payload in fe._scrape_control():
            with fe._inflight_lock:
                fe._inflight -= 1
            if kind == "submit":
                items.append((payload, None))
            elif kind == "handoff":
                items.append((payload[0], payload))
            elif kind == "resume":
                items.append((payload[0], None))
        for req in list(fe._reqs.values()):
            items.append((req, fe.disown(req)))
        for req, handoff in items:
            self._migrate_one(replica, fe, req, handoff)

    def _failover_prefill(self, replica, rec: _ReplicaRecord) -> None:
        """A dead/wedged prefill worker: its queued + owned requests hold no
        device state (an exported sequence already left with its handoff) —
        re-queue them on a surviving prefill worker, or shed cleanly."""
        w = self.router._workers[replica.name]
        w.fence()
        w.join(self.config.fence_join_s)
        self._transition(rec, DRAINING)
        self._requeue_prefill(self._drain_worker(w), exclude=replica.name)

    def _drain_worker(self, w) -> List:
        """Every request a fenced/dead prefill worker still holds (owned +
        queued, deduped — a fenced thread re-queues what it owned)."""
        reqs = list(w._owned.values())
        w._owned.clear()
        while True:
            try:
                reqs.append(w.q.get_nowait())
            except Exception:
                break
        seen = set()
        out = []
        for req in reqs:
            if req.uid not in seen:
                seen.add(req.uid)
                out.append(req)
        return out

    def _requeue_prefill(self, reqs: List, exclude: str) -> None:
        """Place each request on SOME routable prefill worker (least-queued
        first, next survivor on a fence race — the prefill twin of
        ``_migrate_one``'s target loop), shedding only when none can take
        it."""
        router = self.router
        for req in reqs:
            t0 = time.perf_counter()
            if req.cancelled:
                self.stats.migration_cancels += 1
                router._finalize_external(req, CANCELLED)
                continue
            self._close_phase(req, t0)
            placed = None
            survivors = sorted(
                (r for r in router.cluster.prefill_replicas
                 if r.name != exclude and router._routable(r)),
                key=lambda r: router._workers[r.name].queued)
            for target in survivors:
                # the migration stint lands on the ledger BEFORE the
                # publish: the moment submit() succeeds the survivor's
                # worker thread may pop the handle and record its own
                # 'queued' stint from _phase_t0 — writing after the
                # publish would race it (overlapping stints, a clobbered
                # phase stamp). An unplaceable request sheds terminally,
                # so a stint recorded for a fenced-then-shed attempt is
                # never read by the finished-ledger gates.
                t1 = time.perf_counter()
                req._ledger_add("migration", t0, t1)
                req._phase_t0 = t1
                try:
                    router._workers[target.name].submit(req)
                    placed = target
                    break
                except RuntimeError:
                    if req._ledger:
                        req._ledger.pop()   # fenced: the stint never ran
                    req._phase_t0 = t0
                    continue           # next survivor
            if placed is not None:
                req.migrated += 1
                self.stats.record_migration("reprefill", len(req.prompt))
                self._migrate_span(req, t0, "requeue", placed.name)
            else:
                self.stats.migration_sheds += 1
                router._finalize_external(req, SHED)

    #: RequestHandle.status -> ledger phase label for seal-time closes
    _PHASE_OF = {"queued": "queued", "prefill": "prefill",
                 "decoding": "decode", "preempted": "preempted"}

    def _close_phase(self, req, t: float, phase: Optional[str] = None) -> None:
        """Close the phase a dead replica's request was orphaned in: the
        stint from its last phase stamp to the failover stamp ``t`` lands
        on the ledger (and the trace lane) — the wedge/crash window is
        attributed, not lost — and ``_phase_t0`` re-bases to ``t`` so the
        ``migration`` stint recorded at adoption starts exactly here."""
        if phase is None:
            phase = self._PHASE_OF.get(req.status)
        if phase is not None and t > req._phase_t0:
            req._ledger_add(phase, req._phase_t0, t)
            if _tracer.enabled:
                _tracer.add(f"serve/req/{phase}", req._phase_t0, t,
                            lane=f"serve/req/u{req.uid}", uid=req.uid,
                            trace_id=req.trace_id, cls=req.cls.name,
                            orphaned=True)
        req._phase_t0 = t

    def _migrate_span(self, req, t0: float, mode: str, dst: str) -> None:
        if _tracer.enabled:
            _tracer.add("serve/health/migrate", t0, time.perf_counter(),
                        lane="serve/health", uid=req.uid,
                        trace_id=req.trace_id, mode=mode, dst=dst)

    def _finalize_handle(self, fe, req, status: str) -> None:
        """Terminal-state a handle the dead replica still owned, releasing
        host-side resources (offload buffers); the dead engine's
        device-side state is reclaimed wholesale at rejoin."""
        if fe.offload is not None and req.uid in fe.offload._recs:
            fe.offload.drop(req.uid)
        req.status = status
        req._q.put(_DONE)
        req._finished.set()

    def _resume_targets(self, history, exclude: Sequence[str]) -> List:
        """Decode-capable survivors, best first: longest cluster-cached
        prefix of ``history`` (the index salvage — a re-prefill there skips
        the cached span), then least loaded."""
        router = self.router
        cands = [r for r in router._decode
                 if r.name not in exclude and router._routable(r)]
        matches = router.index.match(history) \
            if cands and router.config.policy == "cache_aware" else {}
        cands.sort(key=lambda r: (-matches.get(r.name, 0),
                                  r.frontend._inflight))
        return cands

    def _migrate_one(self, replica, fe, req, handoff: Optional[Tuple]) -> None:
        t0 = time.perf_counter()
        history = req._seal()
        if req.cancelled:
            self._close_phase(req, t0,
                              phase="handoff_wait" if handoff is not None
                              else None)
            self.stats.migration_cancels += 1
            self._finalize_handle(fe, req, CANCELLED)
            return
        done = (len(req.tokens) >= req.max_new_tokens
                or (req.eos_token_id is not None and req.tokens
                    and req.tokens[-1] == req.eos_token_id))
        if done:
            # the crash raced the finish line: the stream is complete. Its
            # closing stint ends at the LAST EMISSION — the client-visible
            # end the finished-ledger tiling invariant is defined over —
            # not at the seal stamp a failure-detection window later
            end = req._last_emit_t if req._last_emit_t is not None else t0
            self._close_phase(req, min(end, t0))
            self._finalize_handle(fe, req, FINISHED)
            return
        # attribute the orphaned stint (a queued handoff's wait keeps its
        # handoff_wait label — the status still says prefill) and re-base
        # the phase clock to the seal: the survivor's adoption records the
        # migration stint from exactly here, so the ledger stays gapless
        self._close_phase(req, t0,
                          phase="handoff_wait" if handoff is not None
                          else None)
        # pick the payload ONCE (salvage exports destroy the record)
        mode, payload, nbytes = "reprefill", None, 0
        if handoff is not None:
            # a queued cross-replica handoff: pages already host-side —
            # re-plan it to another decode replica untouched. The import
            # there is this request's migration landing, not a routine
            # handoff wait — the flag makes the ledger say so
            mode, payload = "replan", handoff
            req._migrating = True
        elif fe.offload is not None and fe.offload.salvageable(req.uid):
            pages, logits, nbytes = fe.offload.export_record(req.uid)
            mode, payload = "salvage", (req, pages, logits, history)
        elif fe.offload is not None and req.uid in fe.offload._recs:
            # partial record (shared-prefix pages died with the device):
            # the host copy alone cannot rebuild the KV — re-prefill
            fe.offload.drop(req.uid)
        # the handle stays SEALED until the survivor's engine thread adopts
        # it (the frontend control handlers unseal) — a dead replica's
        # thread blocked inside one last _on_tokens call can never slip a
        # post-snapshot token into the stream the survivor resumes
        last: Optional[BaseException] = None
        tried: List[str] = [replica.name]
        while True:
            targets = self._resume_targets(history, exclude=tried)
            if not targets:
                break
            target = targets[0]
            try:
                if payload is not None:
                    target.frontend.submit_handoff(
                        payload[0], payload[1], payload[2],
                        history=payload[3] if len(payload) > 3 else None)
                else:
                    target.frontend.submit_resume(req, history)
            except (RuntimeError, ValueError) as exc:
                last = exc
                tried.append(target.name)
                continue
            if mode == "replan":
                self.stats.handoffs_replanned += 1
            else:
                self.stats.record_migration(mode, len(history), nbytes)
            req.migrated += 1
            self._migrate_span(req, t0, mode, target.name)
            return
        self.stats.migration_sheds += 1
        log_dist(f"health: no survivor could adopt request {req.uid} from "
                 f"replica {replica.name!r} ({last}); shedding", ranks=[0])
        self._finalize_handle(fe, req, SHED)

    # ------------------------------------------------------------------ #
    # self-healing: rejoin
    # ------------------------------------------------------------------ #

    def rejoin(self, name: str) -> bool:
        """Manually rejoin a drained replica (the ``auto_rejoin=False``
        path). True once the replica is back in rotation; False while its
        old thread is still wedged (or another actor is mid-rejoin)."""
        with self._lock:
            replica = self.router.cluster.replica(name)
            rec = self._recs[name]
            if rec.state == HEALTHY:
                return True
            if rec.state not in (DOWN, DRAINING) or rec.busy:
                return False
            rec.busy = True
        try:
            return self._try_rejoin(replica, rec)
        finally:
            rec.busy = False

    def _try_rejoin(self, replica, rec: _ReplicaRecord) -> bool:
        """Rebuild and re-admit one drained replica. The caller has CLAIMED
        ``rec``; the joins/warmup below block WITHOUT the monitor lock
        (router-side readers of ``_workers``/``replica.frontend`` never
        synchronized on it — the claim is what serializes monitor actors).
        """
        router = self.router
        if replica.role == "prefill":
            if not router._workers[replica.name].join(0):
                return False           # still wedged; retry next poll
        else:
            if not replica.frontend.join(0):
                return False           # still wedged; retry next poll
        with self._lock:
            rec.want_rejoin = False
        self._transition(rec, REJOINING)
        t0 = time.perf_counter()
        engine = replica.engine
        if replica.role != "prefill":
            old = replica.frontend
            # a wedged thread may have raced one request past the failover
            # scrape (popped a control message as the fence landed): with
            # the thread now joined, a second sweep migrates any straggler
            self._collect_and_migrate(replica, old)
            try:
                old.close()            # idempotent teardown; the died-loop
            except RuntimeError:       # re-raise was already handled here
                pass
        # reclaim the dead lifetime's device state: stranded sequences
        # release their pages (prefix-shared ones settle into the radix
        # tree, which survives and replays into the index below)
        for uid in list(engine.scheduler.seqs):
            engine.flush([uid])
        warmup_s = 0.0
        if self.config.rejoin_warmup:
            w0 = time.perf_counter()
            engine.warmup()            # off the hot path; no new step entry
            # warmup() synchronizes after the steps it runs: the delta is
            # execution time, not launch time
            warmup_s = time.perf_counter() - w0
        stragglers: List = []
        if replica.role == "prefill":
            from deepspeed_tpu_torch.inference.v2.serving.cluster import \
                PrefillWorker
            # a wedged thread may have re-queued requests into the OLD
            # worker after the failover sweep: drain it before discarding
            # (the prefill twin of the decode branch's second
            # _collect_and_migrate); re-placed below once this replica is
            # HEALTHY again, so its own new worker is a valid target
            stragglers = self._drain_worker(router._workers[replica.name])
            w = PrefillWorker(replica, router)
            router._workers[replica.name] = w
            w.start()
        else:
            fe = engine.serving_frontend(
                config=router._serving_cfg,
                uid_base=router.cluster.alloc_uid_base())
            fe.stats.replica = replica.name
            fe._managed = True
            replica.frontend = fe
            router.stats.register_frontend(fe.stats)
            router._register_close_listener(replica)
            fe.start()
        if replica in router._targets:
            router._register_index_listener(replica)   # replays the tree
        with self._lock:
            rec.handled = False
            rec.progress = None
            rec.stall_since = None
            rec.last_ok = self._clock()
            self.stats.record_rejoin(warmup_s)
        if _tracer.enabled:
            _tracer.add("serve/health/rejoin", t0, time.perf_counter(),
                        lane="serve/health", replica=replica.name,
                        warmup_ms=round(1e3 * warmup_s, 3))
        self._transition(rec, HEALTHY)
        if stragglers:
            self._requeue_prefill(stragglers, exclude="")
        log_dist(f"health: replica {replica.name!r} rejoined "
                 f"(warmup {1e3 * warmup_s:.0f} ms)", ranks=[0])
        return True
