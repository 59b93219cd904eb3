"""SLO-aware serving frontend: the persistent serving layer over the v2
engine (the JAX package's ``serving/frontend.py``, ported).

``ServingFrontend`` turns the batch-call engine into a server: a dedicated
engine thread (``dstpu-serve``) owns the ``DecodePipeline`` and runs the
continuous-batching loop; clients (threads or asyncio tasks) call
:meth:`ServingFrontend.submit` from anywhere and read a token stream off the
returned :class:`RequestHandle`. ``step()`` runs one iteration of the loop
with no thread, for tests and deterministic drivers.

The loop is iteration-level continuous batching at pipeline run
boundaries: each iteration drains control traffic, executes one admission
plan (``admission.py``: shed / restore / preempt / admit), runs prefill
passes for the admitted batch (cancellation polled at pass boundaries),
then drives one ``decode_slice``-step ``run()``. Tokens drain one step late
(the pipeline's overlap); the per-step ``on_tokens`` callback only stamps
clocks, appends ints and feeds stream queues, so serving adds no host sync
to the decode loop. Admission and retirement move the live set between the
pow2 buckets whose steps ``engine.warmup()`` has built, so steady-state
admission adds no step-cache entry after warmup.

Under KV-pool pressure the admission plan PREEMPTS low-priority victims by
offloading their private KV tail to pinned host buffers (``kv_offload.py``)
and restores them byte for byte on readmit; recompute is the per-victim
fallback when host capacity is exhausted, and a configured baseline.
Request lifecycle spans (``serve/req/{queued,prefill,decode,preempted,
restore}``) land on a per-request trace lane, and the aggregate counters in
``monitor/serving.FrontendStats`` (``serve/frontend/*``).

Weight swaps run between decode slices (``swap_weights``, the colocated
rollout): on the engine thread, at the run boundary preemption owns, every
holder of old-weight KV is turned into a recompute victim (adapter-bound
requests shed) before the engine rebinds its weights.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.config_v2 import ServingConfig
from deepspeed_tpu_torch.inference.v2.serving.admission import AdmissionController
from deepspeed_tpu_torch.inference.v2.serving.kv_offload import KVOffloadManager
from deepspeed_tpu_torch.monitor.serving import FrontendStats
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.utils.fault_injection import maybe_fail
from deepspeed_tpu_torch.utils.threads import make_lock, thread_role

_DONE = object()      # stream sentinel

# request lifecycle states
QUEUED = "queued"
PREFILL = "prefill"
DECODING = "decoding"
PREEMPTED = "preempted"
FINISHED = "finished"
CANCELLED = "cancelled"
SHED = "shed"
_TERMINAL = (FINISHED, CANCELLED, SHED)


#: process-lifetime flow-id mint. trace_id CANNOT be the uid: uid bases
#: restart with every cluster/frontend lifetime while tracer rings (and
#: the exporter's flow synthesizer) span the whole process, so uid reuse
#: across successive clusters — every bench rep, any in-process serving
#: restart — would merge unrelated requests' hops into one bogus chain.
#: The pid prefix keeps ids distinct across the subprocess workers whose
#: files ``trace_merge.py`` stitches into one timeline.
_TRACE_IDS = itertools.count(1)


def _mint_trace_id() -> int:
    # pid <= 2^22 (linux pid_max ceiling) and a 31-bit counter keep ids
    # inside the 2^53 exact-double range Chrome-trace ids must survive;
    # the counter wraps only past 2.1e9 submits per process
    return (os.getpid() << 31) | (next(_TRACE_IDS) & 0x7FFFFFFF)


def attribution_epsilon(client_s: float) -> float:
    """The ONE tolerance for "this request's ledger sums to its
    client-measured latency": max(5 ms, 1%), read by the
    ``serve/slo/attr_consistent`` stat (``_finalize``)."""
    return max(0.005, 0.01 * client_s)


class RequestHandle:
    """One submitted request: a thread-safe token stream plus lifecycle
    state. Clients iterate tokens (``for t in handle`` or ``async for t in
    handle.astream()``), or block for the full result; ``cancel()`` models a
    client disconnect — the engine thread retires the uid at the next run
    boundary and releases its KV through ``scheduler.flush``."""

    def __init__(self, uid: int, prompt: np.ndarray, cls, max_new_tokens: int,
                 eos_token_id: Optional[int], arrival_t: float,
                 adapter: Optional[str] = None):
        self.uid = uid
        #: LoRA adapter (tenant identity) this request decodes under; None =
        #: the base model. The engine thread acquires/releases the registry
        #: binding around the request's decoding lifetime (``_lora_held``).
        self.adapter = adapter
        self._lora_held = False
        #: process-unique request flow id, minted at submit and carried by
        #: every hop span (router placement, prefill, KV handoff, decode
        #: stints, failover migration) — the exporter binds spans sharing it
        #: into one Perfetto flow chain across lanes/threads/files. NOT the
        #: uid (uid bases restart per cluster lifetime; see
        #: ``_mint_trace_id``) — but like the uid it rides the handle, so a
        #: migrated request keeps it on the survivor and the chain survives
        #: failover.
        self.trace_id = _mint_trace_id()
        self.prompt = prompt
        self.cls = cls                      # PriorityClassConfig
        self.max_new_tokens = max_new_tokens
        self.eos_token_id = eos_token_id
        self.arrival_t = arrival_t          # perf_counter at submit
        self.tokens: List[int] = []
        self.status = QUEUED
        self.ttft_ms: Optional[float] = None
        self.tbt_ms: List[float] = []       # gaps between streamed tokens
        self.preemptions = 0
        self.migrated = 0                   # replica-failure migrations
        #: a named, non-swallowed failure (e.g. an exhausted disaggregated
        #: handoff retry budget) — re-raised by result()
        self.error: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue()
        self._cancel = threading.Event()
        self._finished = threading.Event()
        # migration seal (serving/health.py): emission happens under this
        # lock, and failover takes it to seal the handle + snapshot
        # ``tokens`` at one exact instant — the stream a survivor resumes
        # from can never race a straggling emission off the dead replica
        self._emit_lock = make_lock("serving.request.emit")
        self._sealed = False
        # engine-thread bookkeeping (phase stamps for spans + victim order)
        self.admit_t: Optional[float] = None
        self.preempt_t: Optional[float] = None
        self._phase_t0 = arrival_t
        self._last_emit_t: Optional[float] = None
        self._resume_tokens: Optional[np.ndarray] = None   # recompute restore
        self._stop_status = FINISHED            # set on mid-run retirement
        #: set by failover while a RE-PLANNED cross-replica handoff (pages
        #: already host-side, no salvage payload) is in flight to a
        #: survivor: the decode-side import labels its stint ``migration``
        #: instead of ``handoff_wait`` and clears the flag
        self._migrating = False
        #: the phase ledger: (phase, t0, t1) stints built from the SAME
        #: perf stamps the serve/req trace spans record — where this
        #: request's time went, summing to the client-measured latency for
        #: finished requests. ``None`` when attribution is disabled
        #: (``ServingConfig.attribution``).
        self._ledger: Optional[List[tuple]] = []

    # -- phase attribution (docs/OBSERVABILITY.md "SLO-miss attribution") -- #

    def _ledger_add(self, phase: str, t0: float, t1: float) -> None:
        if self._ledger is not None:
            self._ledger.append((phase, t0, t1))

    def timeline(self) -> List[tuple]:
        """The per-request phase ledger: ``(phase, t0, t1)`` stints in
        record order (``time.perf_counter`` endpoints — the same stamps the
        ``serve/req/*`` trace spans carry). Phases: ``queued``,
        ``admission``, ``prefill``, ``handoff_wait``, ``decode``,
        ``preempted``, ``restore``, ``migration``. For a finished request
        the stints tile ``arrival_t .. last-emission`` with no gaps, so
        their durations sum to the client-measured latency
        (TTFT + Σ TBT). Empty when attribution is disabled."""
        return list(self._ledger or ())

    def attribution(self) -> Dict[str, object]:
        """Phase attribution summary derived from :meth:`timeline`:
        per-phase totals, the dominant phase (where most of the latency
        went — the ``serve/slo/*`` bucketing key for SLO misses), the
        ledger total, and the client-measured latency (arrival to last
        emission; ``None`` before any token)."""
        phases: Dict[str, float] = {}
        for phase, t0, t1 in (self._ledger or ()):
            phases[phase] = phases.get(phase, 0.0) + max(0.0, t1 - t0)
        total = sum(phases.values())
        client = (self._last_emit_t - self.arrival_t
                  if self._last_emit_t is not None else None)
        dominant = max(phases, key=lambda p: phases[p]) if phases else None
        return {"phases": phases, "dominant": dominant,
                "total_s": total, "client_s": client,
                "residual_s": None if client is None else client - total}

    # -- client surface ------------------------------------------------ #

    def cancel(self) -> None:
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def finished(self) -> bool:
        return self._finished.is_set()

    def __iter__(self):
        while True:
            t = self._q.get()
            if t is _DONE:
                return
            yield t

    async def astream(self):
        """Async token stream (``async for tok in handle.astream()``): each
        blocking queue read rides the event loop's default executor, so the
        loop never blocks on the engine thread."""
        import asyncio
        loop = asyncio.get_running_loop()
        while True:
            t = await loop.run_in_executor(None, self._q.get)
            if t is _DONE:
                return
            yield t

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request reaches a terminal state; returns the
        generated tokens (possibly partial for cancelled/shed requests).
        A request shed with a NAMED failure (``self.error``, e.g. an
        exhausted handoff retry budget) re-raises it here — surfaced, never
        swallowed."""
        if not self._finished.wait(timeout):
            raise TimeoutError(f"request {self.uid} still {self.status} "
                               f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    def _seal(self) -> "np.ndarray":
        """Seal emission and snapshot ``prompt + tokens`` atomically — the
        exact resume point a failover migration continues from
        (serving/health.py). The survivor unseals on adoption."""
        with self._emit_lock:
            self._sealed = True
            return np.concatenate(
                [self.prompt, np.asarray(self.tokens, np.int32)])


class ServingFrontend:

    def __init__(self, engine, config=None, uid_base: int = 1 << 20):
        cfg = config if config is not None else engine.config.serving
        if isinstance(cfg, dict):
            cfg = ServingConfig(**cfg)
        if cfg.preemption != "none" and engine.scheduler.window is not None:
            raise NotImplementedError(
                "preemption with a sliding-window page ring is not wired "
                "(the logical block list aliases physical pages) — run "
                "preemption='none'")
        if cfg.preemption == "recompute" and getattr(engine, "lora", None) \
                is not None:
            raise NotImplementedError(
                "preemption='recompute' with LoRA serving is not wired: "
                "decode-written KV carries the adapter's k/v deltas, and a "
                "recompute restore re-prefills it base-only — a silently "
                "byte-divergent stream; run preemption='offload' (byte-exact "
                "restore) or 'none'")
        self.engine = engine
        self.config = cfg
        # phase-ledger recording (RequestHandle.timeline / serve/slo/*);
        # off = handles carry no ledger and misses go unattributed
        self._attribution = bool(getattr(cfg, "attribution", True))
        self.stats = FrontendStats([c.name for c in cfg.classes])
        # KV-pool gauges (monitor/serving.py): pool dtype + bytes/token are
        # static facts of the engine build; the capacity doubling an int8
        # pool buys (same HBM budget -> ~2x+ blocks) is then observable in
        # the same serve/frontend/* surface the latency counters live on
        kvc = engine.kv.config
        self.stats.set_kv_pool(
            dtype_bits=8 if kvc.quantized
            else 8 * torch.empty((), dtype=kvc.dtype).element_size(),
            bytes_per_token=kvc.bytes_per_block() / kvc.block_size,
            pool_tokens=engine.allocator.total_blocks * kvc.block_size,
            max_context=engine.config.state_manager.max_context,
            block_size=kvc.block_size)
        self.stats.kv_free_blocks = engine.allocator.free_blocks
        self.stats.kv_resident_seqs = len(engine.scheduler.seqs)
        self.admission = AdmissionController(engine, cfg)
        self.offload: Optional[KVOffloadManager] = (
            KVOffloadManager(engine, max_bytes=cfg.max_offload_bytes,
                             max_buffers=cfg.offload_buffers)
            if cfg.preemption == "offload" else None)
        if cfg.spec:
            self._pipe = engine.decode_pipeline(())
        else:
            # per-frontend spec opt-out (ServingConfig.spec): greedy
            # serving pinned to the plain pipeline even on a spec-enabled
            # engine
            from deepspeed_tpu_torch.inference.v2.pipeline import DecodePipeline
            self._pipe = DecodePipeline(engine, ())
        # speculative pipeline: steps emit token BATCHES (accepted draft
        # prefix + bonus) — on_tokens shape and TBT accounting branch on it
        self._spec = bool(getattr(self._pipe, "spec", False))
        self._ctl: "queue.Queue" = queue.Queue()
        self._reqs: Dict[int, RequestHandle] = {}       # every non-terminal
        self._live: Dict[int, RequestHandle] = {}       # in the pipeline
        self._preempted: Dict[int, RequestHandle] = {}
        self._run_stopped: List[RequestHandle] = []     # retired mid-run
        # thread-safe counter; ``uid_base`` keeps a cluster's frontends
        # (including a rejoin-rebuilt one) in DISJOINT uid spaces so a
        # migrated request can never collide on its new replica
        self._uid_iter = itertools.count(int(uid_base))
        # in-flight count bumped in submit() BEFORE the control message is
        # posted: drain() polling len(_reqs)/_ctl alone races the window
        # where the engine thread has popped the message but not yet filed
        # the handle
        self._inflight = 0
        self._inflight_lock = make_lock("serving.frontend.inflight")
        # cross-replica handoffs awaiting KV import (engine thread only —
        # failover's disown() writes too, but only once the loop is fenced
        # or dead, so the two writers are temporally exclusive by design)
        self._handoffs: List[tuple] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._loop_exc: Optional[BaseException] = None
        self._closed = False
        # fenced = declared down by a health monitor: the loop (even a
        # wedged one that wakes later) must emit nothing further — every
        # in-flight stream now belongs to the replica it migrated to
        self._fenced = False
        # managed = a router health monitor owns this frontend's failure
        # handling: a crashed loop must NOT close its streams (that would
        # terminate clients the monitor is about to migrate)
        self._managed = False
        self._fault_site = "serve.engine_step"          # set at start()
        self._close_listeners: List = []                # called at close()

    # ------------------------------------------------------------------ #
    # client surface (any thread / asyncio)
    # ------------------------------------------------------------------ #

    def submit(self, prompt: Sequence[int], priority: Optional[str] = None,
               max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               adapter: Optional[str] = None,
               tenant: Optional[str] = None) -> RequestHandle:
        """Enqueue one request; returns immediately with its stream handle.
        ``priority`` names a configured class; admission decides admit /
        hold / shed against that class's TTFT/TBT SLOs. ``adapter`` names a
        registered LoRA adapter to decode under (the tenant identity);
        ``tenant`` overrides the identity used for class mapping when it
        differs from the adapter name. An explicit ``priority`` wins;
        otherwise ``ServingConfig.tenant_classes`` maps the tenant to its
        class (default "standard")."""
        if self._closed or self._fenced:
            raise RuntimeError("frontend is closed"
                               if self._closed else
                               "frontend is fenced (replica down)")
        cls = self.config.class_for(priority,
                                    tenant if tenant is not None else adapter)
        if adapter is not None:
            lora = getattr(self.engine, "lora", None)
            if lora is None:
                raise RuntimeError(
                    "this engine serves no LoRA adapters — enable "
                    "RaggedInferenceEngineConfig.lora")
            lora.rank(adapter)      # raises for an unregistered adapter
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        self.check_budget(len(prompt), int(max_new_tokens))
        req = RequestHandle(next(self._uid_iter), prompt, cls,
                            int(max_new_tokens), eos_token_id,
                            time.perf_counter(), adapter=adapter)
        if not self._attribution:
            req._ledger = None
        with self._inflight_lock:
            self._inflight += 1
        self._ctl.put(("submit", req))
        return req

    def check_budget(self, n_prompt: int, max_new_tokens: int,
                     max_context: Optional[int] = None,
                     total_blocks: Optional[int] = None) -> None:
        """Raise ValueError unless a request of this shape can EVER be
        served here: every run-boundary reservation must fit max_context (a
        row one token from its budget still funds a whole slice at run
        start; speculative slices reserve ``decode_slice * (k + 1) + 1``),
        and the full KV lifetime must fit the pool — a request admitted
        optimistically past it would grow, be preempted, and wedge forever
        un-restorable. ONE home for the budget math: ``submit`` checks this
        frontend, and a ``ServingRouter`` passes the WEAKEST decode
        replica's ``max_context``/``total_blocks`` so a handoff can land on
        any of them."""
        sm = self.engine.config.state_manager
        if max_context is None:
            max_context = sm.max_context
        if total_blocks is None:
            total_blocks = self.engine.allocator.total_blocks
        slice_tokens = self.admission.slice_tokens
        need = n_prompt + max_new_tokens + slice_tokens
        if need > max_context:
            raise ValueError(
                f"prompt ({n_prompt}) + max_new_tokens ({max_new_tokens}) "
                f"+ slice reservation ({slice_tokens}) = {need} "
                f"exceeds max_context {max_context}")
        bs = self.engine.kv.config.block_size
        if -(-need // bs) > total_blocks:
            raise ValueError(
                f"request needs {-(-need // bs)} KV blocks at its budget but "
                f"the pool holds {total_blocks}")

    def submit_handoff(self, req: RequestHandle, pages, logits,
                       history=None) -> None:
        """Adopt a request PREFILLED ON ANOTHER REPLICA — the decode half of
        the disaggregated prefill/decode topology (``serving/cluster.py``).
        ``pages``/``logits`` are ``engine.export_kv``'s output from the
        prefill engine; the engine thread imports them (``engine.import_kv``
        — fresh pool ids, byte-exact content, re-seeded bootstrap row, the
        same restore discipline preemption uses) once the pool funds the
        pages plus a decode slice of growth, then admits the row directly to
        the decode pipeline. The handle's stream/cancel/result semantics are
        unchanged: tokens flow on this replica as if it had prefilled
        locally.

        ``history`` overrides the token record the import is keyed on
        (default: ``req.prompt``) — a failover SALVAGE of a
        preempt-offloaded victim (serving/health.py) hands off
        mid-generation, so its KV covers prompt + generated-so-far."""
        if self._closed or self._fenced:
            raise RuntimeError("frontend is closed"
                               if self._closed else
                               "frontend is fenced (replica down)")
        with self._inflight_lock:
            self._inflight += 1
        self._ctl.put(("handoff", (req, pages, logits, history)))

    def submit_resume(self, req: RequestHandle, history) -> None:
        """Adopt a request MIGRATED off a failed replica with no salvageable
        KV (serving/health.py): ``history`` is the sealed
        prompt + emitted-tokens snapshot. The engine thread files it as a
        recompute-preempted victim, so the existing restore path re-prefills
        the full history (radix-cache matches skip whatever a shared prefix
        already covers here) and the stream resumes byte-identically from
        the last emitted token. Raises when this replica cannot EVER fund
        the request (the caller tries the next survivor)."""
        if self._closed or self._fenced:
            raise RuntimeError("frontend is closed"
                               if self._closed else
                               "frontend is fenced (replica down)")
        self.check_budget(len(history),
                          max(1, req.max_new_tokens - len(req.tokens)))
        with self._inflight_lock:
            self._inflight += 1
        self._ctl.put(("resume", (req, np.asarray(history, np.int32))))

    def swap_weights(self, new_weights, version: Optional[int] = None,
                     timeout: Optional[float] = None) -> int:
        """Swap the engine's weights in place at the next run boundary: the
        serving half of the colocated rollout loop (``runtime/colocated.py``).

        The swap runs ON the engine thread between decode slices, where
        preemption runs: every live request is recompute-preempted (its KV
        dropped, prompt + tokens so far kept; the restore re-prefills under
        the NEW weights), offload-preempted victims and pending handoffs
        become recompute victims too (their parked KV pages are old-weight
        state), and the prefix cache flushes by weight version.
        Adapter-bound live requests shed, as ``_preempt``'s host-capacity
        fallback does (a base-only re-prefill of adapter-delta KV would
        diverge). No stream is served across the boundary with stale KV.

        Blocks until the swap is applied or refused; a refusal raises here
        and the loop keeps serving the OLD weights (the engine validates
        before it rebinds). Runs inline when no engine thread is running
        (synchronous ``step()`` loops). Returns the new
        ``weight_version``."""
        if self._closed or self._fenced:
            raise RuntimeError("frontend is closed"
                               if self._closed else
                               "frontend is fenced (replica down)")
        if self._thread is None or not self._thread.is_alive():
            return self._apply_swap(new_weights, version)
        done = threading.Event()
        box: Dict[str, object] = {}
        self._ctl.put(("swap", (new_weights, version, done, box)))
        if not done.wait(timeout if timeout is not None else 120.0):
            raise TimeoutError(
                "weight swap not applied within the timeout — the engine "
                "thread is wedged or a decode slice is extremely long")
        if "exc" in box:
            raise box["exc"]
        return box["version"]    # type: ignore[return-value]

    @property
    def outstanding(self) -> int:
        """Non-terminal requests (queued + prefilling + decoding +
        preempted)."""
        return len(self._reqs)

    def start(self) -> "ServingFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        # replica-scoped fault site (utils/fault_injection.py): a chaos plan
        # can target ONE replica's loop deterministically
        if self.stats.replica:
            self._fault_site = f"serve.engine_step.{self.stats.replica}"
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="dstpu-serve", daemon=True)
        self._thread.start()
        return self

    def fence(self) -> None:
        """Declare this frontend DOWN (serving/health.py): stop the loop and
        guarantee that nothing further is emitted into any stream — even if
        the engine thread is wedged inside a device call and only wakes
        later, ``_on_tokens``/``step`` observe the fence and drop
        everything. Migration then owns the in-flight handles."""
        self._fenced = True
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the engine thread to exit (True = it has; a wedged
        thread may outlive ``timeout`` — rejoin waits for a real join)."""
        t = self._thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def add_close_listener(self, fn) -> None:
        """``fn()`` runs at the START of ``close()`` — the router uses this
        to evict a closed replica's prefix-index entries and stop routing to
        it (a closed frontend must not keep attracting placements)."""
        self._close_listeners.append(fn)

    # -- failover support (serving/health.py; fenced/dead frontends only) -- #

    def _scrape_control(self) -> List[tuple]:
        """Drain the control queue WITHOUT handling (failover only: the
        loop is fenced or dead, and each undelivered message's request must
        migrate instead of vanishing)."""
        out = []
        while True:
            try:
                out.append(self._ctl.get_nowait())
            except queue.Empty:
                return out

    def disown(self, req: RequestHandle):
        """Remove every host-side trace of ``req`` from this fenced/dead
        frontend — dicts, admission queue, in-flight accounting — WITHOUT
        touching engine/device state (the dead engine is reclaimed
        wholesale at rejoin). Returns the request's pending handoff record,
        if any, so the migration can re-plan it."""
        uid = req.uid
        self._reqs.pop(uid, None)
        self._live.pop(uid, None)
        self._preempted.pop(uid, None)
        self.admission.remove(req)
        rec = None
        if self._handoffs:
            kept = []
            for h in self._handoffs:
                if h[0].uid == uid:
                    rec = h
                else:
                    kept.append(h)
            self._handoffs = kept
        with self._inflight_lock:
            self._inflight -= 1
        return rec

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted request reaches a terminal state (the
        loop keeps serving). True = drained; False = timed out."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._inflight > 0:
            if self._loop_exc is not None:
                raise RuntimeError("serving loop died") from self._loop_exc
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def close(self) -> None:
        """Stop the engine thread and cancel whatever is still in flight
        (KV flushed, offload buffers released, streams closed). Idempotent:
        double-close and close-before-first-submit are no-ops — a cluster
        teardown sweeping replicas must never trip over one it (or a test)
        already closed. A died engine thread still raises, once, with the
        teardown fully finished first."""
        if self._closed:
            return
        for fn in self._close_listeners:
            fn()
        self._close_listeners = []
        self._stop.set()
        if self._thread is not None:
            # a FENCED frontend may hold a permanently wedged thread (the
            # stall failure mode the health monitor fences around): close
            # must not hang the whole cluster teardown on it. Its requests
            # were already migrated; skip the engine-touching teardown the
            # wedged thread could still race and leave state to rejoin.
            self._thread.join(5.0 if self._fenced else None)
            if self._thread.is_alive():
                from deepspeed_tpu_torch.utils.logging import log_dist
                log_dist("frontend close: engine thread still wedged after "
                         "fence; abandoning it (daemon) without teardown",
                         ranks=[0])
                self._closed = True
                if self._loop_exc is not None:
                    exc, self._loop_exc = self._loop_exc, None
                    raise RuntimeError("serving loop died") from exc
                return
            self._thread = None
        # engine-thread state is safe to touch now (thread joined / never ran)
        self._drain_control()
        for req in list(self._reqs.values()):
            self._teardown(req, CANCELLED)
        if self.offload is not None:
            self.offload.close()
        self._closed = True
        if self._loop_exc is not None:
            exc, self._loop_exc = self._loop_exc, None
            raise RuntimeError("serving loop died") from exc

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def write_monitor_events(self, monitor, step: int = 0) -> None:
        """Emit the ``serve/frontend/*`` counters through a ``monitor/``
        backend (``MonitorMaster.write_events`` shape)."""
        monitor.write_events(self.stats.events(step))

    # ------------------------------------------------------------------ #
    # the engine thread
    # ------------------------------------------------------------------ #

    @thread_role("dstpu-serve")
    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                if not self.step():
                    if self._fenced:
                        break                 # failover owns the queue now
                    try:                      # idle: block on control traffic
                        msg = self._ctl.get(timeout=self.config.idle_wait_s)
                    except queue.Empty:
                        continue
                    if self._fenced:
                        self._ctl.put(msg)    # failover's scrape owns it
                        break
                    self._handle(msg)
        except BaseException as exc:          # surface at drain()/close() —
            self._loop_exc = exc              # a dead server must not hang
            if not self._managed:
                # unmanaged: a dead server must not hang its clients. Under
                # a router health monitor the streams stay OPEN — failover
                # migrates them to a survivor (or terminal-states them)
                for req in list(self._reqs.values()):
                    req._q.put(_DONE)         # unblock stream readers
                    req._finished.set()

    def step(self) -> bool:
        """ONE frontend iteration: control drain -> cancellation sweep ->
        handoff imports -> admission plan -> prefill -> one decode slice.
        Public so tests and deterministic bench phases can drive the loop
        synchronously (no thread); returns False when the iteration found
        no work (idle)."""
        # chaos site (raise = crash this loop, stall = wedge it); the fence
        # check sits AFTER it so a stalled thread that wakes post-failover
        # bails before touching any state migration already disowned
        maybe_fail(self._fault_site)
        if self._fenced:
            return False
        self._drain_control()
        self._sweep_cancels()
        worked = self._execute_handoffs()
        worked = self._admission_round() or worked
        if self._pipe.uids:
            self._decode_slice()
            worked = True
        return worked

    def _handle(self, msg) -> None:
        kind, payload = msg
        if kind == "submit":
            req = payload
            self._reqs[req.uid] = req
            self.stats.record_submit(req.cls.name)
            if not self.admission.enqueue(req):
                self._finalize(req, SHED)     # queue full: immediate shed
        elif kind == "handoff":
            req, pages, logits, history = payload
            with req._emit_lock:
                req._sealed = False    # adoption: emission is ours now (a
                # no-op for normal disagg handoffs, which were never sealed)
            self._reqs[req.uid] = req
            self.stats.record_submit(req.cls.name)
            if len(self._handoffs) >= self.config.max_queue:
                # back-pressure: every held handoff pins a full sequence's
                # KV pages in host memory — past the same bound the local
                # queue sheds at, shed rather than accumulate without limit
                self._finalize(req, SHED)
            else:
                self._handoffs.append((req, pages, logits, history))
        elif kind == "resume":
            # failover migration (serving/health.py): adopt as a
            # recompute-preempted victim — the restore path re-prefills the
            # sealed history and the stream resumes from its last token
            req, history = payload
            with req._emit_lock:
                req._sealed = False    # adoption: emission is ours now
            self._reqs[req.uid] = req
            self.stats.record_submit(req.cls.name)
            req._resume_tokens = history
            now = time.perf_counter()
            # failover re-home: the ``migration`` stint runs from the seal
            # stamp (health.py closes the orphaned phase there and re-bases
            # _phase_t0) to this adoption on the survivor's engine thread
            self._span(req, "migration", req._phase_t0, now)
            req.status = PREEMPTED
            req.preempt_t = req._phase_t0 = now
            self._preempted[req.uid] = req
        elif kind == "swap":
            # weight swap (colocated rollout): runs HERE, on the engine
            # thread between decode slices; a refusal reports to the waiting
            # caller and the loop keeps serving the old weights
            new_weights, version, done, box = payload
            try:
                box["version"] = self._apply_swap(new_weights, version)
            except BaseException as exc:
                box["exc"] = exc
            finally:
                done.set()
        # cancellation rides the handle's event (no message): the sweeps /
        # on_tokens observe it within one iteration, and an idle loop ticks
        # every idle_wait_s — disconnects are never waited on indefinitely

    def _drain_control(self) -> None:
        while True:
            try:
                self._handle(self._ctl.get_nowait())
            except queue.Empty:
                return

    def _sweep_cancels(self) -> None:
        """Client disconnects for requests NOT currently decoding (those are
        caught token-by-token in ``_on_tokens``): queued requests leave the
        admission queue; preempted ones drop their offloaded pages / resume
        record and flush their kept KV."""
        for req in list(self._reqs.values()):
            if req.cancelled and req.status in (QUEUED, PREEMPTED):
                self._teardown(req, CANCELLED)

    def _teardown(self, req: RequestHandle, status: str) -> None:
        """Release every resource a request holds in its CURRENT lifecycle
        stage, then finalize. The one path cancellation, shedding and
        close-time abandonment all funnel through — the allocator-leak
        regression test cancels at every stage against this."""
        uid = req.uid
        if req.status == QUEUED:
            self.admission.remove(req)
        if self._handoffs:
            # a handoff still awaiting import holds only host arrays — drop
            # the record so a later import cannot resurrect a finalized uid
            self._handoffs = [h for h in self._handoffs if h[0].uid != uid]
        if uid in self._live:
            self._pipe.retire([uid])
            del self._live[uid]
        if uid in self._preempted:
            del self._preempted[uid]
            if self.offload is not None and uid in self.offload._recs:
                self.offload.drop(uid)
        if uid in self.engine.scheduler.seqs:
            self.engine.flush([uid])
        self._finalize(req, status)

    def _finalize(self, req: RequestHandle, status: str) -> None:
        self._lora_release(req)
        now = time.perf_counter()
        if req.status == DECODING:
            # the ledger's final decode stint ends at the LAST-EMISSION
            # stamp (the client-visible end the SLOs are defined over), so
            # a finished request's stints sum to TTFT + Σ TBT exactly; the
            # trace span keeps the full stint through run-boundary
            # retirement — both read the same stamp set
            self._span(req, "decode", req._phase_t0, now, ledger=False)
            end = req._last_emit_t if (status == FINISHED
                                       and req._last_emit_t is not None
                                       and req._last_emit_t >= req._phase_t0) \
                else now
            req._ledger_add("decode", req._phase_t0, end)
        req.status = status
        self._reqs.pop(req.uid, None)
        if status == FINISHED:
            slo_met = (req.ttft_ms is not None
                       and req.ttft_ms <= req.cls.ttft_slo_ms
                       and (not req.tbt_ms or float(np.percentile(
                            np.asarray(req.tbt_ms, np.float64), 95))
                            <= req.cls.tbt_slo_ms))
            self.stats.record_complete(req.cls.name, req.ttft_ms, req.tbt_ms,
                                       len(req.tokens), slo_met)
            if not slo_met:
                # SLO-miss attribution: bucket the miss by where the
                # latency actually went (serve/slo/* — docs/OBSERVABILITY.md)
                attr = req.attribution()
                client = attr["client_s"]
                consistent = (client is not None
                              and abs(attr["total_s"] - client)
                              <= attribution_epsilon(client))
                self.stats.record_slo_miss(
                    req.cls.name, attr["dominant"] or "unattributed",
                    consistent)
        elif status == SHED:
            self.stats.record_shed(req.cls.name)
            if _tracer.enabled:
                _tracer.instant("serve/req/shed", lane=f"serve/req/u{req.uid}",
                                uid=req.uid, trace_id=req.trace_id,
                                cls=req.cls.name)
        elif status == CANCELLED:
            self.stats.record_cancel(req.cls.name)
            if _tracer.enabled:
                _tracer.instant("serve/req/cancelled",
                                lane=f"serve/req/u{req.uid}", uid=req.uid,
                                trace_id=req.trace_id)
        req._q.put(_DONE)
        req._finished.set()
        with self._inflight_lock:
            self._inflight -= 1

    def _span(self, req: RequestHandle, phase: str, t0: float,
              t1: float, ledger: bool = True) -> None:
        """One phase stint: a ``serve/req/<phase>`` span on the request's
        trace lane AND (unless ``ledger=False`` — used where the ledger
        entry needs different endpoints or a different phase name) an
        attribution-ledger entry, from one set of perf stamps."""
        if ledger:
            req._ledger_add(phase, t0, t1)
        if _tracer.enabled:
            _tracer.add(f"serve/req/{phase}", t0, t1,
                        lane=f"serve/req/u{req.uid}", uid=req.uid,
                        trace_id=req.trace_id, cls=req.cls.name)

    def _admit_pipe(self, req: RequestHandle) -> None:
        """Admit to the decode pipeline; a speculative pipeline gets the
        request's full prompt + generated history so the n-gram proposer
        can match across preempt/restore boundaries (the scheduler's
        recorded history misses device-generated tokens)."""
        if self._spec:
            self._pipe.admit([req.uid], histories=[np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])])
        else:
            self._pipe.admit([req.uid])

    # ------------------------------------------------------------------ #
    # LoRA adapter bindings (engine thread only)
    # ------------------------------------------------------------------ #

    def _lora_acquire(self, req: RequestHandle) -> bool:
        """Bind ``req``'s adapter and make its pages resident (fault-in from
        host under pool pressure happens HERE, in the admission/restore
        round — never inside a decode slice, so a cold adapter fault cannot
        stall a hot tenant's token cadence). False means the pool cannot
        fund the adapter right now (every resident adapter is pinned by
        in-flight rows): the caller defers the request and retries when
        refcounts drop. Chaos faults (``serve.lora_fault``) propagate —
        the loop's crash semantics, same as a KV fetch fault."""
        if req.adapter is None or req._lora_held:
            return True
        try:
            self.engine.lora.acquire(req.uid, req.adapter)
        except RuntimeError:          # pool pressure raced the plan: hold
            return False
        req._lora_held = True
        return True

    def _lora_release(self, req: RequestHandle) -> None:
        """Drop the adapter binding (idempotent). The pages stay resident —
        LRU-cached for the tenant's next request — until pool pressure
        evicts them to pinned host buffers."""
        if req._lora_held:
            self.engine.lora.release(req.uid)
            req._lora_held = False

    # ------------------------------------------------------------------ #
    # cross-replica handoffs (disaggregated prefill/decode)
    # ------------------------------------------------------------------ #

    def _execute_handoffs(self) -> bool:
        """Import pending cross-replica handoffs the pool can fund: fresh
        pages for the KV content plus one decode slice of growth, a decode
        row and a tracked slot — the same budget math the admission plan
        simulates, so a handoff never starves the live set's next slice.
        Unfundable handoffs stay queued and retry next iteration (capacity
        returns through retirement/preemption like any admission)."""
        if not self._handoffs:
            return False
        sched = self.engine.scheduler
        sm = self.engine.config.state_manager
        slice_tokens = self.admission.slice_tokens
        did = False
        held = []
        for rec in self._handoffs:
            if self._fenced:
                held.append(rec)
                continue
            req, pages, logits, history = rec
            if req.cancelled:
                self._finalize(req, CANCELLED)
                did = True
                continue
            need = len(pages) + self.admission._blocks(slice_tokens)
            if need > self.engine.allocator.total_blocks:
                # can NEVER fund on this replica (router validation should
                # have caught it) — shed now rather than hold forever
                self._finalize(req, SHED)
                did = True
                continue
            budget = sched.available_blocks \
                - sched.blocks_needed(list(self._live), slice_tokens)
            if (need > budget
                    or len(self._live) >= sm.max_ragged_sequence_count
                    or len(sched.seqs) >= sm.max_tracked_sequences):
                held.append(rec)
                continue
            if not self._lora_acquire(req):
                held.append(rec)     # adapter pool pressure: retry later
                continue
            t0 = time.perf_counter()
            try:
                self.engine.import_kv(
                    req.uid,
                    req.prompt if history is None else history,
                    pages, logits)
            except (ValueError, RuntimeError) as exc:
                # a malformed/oversized handoff must close ONE stream, not
                # kill the replica's serving loop (and every other stream)
                from deepspeed_tpu_torch.utils.logging import log_dist
                log_dist(f"handoff import for uid {req.uid} failed: {exc}; "
                         "shedding the request", ranks=[0])
                self._finalize(req, SHED)
                did = True
                continue
            t1 = time.perf_counter()
            # import-work span first, then the enclosing wait (inner E
            # before outer E at the shared end ts): ``handoff_wait`` runs
            # from the prefill replica's last stamp to import completion —
            # the cross-replica gap the disaggregated ledger must cover; a
            # failover SALVAGE (history != None) or RE-PLANNED handoff
            # (req._migrating) is a ``migration`` stint from its seal
            # stamp instead
            self._span(req, "handoff", t0, t1, ledger=False)
            self._span(req,
                       "migration" if (history is not None or req._migrating)
                       else "handoff_wait",
                       req._phase_t0, t1)
            req._migrating = False
            req.status = DECODING
            req.admit_t = req._phase_t0 = t1
            self.stats.record_admit(req.cls.name)
            self._admit_pipe(req)
            self._live[req.uid] = req
            did = True
        self._handoffs = held
        return did

    # ------------------------------------------------------------------ #
    # admission round: execute the plan
    # ------------------------------------------------------------------ #

    def _admission_round(self) -> bool:
        now = time.perf_counter()
        actions = self.admission.plan(now, self._live, self._preempted,
                                      self.offload)
        admitted: List[RequestHandle] = []
        for kind, req in actions:
            if kind == "shed":
                self._finalize(req, SHED)
            elif kind == "preempt":
                self._preempt(req)
            elif kind == "restore":
                self._restore(req)
            elif kind == "admit":
                if not self._lora_acquire(req):
                    # adapter pool pressure raced the plan: hold (refcounts
                    # drop as live rows finish; the plan retries next round)
                    self.admission._queues[req.cls.name].appendleft(req)
                    continue
                try:
                    self.engine.scheduler.add_tokens(req.uid, req.prompt)
                except RuntimeError:           # capacity raced the plan: hold
                    self._lora_release(req)
                    self.admission._queues[req.cls.name].appendleft(req)
                    continue
                t = time.perf_counter()
                # ledger splits the wait at this admission round's plan
                # stamp: ``queued`` (arrival -> round) + ``admission``
                # (round -> scheduler attach); the lane span keeps the
                # whole wait as one ``queued`` stint — same stamps
                self._span(req, "queued", req.arrival_t, t, ledger=False)
                if now > req._phase_t0:
                    req._ledger_add("queued", req._phase_t0, now)
                req._ledger_add("admission", max(now, req._phase_t0), t)
                req.status = PREFILL
                req.admit_t = req._phase_t0 = t
                self.stats.record_admit(req.cls.name)
                admitted.append(req)
        if admitted or self.engine.scheduler.has_pending():
            self._prefill(admitted)
        self.stats.queue_depth = self.admission.queued
        # KV-pool residency gauges, refreshed at the same cadence as
        # queue_depth (one admission round): free blocks + tracked
        # sequences feed the resident-sequence-headroom view the capacity
        # doubling is read from (docs/SERVING.md "Quantized KV")
        self.stats.kv_free_blocks = self.engine.allocator.free_blocks
        self.stats.kv_resident_seqs = len(self.engine.scheduler.seqs)
        if _tracer.enabled:
            _tracer.counter("serve/frontend/queue_depth",
                            self.stats.queue_depth, lane="serve/frontend")
            _tracer.counter("serve/frontend/kv_free_blocks",
                            self.stats.kv_free_blocks, lane="serve/frontend")
        return bool(actions)

    def _prefill(self, reqs: List[RequestHandle]) -> None:
        """Drain the admitted batch's prompt chunks through SplitFuse passes,
        polling client disconnects at every pass boundary (cancel-mid-prefill
        retires through ``scheduler.flush`` with partial KV released)."""
        e = self.engine
        t0 = time.perf_counter()
        tokens = sum(len(r.prompt) for r in reqs)
        while e.scheduler.has_pending():
            e._run_pass()
            if self._fenced:
                return       # fenced mid-prefill: failover owns every handle
            for req in reqs:
                if req.cancelled and req.status == PREFILL:
                    self._teardown(req, CANCELLED)
        t1 = time.perf_counter()
        # intentionally async: the EMA cost model wants the loop-observed
        # prefill cadence (what admission actually waits), not device time
        self.admission.cost.update_prefill(tokens, t1 - t0)
        for req in reqs:
            if req.status != PREFILL:
                continue                       # cancelled mid-prefill
            self._span(req, "prefill", req._phase_t0, t1)
            req.status = DECODING
            req._phase_t0 = t1
            self._admit_pipe(req)
            self._live[req.uid] = req

    # ------------------------------------------------------------------ #
    # preempt / restore
    # ------------------------------------------------------------------ #

    def _preempt(self, req: RequestHandle) -> None:
        uid = req.uid
        now = time.perf_counter()
        self._span(req, "decode", req._phase_t0, now)
        self._pipe.retire([uid])
        self._live.pop(uid, None)
        kept, tail = self.engine.scheduler.private_tail(uid)
        if self.offload is not None and self.offload.can_offload(len(tail)):
            n = self.offload.offload(uid, kept, tail)
            self.stats.offload_bytes += n
        elif req.adapter is not None:
            # the host-capacity recompute fallback would re-prefill this
            # row's decode-written KV base-only, but it carries the
            # adapter's k/v deltas — a silently byte-divergent stream on
            # restore; shed honestly instead (base rows recompute fine:
            # their zero-page deltas are an exact +0.0)
            self.stats.forced_sheds += 1
            self._teardown(req, SHED)
            return
        else:
            # recompute preemption (the configured baseline, or the
            # host-capacity fallback): drop all KV, remember the tokens —
            # readmission re-prefills prompt + generated-so-far
            req._resume_tokens = np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])
            self.engine.flush([uid])
            self.stats.recompute_preemptions += 1
        # binding drops across the preempted window (the request holds no
        # decode gathers); _restore re-acquires — faulting pages back in if
        # pressure evicted them meanwhile
        self._lora_release(req)
        req.status = PREEMPTED
        req.preempt_t = req._phase_t0 = now
        req.preemptions += 1
        self._preempted[uid] = req
        self.stats.preemptions += 1

    def _apply_swap(self, new_weights, version: Optional[int]) -> int:
        """Quiesce every holder of old-weight KV, then rebind the engine's
        weights (engine thread, or a synchronous caller). The quiesce is not
        rolled back if the engine refuses the tree: preempted requests
        re-prefill under whichever weights are live when they restore,
        which is right either way."""
        for req in list(self._live.values()):
            self._preempt_for_swap(req)
        if self.offload is not None:
            # offload-preempted victims parked old-weight KV pages on the
            # host: a byte-exact restore would bring stale state back under
            # the new weights, so they become recompute victims. Their
            # sequences, which still hold the kept shared-prefix pages, are
            # flushed too: the JAX frontend leaves them live, and its engine
            # then refuses the swap
            for uid, req in list(self._preempted.items()):
                if uid in self.offload._recs:
                    self.offload.drop(uid)
                    self.engine.flush([uid])
                    req._resume_tokens = np.concatenate(
                        [req.prompt, np.asarray(req.tokens, np.int32)])
                    self.stats.recompute_preemptions += 1
        if self._handoffs:
            # handoffs awaiting import hold another replica's old-weight KV
            # in host buffers: each is adopted as a recompute victim instead
            # (the shape the failover "resume" path uses)
            now = time.perf_counter()
            for req, _pages, _logits, history in self._handoffs:
                req._resume_tokens = np.asarray(history, np.int32)
                req.status = PREEMPTED
                req.preempt_t = req._phase_t0 = now
                self._preempted[req.uid] = req
            self._handoffs = []
        return self.engine.swap_weights(new_weights, version=version)

    def _preempt_for_swap(self, req: RequestHandle) -> None:
        """Preempt one live request for a weight swap: ALWAYS recompute
        (never offload: parked KV would be stale-weight state on restore);
        adapter-bound requests shed, the same rule as ``_preempt``'s
        host-capacity fallback (decode-written KV carries the adapter's k/v
        deltas, which a base-only re-prefill would lose)."""
        uid = req.uid
        now = time.perf_counter()
        self._span(req, "decode", req._phase_t0, now)
        self._pipe.retire([uid])
        self._live.pop(uid, None)
        if req.adapter is not None:
            self.stats.forced_sheds += 1
            self._teardown(req, SHED)
            return
        req._resume_tokens = np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
        self.engine.flush([uid])
        self.stats.recompute_preemptions += 1
        self._lora_release(req)
        req.status = PREEMPTED
        req.preempt_t = req._phase_t0 = now
        req.preemptions += 1
        self._preempted[uid] = req
        self.stats.preemptions += 1

    def _restore(self, req: RequestHandle) -> None:
        uid = req.uid
        if not self._lora_acquire(req):
            return       # adapter pool pressure: stay preempted, retry later
        t0 = time.perf_counter()
        if self.offload is not None and uid in self.offload._recs:
            self._span(req, "preempted", req._phase_t0, t0)
            # re-base NOW, not at the end of the restore: a fence landing
            # mid-restore early-returns before the tail re-base, and the
            # failover's _close_phase would otherwise append a second,
            # overlapping 'preempted' stint from the stale stamp
            req._phase_t0 = t0
            del self._preempted[uid]
            self.stats.restore_bytes += self.offload.restore(uid)
        else:
            try:
                self.engine.scheduler.add_tokens(uid, req._resume_tokens)
            except RuntimeError:
                return              # capacity raced the plan: stay preempted
            self._span(req, "preempted", req._phase_t0, t0)
            req._phase_t0 = t0           # see the offload branch above
            del self._preempted[uid]
            req._resume_tokens = None
            e = self.engine
            while e.scheduler.has_pending():
                e._run_pass()
                if self._fenced or req.cancelled:
                    break
            if self._fenced:
                return       # a wedged restore waking post-failover must not
                # resurrect a handle the migration already re-homed
            if req.cancelled:
                self._teardown(req, CANCELLED)
                return
        t1 = time.perf_counter()
        if self._fenced:
            return
        self._span(req, "restore", t0, t1)
        req.status = DECODING
        req._phase_t0 = t1
        if req.admit_t is None:
            # a failover-migrated request that was still QUEUED on the dead
            # replica reaches the live set through this path without ever
            # being admitted — the victim ordering needs a real stamp
            req.admit_t = t1
        self._admit_pipe(req)
        self._live[uid] = req
        self.stats.restores += 1

    # ------------------------------------------------------------------ #
    # the decode slice
    # ------------------------------------------------------------------ #

    def _ensure_slice_funded(self) -> None:
        """Emergency lever when generation-driven KV growth outruns the
        pool between admission rounds: preempt (or, reject-only, force-shed)
        the newest lowest-priority live rows until the next slice funds."""
        while self._live:
            short = self.admission.slice_shortfall(list(self._live))
            if short <= 0:
                return
            order = {c.name: i for i, c in
                     enumerate(sorted(self.config.classes,
                                      key=lambda c: -c.priority))}
            victim = max(self._live.values(),
                         key=lambda r: (order[r.cls.name], r.admit_t))
            if self.config.preemption == "none":
                self.stats.forced_sheds += 1
                self._teardown(victim, SHED)
            else:
                self._preempt(victim)

    def _on_tokens(self, j: int, uids: List[int], row):
        """Per-step drain callback — the serving hot path. Clock stamps,
        int appends and queue puts only: no device fetch, no formatting.

        Spec-aware stream accounting: a speculative step delivers each
        row's token BATCH (accepted draft prefix + bonus) in one drain, so
        a k-token accept emits k+1 stream tokens from one step. All of a
        batch becomes host-visible simultaneously — the client-observed
        latency the SLOs are defined over — so the batch's FIRST token
        carries the inter-step gap and the rest record 0 ms TBT; tokens
        past ``max_new_tokens``/EOS within a batch are discarded (in-step
        overshoot, flushed with the request at the run boundary)."""
        now = time.perf_counter()
        if self._fenced:
            return list(uids)                  # down: emit nothing, stop all
        stop = None
        for i, u in enumerate(uids):
            req = self._live.get(u)
            if req is None:
                continue                       # stopped earlier this run
            batch = row[i] if self._spec else row[i:i + 1]
            # emission rides the handle's seal lock (uncontended except at
            # the instant a failover migration snapshots the stream): a
            # sealed handle belongs to another replica now — drop the row
            with req._emit_lock:
                if req._sealed:
                    continue
                for bi in range(len(batch)):
                    t = int(batch[bi])
                    req.tokens.append(t)
                    req._q.put(t)
                    # TTFT/TBT stamp the moment the token became
                    # host-visible — the client-observed latency the SLOs
                    # are defined over; the sync point is the drain inside
                    # pipe.run (fetch_to_host)
                    if req.ttft_ms is None:
                        req.ttft_ms = 1e3 * (now - req.arrival_t)
                    elif bi == 0:
                        req.tbt_ms.append(1e3 * (now - req._last_emit_t))
                    else:
                        req.tbt_ms.append(0.0)  # same-drain sibling token
                    req._last_emit_t = now
                    done = (len(req.tokens) >= req.max_new_tokens
                            or (req.eos_token_id is not None
                                and t == req.eos_token_id))
                    if done or req.cancelled:
                        del self._live[u]
                        self._run_stopped.append(req)
                        req._stop_status = CANCELLED \
                            if (req.cancelled and not done) else FINISHED
                        if stop is None:
                            stop = []
                        stop.append(u)
                        break
        return stop

    def _decode_slice(self) -> None:
        if self._fenced:
            return
        self._ensure_slice_funded()
        if not self._pipe.uids:
            return
        t0 = time.perf_counter()
        self._pipe.run(self.config.decode_slice, on_tokens=self._on_tokens)
        # run() drains every step's token row (fetch_to_host), so this wall
        # time is real work, not enqueue time
        self.admission.cost.update_decode(time.perf_counter() - t0)
        stopped, self._run_stopped = self._run_stopped, []
        for req in stopped:
            # retired mid-run by the callback: the pipeline dropped its refs;
            # release the KV and close the stream at this run boundary
            self.engine.flush([req.uid])
            self._finalize(req, req._stop_status)
