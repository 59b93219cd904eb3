"""Span tracing: one Perfetto-exportable timeline across every lane (the
JAX package's ``monitor/trace.py``, copied; same environment names and
file format, so ``scripts/trace_check.py`` and ``scripts/request_autopsy.py``
read the port's traces unchanged).

Every lane records **spans** (named intervals with ``perf_counter``
endpoints) into a per-thread preallocated ring buffer, and the exporter
writes Chrome-trace/Perfetto JSON where each lane is its own named track.

- **no device syncs**: spans only ever read ``time.perf_counter()``; no
  recording path touches a tensor.
- **no formatting on the hot path**: a record is one small tuple stored
  into a preallocated slot; all JSON formatting happens at export time.
- **bounded memory**: each thread keeps only the newest ``ring_size``
  spans. That bound is also the flight recorder: ``crash_dump`` writes the
  rings to ``trace_crash.json``, and the normal rings export from an
  atexit hook.
- **a no-op when disabled**: ``add()`` returns at once and ``span()`` hands
  back a shared no-op context manager; hot-path call sites also guard on
  ``tracer.enabled``.

Two recording APIs:

- ``tracer.add(name, t0, t1, lane=..., **args)`` records a COMPLETED span
  from ``perf_counter`` stamps the call site already took for its stats
  counters (the serving frontend's ``serve/req/*`` stints, the router's
  ``serve/router/*`` placements, the health monitor's ``serve/health/*``
  detections), so the counters and the timeline read one measurement;
- ``with tracer.span(name, lane=..., **args):`` for worker lanes where the
  span IS the timing.

``instant(name)`` marks a point event; ``counter(name, value)`` records a
counter track sample (queue depths). A span lands on its thread's track
unless ``lane=`` names one; spans whose args carry a ``trace_id`` are bound
into one Perfetto flow chain per request at export.

Enable with ``DSTPU_TRACE=<dir>`` (``install_from_env``; ring size
``DSTPU_TRACE_RING``, request-lane window ``DSTPU_TRACE_REQ_LANES``) or
``tracer.configure(trace_dir=...)``.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.threads import make_lock

_ENV_VAR = "DSTPU_TRACE"
_ENV_RING = "DSTPU_TRACE_RING"
_ENV_REQ_LANES = "DSTPU_TRACE_REQ_LANES"

#: default spans retained per thread (the flight-recorder window)
DEFAULT_RING_SIZE = 16384

#: per-request ``serve/req/u<uid>`` lanes exported under their OWN track —
#: beyond this window (newest by last activity), retired requests' lanes are
#: recycled onto a bounded pool of ``serve/req/recycled/<k>`` tracks (the
#: exporter-side mirror of the dead-ring sweep: a long serving run must not
#: grow one timeline row per uid forever)
DEFAULT_REQ_LANE_WINDOW = 64

#: lanes subject to the recycling window
_REQ_LANE_RE = re.compile(r"^serve/req/u\d+$")

# record kinds (Chrome trace phase at export: span -> B/E pair)
_SPAN, _INSTANT, _COUNTER = "X", "i", "C"


#: dead threads' rings retained for export/crash dumps (a finished prefetch
#: producer's spans must still reach the timeline) — beyond this, the OLDEST
#: dead rings are pruned at ring registration so thread churn (per-epoch
#: producers, rebuilt writer pools) cannot grow memory without bound
MAX_DEAD_RINGS = 32


class _Ring:
    """One thread's preallocated record ring. Single writer (the owning
    thread), lock-free: ``buf[idx % cap] = rec; idx += 1``. Readers (export)
    snapshot racily — a slot is either an old record or a new one, never a
    torn value (CPython list-slot stores are atomic)."""

    __slots__ = ("buf", "idx", "cap", "thread_name", "thread_id", "thread")

    def __init__(self, cap: int, thread: threading.Thread):
        self.buf: List[Optional[tuple]] = [None] * cap
        self.idx = 0
        self.cap = cap
        self.thread_name = thread.name
        self.thread_id = thread.ident or 0
        self.thread = thread   # liveness probe for dead-ring pruning

    def add(self, rec: tuple) -> None:
        self.buf[self.idx % self.cap] = rec
        self.idx += 1

    def snapshot(self) -> List[tuple]:
        """Records in insertion order, oldest kept first (newest ``cap``)."""
        n = self.idx
        if n <= self.cap:
            return [r for r in self.buf[:n] if r is not None]
        i = n % self.cap
        return [r for r in self.buf[i:] + self.buf[:i] if r is not None]


class _NoopSpan:
    """Shared do-nothing context manager handed out while tracing is
    disabled — zero per-call allocation on the disabled path."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopSpan()


class Span:
    """Context manager recording one interval on exit; ``.seconds`` is valid
    after exit (call sites may feed it to their stats counters)."""

    __slots__ = ("_tracer", "name", "lane", "args", "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, lane: Optional[str],
                 args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.lane = lane
        self.args = args
        self.t0 = 0.0
        self.t1 = 0.0

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter()
        self._tracer._record((_SPAN, self.name, self.t0, self.t1, self.lane,
                              self.args))
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """The process-wide tracer (module singleton: :data:`tracer`)."""

    def __init__(self):
        self.enabled = False
        self.trace_dir = ""
        self.ring_size = DEFAULT_RING_SIZE
        self.req_lane_window = DEFAULT_REQ_LANE_WINDOW
        self._rings: List[_Ring] = []
        self._local = threading.local()
        self._reg_lock = make_lock("monitor.trace.registry")
        self._atexit_installed = False
        self._crash_path: Optional[str] = None
        # one simultaneous (perf_counter, unix) pair: trace_merge.py maps
        # every file's perf-based timestamps onto one wall-clock axis with it
        self._clock_sync = (time.perf_counter(), time.time())

    # ------------------------------------------------------------------ #
    # configuration
    # ------------------------------------------------------------------ #

    def configure(self, trace_dir: str = "", enabled: Optional[bool] = None,
                  ring_size: Optional[int] = None,
                  req_lane_window: Optional[int] = None) -> "Tracer":
        """Enable (or reconfigure) tracing. ``trace_dir`` nonempty implies
        enabled and is where the exporter + flight recorder write; an empty
        dir with ``enabled=True`` records rings without an export target
        (tests, in-process overhead measurement). ``req_lane_window`` bounds
        how many per-request ``serve/req/u<uid>`` lanes export under their
        own track (older ones recycle onto a pooled track set)."""
        if trace_dir:
            self.trace_dir = trace_dir
        if ring_size:
            self.ring_size = max(16, int(ring_size))
        if req_lane_window is not None:
            self.req_lane_window = max(0, int(req_lane_window))
        if enabled is None:
            enabled = bool(trace_dir) or self.enabled
        self.enabled = bool(enabled)
        if self.enabled and not self._atexit_installed:
            self._atexit_installed = True
            atexit.register(self._atexit_export)
        return self

    def reset(self) -> None:
        """Drop every ring and disable (tests). Threads re-register their
        rings lazily on the next record."""
        with self._reg_lock:
            self._rings = []
        self._local = threading.local()
        self.enabled = False
        self.trace_dir = ""
        self.ring_size = DEFAULT_RING_SIZE
        self.req_lane_window = DEFAULT_REQ_LANE_WINDOW
        self._crash_path = None
        self._clock_sync = (time.perf_counter(), time.time())

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self.ring_size, threading.current_thread())
            self._local.ring = ring
            with self._reg_lock:
                # registration is the rare, already-locked path: prune the
                # OLDEST dead rings beyond the retention bound here so
                # thread churn never grows the registry without bound
                dead = [r for r in self._rings if not r.thread.is_alive()]
                if len(dead) > MAX_DEAD_RINGS:
                    drop = set(map(id, dead[:len(dead) - MAX_DEAD_RINGS]))
                    self._rings = [r for r in self._rings
                                   if id(r) not in drop]
                self._rings.append(ring)
        return ring

    def _record(self, rec: tuple) -> None:
        if self.enabled:
            self._ring().add(rec)

    def register_thread(self) -> None:
        """Pre-register the calling thread's ring so later records are
        lock-free appends. A thread's FIRST record otherwise acquires the
        registry lock at whatever call site it happens to land on — callers
        that record under their own locks use this to keep the registry
        acquisition outside them (lock-order hygiene)."""
        if self.enabled:
            self._ring()

    def add(self, name: str, t0: float, t1: float, lane: Optional[str] = None,
            **args: Any) -> None:
        """Record a completed span from ``time.perf_counter()`` endpoints the
        call site already measured (the zero-extra-clock hot-path form)."""
        if not self.enabled:
            return
        self._ring().add((_SPAN, name, t0, t1, lane, args or None))

    def span(self, name: str, lane: Optional[str] = None, **args: Any):
        """Context manager recording ``name`` over the with-body. Returns a
        shared no-op when disabled."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, lane, args or None)

    def instant(self, name: str, lane: Optional[str] = None, **args: Any) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        self._ring().add((_INSTANT, name, now, now, lane, args or None))

    def counter(self, name: str, value: float, lane: Optional[str] = None) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        self._ring().add((_COUNTER, name, now, now, lane,
                          {"value": float(value)}))

    # ------------------------------------------------------------------ #
    # aggregation (the stats classes' view of the same measurements)
    # ------------------------------------------------------------------ #

    def summary(self) -> Dict[str, Tuple[int, float]]:
        """``{span name: (count, total seconds)}`` over everything currently
        retained — the derived-aggregation view the monitor stat classes
        mirror per window (tests cross-check the two against each other)."""
        out: Dict[str, Tuple[int, float]] = {}
        with self._reg_lock:
            rings = list(self._rings)
        for ring in rings:
            for rec in ring.snapshot():
                if rec[0] != _SPAN:
                    continue
                _, name, t0, t1, _, _ = rec
                cnt, tot = out.get(name, (0, 0.0))
                out[name] = (cnt + 1, tot + (t1 - t0))
        return out

    def iter_records(self) -> Iterator[tuple]:
        """Snapshot every retained raw record ``(kind, name, t0, t1, lane,
        args)`` across all rings — benches and tests assert on request flow
        chains (spans sharing a ``trace_id`` arg) without exporting."""
        with self._reg_lock:
            rings = list(self._rings)
        for ring in rings:
            for rec in ring.snapshot():
                yield rec

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #

    def _recycle_req_lanes(self, snaps) -> Dict[str, str]:
        """Remap retired ``serve/req/u<uid>`` lanes onto a bounded
        recycled-track pool. Keep/retire is decided over the UNION of all
        rings (a request's lane is written from several threads — engine,
        prefill worker, health; a per-ring window would keep a named track
        in one ring while recycling the same uid in another, splitting one
        request across rows and growing named rows O(window x rings)): the
        newest ``req_lane_window`` lanes (by last recorded activity
        anywhere) keep their name; every older lane is greedily
        interval-packed onto ``serve/req/recycled/<k>`` such that no two
        time-overlapping requests share a slot — per-thread tracks render
        a subset of a slot's lanes, so B/E nesting stays well-formed.
        Mirrors the dead-ring sweep: a long run's timeline stays bounded
        in named rows, not one per uid forever."""
        out: Dict[str, str] = {}
        window = self.req_lane_window
        extents: Dict[str, Tuple[float, float]] = {}
        for _ring, snap in snaps:
            for rec in snap:
                lane = rec[4]
                if not lane or not _REQ_LANE_RE.match(lane):
                    continue
                t0, t1 = rec[2], rec[3]
                if t1 <= t0:           # match the exporter's epsilon E
                    t1 = t0 + 1e-9
                lo, hi = extents.get(lane, (t0, t1))
                extents[lane] = (min(lo, t0), max(hi, t1))
        if len(extents) <= window:
            return out
        by_recent = sorted(extents, key=lambda l: extents[l][1],
                           reverse=True)
        keep = set(by_recent[:window])
        retired = sorted((l for l in extents if l not in keep),
                         key=lambda l: extents[l][0])
        pools: List[float] = []            # last span end per recycled track
        for lane in retired:
            lo, hi = extents[lane]
            slot = None
            for k, end in enumerate(pools):
                if end <= lo:              # equal-ts boundary is safe: the
                    slot = k               # sort ties close E before B
                    break
            if slot is None:
                pools.append(hi)
                slot = len(pools) - 1
            else:
                pools[slot] = max(pools[slot], hi)
            out[lane] = f"serve/req/recycled/{slot}"
        return out

    def _events(self) -> List[dict]:
        """Chrome-trace event list: metadata naming each track, then B/E
        pairs (plus instants/counters), globally sorted so every track's
        stack nests. Tie rules at equal ts: E closes before B opens, longer
        B's open first (outer before inner), and record order breaks the
        remaining ties — zero-duration spans (coarse perf_counter ticks)
        get an epsilon-long E so a span's end can never sort ahead of its
        own begin.

        Spans whose args carry a ``trace_id`` additionally emit Perfetto
        FLOW events (``ph`` s/t/f, one chain per trace_id) binding the
        request's hops — router placement, prefill, KV handoff, decode
        stints, failover migration — into one causal chain across lanes and
        threads (and, through ``scripts/trace_merge.py``, across files)."""
        pid = os.getpid()
        with self._reg_lock:
            rings = list(self._rings)
        snaps = [(ring, ring.snapshot()) for ring in rings]
        lane_map = self._recycle_req_lanes(snaps)
        tids: Dict[Tuple[int, Optional[str]], int] = {}
        meta: List[dict] = [{"ph": "M", "name": "process_name", "pid": pid,
                             "tid": 0, "args": {"name": "deepspeed_tpu_torch"}}]
        body: List[Tuple[float, int, float, int, dict]] = []
        # trace_id -> [(t0, record idx, tid, ts_us)] of its spans
        flows: Dict[Any, List[Tuple[float, int, int, float]]] = {}

        def tid_for(ring: _Ring, lane: Optional[str]) -> int:
            key = (ring.thread_id, lane)
            tid = tids.get(key)
            if tid is None:
                tid = len(tids) + 1
                tids[key] = tid
                meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                             "tid": tid,
                             "args": {"name": lane or ring.thread_name}})
            return tid

        idx = 0
        for ring, snap in snaps:
            for rec in snap:
                kind, name, t0, t1, lane, args = rec
                if lane is not None and lane_map:
                    lane = lane_map.get(lane, lane)
                tid = tid_for(ring, lane)
                ts0 = t0 * 1e6
                if kind == _SPAN and args and "trace_id" in args:
                    flows.setdefault(args["trace_id"], []).append(
                        (t0, idx, tid, ts0))
                if kind == _SPAN:
                    # coarse clocks can stamp t1 == t0; the E must still
                    # land strictly after its own B
                    if t1 <= t0:
                        t1 = t0 + 1e-9
                    dur = t1 - t0
                    b = {"ph": "B", "name": name, "pid": pid, "tid": tid,
                         "ts": ts0}
                    if args:
                        b["args"] = args
                    # equal (ts, dur) B's: LATER record first — a nested CM
                    # records the inner span before the outer, so record
                    # order descending puts the outer's B ahead
                    body.append((ts0, 1, -dur, -idx, b))
                    # equal-ts E's: earlier record first (inner closed first)
                    body.append((t1 * 1e6, 0, 0.0, idx,
                                 {"ph": "E", "name": name, "pid": pid,
                                  "tid": tid, "ts": t1 * 1e6}))
                elif kind == _INSTANT:
                    ev = {"ph": "i", "s": "t", "name": name, "pid": pid,
                          "tid": tid, "ts": ts0}
                    if args:
                        ev["args"] = args
                    body.append((ts0, 2, 0.0, idx, ev))
                else:  # counter
                    body.append((ts0, 2, 0.0, idx,
                                 {"ph": "C", "name": name, "pid": pid,
                                  "tid": tid, "ts": ts0, "args": args or {}}))
                idx += 1
        # flow chains: one s -> t... -> f sequence per trace_id, each event
        # anchored at its hop-span's begin (rank 2: it sorts after the B it
        # binds to). Single-hop ids emit nothing — a chain needs two ends.
        for flow_id, hops in flows.items():
            if len(hops) < 2:
                continue
            hops.sort(key=lambda h: (h[0], h[1]))
            last = len(hops) - 1
            for k, (_t0, ridx, tid, ts0) in enumerate(hops):
                ph = "s" if k == 0 else ("f" if k == last else "t")
                ev = {"ph": ph, "id": int(flow_id), "name": "serve/req",
                      "cat": "flow", "pid": pid, "tid": tid, "ts": ts0}
                if ph == "f":
                    ev["bp"] = "e"     # bind to the enclosing slice
                body.append((ts0, 2, 0.0, ridx, ev))
        body.sort(key=lambda item: item[:4])
        return meta + [ev for _, _, _, _, ev in body]

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome-trace JSON; returns the path (None when tracing
        is disabled or there is nowhere to write). Idempotent — call at
        teardown and from atexit; later calls overwrite with a superset."""
        if not self.enabled and path is None:
            return None
        if path is None:
            if not self.trace_dir:
                return None
            path = os.path.join(self.trace_dir, f"trace_{os.getpid()}.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"traceEvents": self._events(),
                       "displayTimeUnit": "ms",
                       "clockSync": self._clock_sync_doc()}, f)
        os.replace(tmp, path)
        return path

    def _clock_sync_doc(self) -> dict:
        """One simultaneous (perf_counter, unix) anchor in microseconds —
        ``scripts/trace_merge.py`` uses it to clock-align trace files from
        different processes (each process's perf_counter has its own epoch)
        onto a single merged timeline."""
        perf_s, unix_s = self._clock_sync
        return {"perf_us": perf_s * 1e6, "unix_us": unix_s * 1e6,
                "pid": os.getpid()}

    def crash_dump(self, reason: str = "") -> Optional[str]:
        """Flight-recorder dump: write the retained rings to
        ``trace_crash.json`` in the trace dir. First reason wins — a cascade
        of secondary failures must not overwrite the original timeline."""
        if not self.enabled or not self.trace_dir:
            return None
        if self._crash_path is not None:
            return self._crash_path
        path = os.path.join(self.trace_dir, "trace_crash.json")
        try:
            events = self._events()
            if reason:
                events.append({"ph": "i", "s": "g", "name": f"crash: {reason}",
                               "pid": os.getpid(), "tid": 0,
                               "ts": time.perf_counter() * 1e6})
            os.makedirs(self.trace_dir, exist_ok=True)
            doc = {"traceEvents": events, "displayTimeUnit": "ms",
                   "clockSync": self._clock_sync_doc()}
            with open(path, "w") as f:
                json.dump(doc, f)
        except Exception as e:  # a failing dump must never mask the crash
            logger.warning(f"trace crash dump failed: {type(e).__name__}: {e}")
            return None
        self._crash_path = path
        logger.warning(f"flight recorder dumped to {path}"
                       + (f" ({reason})" if reason else ""))
        return path

    def _atexit_export(self) -> None:
        try:
            self.export()
        except Exception as e:  # pragma: no cover - depends on dying disk
            logger.warning(f"trace export at exit failed: "
                           f"{type(e).__name__}: {e}")


#: the process-wide tracer every instrumentation site records through
tracer = Tracer()


def install_from_env() -> Tracer:
    """Arm the tracer from ``$DSTPU_TRACE`` (a directory; no-op when unset).
    Called by ``initialize`` and the v2 inference engine's constructor, so a
    process traces
    without touching user code; idempotent — an already-configured tracer
    wins."""
    if tracer.enabled:
        return tracer
    trace_dir = os.environ.get(_ENV_VAR, "").strip()
    if trace_dir:
        ring = int(os.environ.get(_ENV_RING, "0") or 0)
        lanes = os.environ.get(_ENV_REQ_LANES, "").strip()
        tracer.configure(trace_dir=trace_dir,
                         ring_size=ring or None,
                         req_lane_window=int(lanes) if lanes else None)
        logger.info(f"span tracing ARMED from ${_ENV_VAR}: {trace_dir}")
    return tracer
