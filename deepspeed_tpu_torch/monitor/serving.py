"""Serving observability: the frontend's, health monitor's and router's
counters (the JAX package's ``monitor/serving.py`` ``FrontendStats``,
``HealthStats`` and ``RouterStats``, copied), plus the decode pipelines'
per-step counters (``PipelineStats``).

Each class turns its totals into ``(name, value, step)`` monitor events
(``inference/v2/pipeline/*``, ``serve/frontend/*``, ``serve/slo/*``,
``serve/health/*``, ``serve/router/*``). The timings come from the same
``perf_counter`` stamps the tracer records as ``serve/decode/*``,
``serve/req/*``, ``serve/health/*`` and ``serve/router/*`` spans
(``monitor/trace.py``), so the counters and the timeline read one
measurement.

The double-buffered decode pipeline (``inference/v2/pipeline.py``) overlaps
three things a step: the launch of step k's kernels, the host's drain of
step k-1's token row, and the host-side build of step k+1's bookkeeping.
Phase semantics (per step):

- ``dispatch``: host time that launches the step (the Python of the decode
  step and its kernels; NOT device execution time).
- ``host_build``: host bookkeeping between steps (token-stream appends,
  callbacks, the next step's inputs).
- ``fetch_drain``: host time blocked on the previous step's token row
  (the policed drain). On a device-bound step the host waits here.
- ``bubble``: the rest of the step's wall time (``wall - dispatch - drain
  - build``).

The engine's speculative-decode, split-rung and LoRA counters live in
``inference/v2/engine_v2.py``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from deepspeed_tpu_torch.monitor.training import Event


@dataclass
class PipelineStats:
    """Aggregate counters for one engine's decode pipelines (cumulative
    across runs; ``reset()`` between measurement windows). The health
    monitor's progress heartbeat reads ``steps`` and ``tokens``."""

    steps: int = 0
    tokens: int = 0                  # live (recorded) tokens drained
    dispatch_ms: float = 0.0
    host_build_ms: float = 0.0
    fetch_drain_ms: float = 0.0
    bubble_ms: float = 0.0
    fetch_bytes: int = 0
    last_fetch_bytes: int = 0        # bytes of the most recent per-step drain
    #: per-step wall times (ms) of the MOST RECENT run only;
    #: DecodePipeline.run clears it at run start (the scalar fields above
    #: stay cumulative)
    step_wall_ms: List[float] = field(default_factory=list)

    def record_step(self, dispatch_s: float, drain_s: float, build_s: float,
                    wall_s: float, fetch_bytes: int, live_tokens: int) -> None:
        self.steps += 1
        self.tokens += int(live_tokens)
        self.dispatch_ms += 1e3 * dispatch_s
        self.fetch_drain_ms += 1e3 * drain_s
        self.host_build_ms += 1e3 * build_s
        self.bubble_ms += 1e3 * max(0.0, wall_s - dispatch_s - drain_s - build_s)
        self.fetch_bytes += int(fetch_bytes)
        self.last_fetch_bytes = int(fetch_bytes)
        self.step_wall_ms.append(1e3 * wall_s)

    def reset(self) -> None:
        self.steps = 0
        self.tokens = 0
        self.dispatch_ms = 0.0
        self.host_build_ms = 0.0
        self.fetch_drain_ms = 0.0
        self.bubble_ms = 0.0
        self.fetch_bytes = 0
        self.last_fetch_bytes = 0
        self.step_wall_ms = []

    @property
    def fetch_bytes_per_step(self) -> float:
        return self.fetch_bytes / self.steps if self.steps else 0.0

    def events(self, step: int = 0) -> List[Event]:
        """Monitor-ready ``(name, value, step)`` tuples; per-step averages so
        dashboards stay comparable across runs of different lengths."""
        n = max(1, self.steps)
        return [
            ("inference/v2/pipeline/steps", float(self.steps), step),
            ("inference/v2/pipeline/tokens", float(self.tokens), step),
            ("inference/v2/pipeline/dispatch_ms_per_step",
             self.dispatch_ms / n, step),
            ("inference/v2/pipeline/host_build_ms_per_step",
             self.host_build_ms / n, step),
            ("inference/v2/pipeline/fetch_drain_ms_per_step",
             self.fetch_drain_ms / n, step),
            ("inference/v2/pipeline/bubble_ms_per_step",
             self.bubble_ms / n, step),
            ("inference/v2/pipeline/fetch_bytes_per_step",
             float(self.fetch_bytes_per_step), step),
        ]


SAMPLE_WINDOW = 4096


class _ClassCounters:
    """Per-priority-class frontend counters + bounded latency windows."""

    __slots__ = ("submitted", "admitted", "completed", "shed", "cancelled",
                 "slo_met", "tokens", "ttft_ms", "tbt_ms")

    def __init__(self):
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.shed = 0
        self.cancelled = 0
        self.slo_met = 0
        self.tokens = 0
        self.ttft_ms: Deque[float] = deque(maxlen=SAMPLE_WINDOW)
        self.tbt_ms: Deque[float] = deque(maxlen=SAMPLE_WINDOW)


class FrontendStats:
    """Aggregate counters for one ``ServingFrontend``
    (``inference/v2/serving/frontend.py``): per-class TTFT/TBT percentile
    windows, queue depth, preemption/offload traffic, shed counts — the
    ``serve/frontend/*`` monitor surface. Mutated only on the frontend's
    engine thread (single writer); the latency samples come from the SAME
    ``perf_counter`` stamps the per-request ``serve/req/*`` trace spans are
    built from, so the dashboard and the timeline can never disagree.

    ``replica`` (set by ``serving/cluster.py``): when not None, event names
    become ``serve/frontend/<replica>/...`` — N replicas' frontends fanning
    into ONE monitor backend (one CSV) previously interleaved
    indistinguishable rows."""

    def __init__(self, class_names: List[str],
                 replica: Optional[str] = None):
        self.replica = replica
        self.classes: Dict[str, _ClassCounters] = {
            name: _ClassCounters() for name in class_names}
        self.queue_depth = 0               # gauge: pending after last round
        # KV-pool gauges (set_kv_pool at frontend build; residency refreshed
        # per admission round) — the serve/frontend/kv/* surface that makes
        # an int8 pool's capacity doubling observable next to the latency
        # counters it buys (docs/SERVING.md "Quantized KV"). Static facts
        # are config-derived, not timed, so the stats-equals-spans invariant
        # is untouched; the per-round residency gauges mirror to trace
        # counters from the same refresh point.
        self.kv_pool_dtype_bits = 0
        self.kv_bytes_per_token = 0.0
        self.kv_pool_tokens = 0
        self.kv_max_context = 0
        self.kv_block_size = 0
        self.kv_free_blocks = 0            # gauge: after last admission round
        self.kv_resident_seqs = 0          # gauge: tracked sequences
        self.preemptions = 0               # victims preempted (any mechanism)
        self.recompute_preemptions = 0     # ... of which fell back to recompute
        self.restores = 0
        self.offload_bytes = 0             # KV bytes moved device -> host
        self.restore_bytes = 0             # KV bytes moved host -> device
        self.forced_sheds = 0              # reject-only emergency sheds
        # SLO-miss attribution (docs/OBSERVABILITY.md "SLO-miss
        # attribution"): every finished-but-missed request bucketed by the
        # DOMINANT phase of its ledger (the same perf stamps the serve/req
        # spans record) — the serve/slo/* surface that answers "where did
        # the missed requests' time go" per replica
        self.slo_missed = 0
        self.slo_missed_by_phase: Dict[str, int] = {}
        self.slo_missed_by_class: Dict[str, int] = {}
        self.slo_attr_consistent = 0       # ledger summed to client latency

    # -- recording (engine thread) ------------------------------------- #

    def set_kv_pool(self, dtype_bits: int, bytes_per_token: float,
                    pool_tokens: int, max_context: int,
                    block_size: int) -> None:
        """Static KV-pool facts (one call at frontend construction)."""
        self.kv_pool_dtype_bits = int(dtype_bits)
        self.kv_bytes_per_token = float(bytes_per_token)
        self.kv_pool_tokens = int(pool_tokens)
        self.kv_max_context = int(max_context)
        self.kv_block_size = int(block_size)

    def record_submit(self, cls: str) -> None:
        self.classes[cls].submitted += 1

    def record_admit(self, cls: str) -> None:
        self.classes[cls].admitted += 1

    def record_shed(self, cls: str) -> None:
        self.classes[cls].shed += 1

    def record_cancel(self, cls: str) -> None:
        self.classes[cls].cancelled += 1

    def record_slo_miss(self, cls: str, phase: str,
                        consistent: bool) -> None:
        """One finished request that missed its class SLO, attributed to
        the dominant phase of its ledger; ``consistent`` = the ledger's
        stints summed to the client-measured latency (small epsilon)."""
        self.slo_missed += 1
        self.slo_missed_by_phase[phase] = \
            self.slo_missed_by_phase.get(phase, 0) + 1
        self.slo_missed_by_class[cls] = \
            self.slo_missed_by_class.get(cls, 0) + 1
        self.slo_attr_consistent += bool(consistent)

    def record_complete(self, cls: str, ttft_ms: Optional[float],
                        tbt_ms: List[float], tokens: int,
                        slo_met: bool) -> None:
        c = self.classes[cls]
        c.completed += 1
        c.tokens += tokens
        c.slo_met += bool(slo_met)
        if ttft_ms is not None:
            c.ttft_ms.append(float(ttft_ms))
        c.tbt_ms.extend(float(x) for x in tbt_ms)

    # -- reporting ------------------------------------------------------ #

    def events(self, step: int = 0) -> List[Event]:
        """``serve/frontend/*`` monitor events: global gauges/counters plus
        per-class completion and latency percentiles (docs/SERVING.md
        glossary); replica-labelled (``serve/frontend/<replica>/*``) under
        a cluster."""
        import numpy as np
        base = "serve/frontend" if self.replica is None \
            else f"serve/frontend/{self.replica}"
        # how many MORE max_context-length sequences the free pool could
        # hold right now — the headroom number an int8 pool's capacity
        # doubling moves (same HBM budget -> more blocks -> more headroom).
        # Counted in whole BLOCKS: a sequence's last partial block still
        # consumes a full block, so free_tokens // max_context would
        # overstate headroom whenever max_context % block_size != 0
        headroom = (self.kv_free_blocks
                    // -(-self.kv_max_context // self.kv_block_size)
                    if self.kv_max_context and self.kv_block_size else 0)
        out: List[Event] = [
            (f"{base}/queue_depth", float(self.queue_depth), step),
            (f"{base}/kv/pool_dtype_bits",
             float(self.kv_pool_dtype_bits), step),
            (f"{base}/kv/bytes_per_token",
             float(self.kv_bytes_per_token), step),
            (f"{base}/kv/pool_tokens", float(self.kv_pool_tokens), step),
            (f"{base}/kv/free_blocks", float(self.kv_free_blocks), step),
            (f"{base}/kv/resident_seqs",
             float(self.kv_resident_seqs), step),
            (f"{base}/kv/resident_seq_headroom", float(headroom), step),
            (f"{base}/preemptions", float(self.preemptions), step),
            (f"{base}/recompute_preemptions",
             float(self.recompute_preemptions), step),
            (f"{base}/restores", float(self.restores), step),
            (f"{base}/offload_bytes", float(self.offload_bytes), step),
            (f"{base}/restore_bytes", float(self.restore_bytes), step),
            (f"{base}/forced_sheds", float(self.forced_sheds), step),
        ]
        for name, c in self.classes.items():
            pre = f"{base}/{name}"
            out += [
                (f"{pre}/completed", float(c.completed), step),
                (f"{pre}/shed", float(c.shed), step),
                (f"{pre}/cancelled", float(c.cancelled), step),
                (f"{pre}/tokens", float(c.tokens), step),
                (f"{pre}/slo_met_fraction",
                 c.slo_met / c.completed if c.completed else 0.0, step),
            ]
            for label, win in (("ttft", c.ttft_ms), ("tbt", c.tbt_ms)):
                if win:
                    xs = np.asarray(win, np.float64)
                    out += [
                        (f"{pre}/{label}_p50_ms",
                         float(np.percentile(xs, 50)), step),
                        (f"{pre}/{label}_p95_ms",
                         float(np.percentile(xs, 95)), step),
                    ]
        # serve/slo/*: SLO-miss attribution rollup (snapshot the dicts —
        # the engine thread inserts first-seen phase keys while a bench
        # thread reads)
        slo_base = "serve/slo" if self.replica is None \
            else f"serve/slo/{self.replica}"
        by_phase = dict(self.slo_missed_by_phase)
        by_class = dict(self.slo_missed_by_class)
        out.append((f"{slo_base}/missed", float(self.slo_missed), step))
        out.append((f"{slo_base}/attr_consistent",
                    float(self.slo_attr_consistent), step))
        for phase, n in sorted(by_phase.items()):
            out.append((f"{slo_base}/dominant/{phase}", float(n), step))
        for cls, n in sorted(by_class.items()):
            out.append((f"{slo_base}/by_class/{cls}", float(n), step))
        return out


#: detection-latency samples retained (sliding window, like SAMPLE_WINDOW)
_DETECT_WINDOW = 256


class HealthStats:
    """Aggregate counters for one router's ``HealthMonitor``
    (``inference/v2/serving/health.py``) — the ``serve/health/*`` monitor
    surface (docs/SERVING.md "Failure semantics"). Per-window aggregations
    over the SAME ``perf_counter`` stamps the tracer records as
    ``serve/health/{detect,migrate,rejoin}`` spans — one set of perf pairs
    feeds both (docs/OBSERVABILITY.md), so the dashboard and the timeline
    can never disagree about when a failure was detected or how long a
    rejoin warmup took. Mutated only on the health-monitor thread (single
    writer); readers see monotone counters."""

    def __init__(self, replica_names: Optional[List[str]] = None):
        #: replica -> current health state name (gauge-ish, for dashboards)
        self.states: Dict[str, str] = {
            n: "healthy" for n in (replica_names or [])}
        self.transitions: Dict[str, int] = {}   # "suspect->down" -> count
        self.liveness_downs = 0                 # died loop / worker
        self.stall_downs = 0                    # wedged: progress deadline
        self.detect_ms: Deque[float] = deque(maxlen=_DETECT_WINDOW)
        self.migrations = 0                     # requests moved off a corpse
        self.salvaged = 0                       # ... via offloaded-KV import
        self.reprefilled = 0                    # ... via history re-prefill
        self.salvaged_tokens = 0                # history tokens NOT recomputed
        self.reprefilled_tokens = 0             # history tokens recomputed
        self.salvaged_bytes = 0                 # KV bytes imported from host
        self.migration_sheds = 0                # no survivor could fund it
        self.migration_cancels = 0              # cancel landed mid-migration
        self.handoffs_replanned = 0             # queued handoffs re-targeted
        self.rejoins = 0
        self.rejoin_warmup_ms = 0.0             # cumulative warmup wall

    # -- recording (health-monitor thread) ------------------------------ #

    def record_transition(self, replica: str, old: str, new: str) -> None:
        self.states[replica] = new
        key = f"{old}->{new}"
        self.transitions[key] = self.transitions.get(key, 0) + 1

    def record_detection(self, kind: str, latency_s: float) -> None:
        if kind == "stall":
            self.stall_downs += 1
        else:
            self.liveness_downs += 1
        self.detect_ms.append(1e3 * latency_s)

    def record_migration(self, mode: str, history_tokens: int,
                         nbytes: int = 0) -> None:
        self.migrations += 1
        if mode == "salvage":
            self.salvaged += 1
            self.salvaged_tokens += int(history_tokens)
            self.salvaged_bytes += int(nbytes)
        else:
            self.reprefilled += 1
            self.reprefilled_tokens += int(history_tokens)

    def record_rejoin(self, warmup_s: float) -> None:
        self.rejoins += 1
        self.rejoin_warmup_ms += 1e3 * warmup_s

    # -- reporting ------------------------------------------------------- #

    def events(self, step: int = 0) -> List[Event]:
        """``serve/health/*`` monitor events (docs/SERVING.md glossary).
        Snapshots the dicts/deque first: a monitor backend reads on a
        bench/user thread while the health thread inserts first-seen
        transition keys — iterating the live dict would race."""
        import numpy as np
        transitions = dict(self.transitions)
        states = dict(self.states)
        detect = list(self.detect_ms)
        out: List[Event] = [
            ("serve/health/transitions",
             float(sum(transitions.values())), step),
            ("serve/health/liveness_downs", float(self.liveness_downs), step),
            ("serve/health/stall_downs", float(self.stall_downs), step),
            ("serve/health/migrations", float(self.migrations), step),
            ("serve/health/salvaged", float(self.salvaged), step),
            ("serve/health/reprefilled", float(self.reprefilled), step),
            ("serve/health/salvaged_tokens",
             float(self.salvaged_tokens), step),
            ("serve/health/reprefilled_tokens",
             float(self.reprefilled_tokens), step),
            ("serve/health/salvaged_bytes", float(self.salvaged_bytes), step),
            ("serve/health/migration_sheds",
             float(self.migration_sheds), step),
            ("serve/health/migration_cancels",
             float(self.migration_cancels), step),
            ("serve/health/handoffs_replanned",
             float(self.handoffs_replanned), step),
            ("serve/health/rejoins", float(self.rejoins), step),
            ("serve/health/rejoin_warmup_ms",
             float(self.rejoin_warmup_ms), step),
        ]
        if detect:
            xs = np.asarray(detect, np.float64)
            out.append(("serve/health/detect_p50_ms",
                        float(np.percentile(xs, 50)), step))
            out.append(("serve/health/detect_p95_ms",
                        float(np.percentile(xs, 95)), step))
        for name, state in states.items():
            # numeric gauge per replica: healthy=0 suspect=1 down=2
            # draining=3 rejoining=4 (dashboards can't plot strings)
            code = {"healthy": 0, "suspect": 1, "down": 2,
                    "draining": 3, "rejoining": 4}.get(state, -1)
            out.append((f"serve/health/state/{name}", float(code), step))
        return out



class RouterStats:
    """Aggregate counters for one ``ServingRouter``
    (``inference/v2/serving/router.py``) — the ``serve/router/*`` monitor
    surface. Placement counters (routed per replica, cache-hit blocks,
    rebalances, router-level sheds) plus the disaggregation handoff traffic,
    and per-class CLUSTER rollups computed from the registered replicas'
    :class:`FrontendStats` at ``events()`` time — the cluster-goodput view
    that no single replica's counters can provide. Placement counters are
    mutated under the router's lock (submit may be called from any client
    thread); the rollup only reads."""

    def __init__(self, replica_names: List[str], class_names: List[str]):
        self.routed: Dict[str, int] = {n: 0 for n in replica_names}
        self.cache_hit_blocks = 0          # blocks cached at the CHOSEN replica
        self.cache_hit_requests = 0        # requests routed onto a warm prefix
        self.rebalances = 0                # cache-best replica overridden
        self.router_sheds: Dict[str, int] = {c: 0 for c in class_names}
        self.handoffs = 0                  # prefill->decode sequences moved
        self.handoff_bytes = 0             # KV bytes over the page fabric
        self.handoff_failures = 0          # retry budgets exhausted (shed)
        self._frontends: List[FrontendStats] = []

    def register_frontend(self, stats: FrontendStats) -> None:
        self._frontends.append(stats)

    def events(self, step: int = 0) -> List[Event]:
        """``serve/router/*`` monitor events (docs/SERVING.md "Multi-replica
        & disaggregation" glossary)."""
        out: List[Event] = [
            ("serve/router/routed",
             float(sum(self.routed.values())), step),
            ("serve/router/cache_hit_blocks",
             float(self.cache_hit_blocks), step),
            ("serve/router/cache_hit_requests",
             float(self.cache_hit_requests), step),
            ("serve/router/rebalances", float(self.rebalances), step),
            ("serve/router/sheds",
             float(sum(self.router_sheds.values())), step),
            ("serve/router/handoffs", float(self.handoffs), step),
            ("serve/router/handoff_bytes", float(self.handoff_bytes), step),
            ("serve/router/handoff_failures",
             float(self.handoff_failures), step),
        ]
        for name, n in self.routed.items():
            out.append((f"serve/router/routed/{name}", float(n), step))
        # cluster-level SLO-miss attribution rollup: sum the replicas'
        # serve/slo buckets — "what phase is eating the cluster's misses"
        # in one row set (docs/OBSERVABILITY.md "SLO-miss attribution")
        missed = consistent = 0
        by_phase: Dict[str, int] = {}
        for fs in self._frontends:
            missed += fs.slo_missed
            consistent += fs.slo_attr_consistent
            for phase, n in dict(fs.slo_missed_by_phase).items():
                by_phase[phase] = by_phase.get(phase, 0) + n
        out.append(("serve/slo/cluster/missed", float(missed), step))
        out.append(("serve/slo/cluster/attr_consistent",
                    float(consistent), step))
        for phase, n in sorted(by_phase.items()):
            out.append((f"serve/slo/cluster/dominant/{phase}",
                        float(n), step))
        # per-class cluster rollup: sum over every registered replica
        for cls in self.router_sheds:
            completed = shed = tokens = slo = 0
            for fs in self._frontends:
                c = fs.classes.get(cls)
                if c is None:
                    continue
                completed += c.completed
                shed += c.shed
                tokens += c.tokens
                slo += c.slo_met
            shed += self.router_sheds[cls]
            pre = f"serve/router/{cls}"
            out += [
                (f"{pre}/completed", float(completed), step),
                (f"{pre}/shed", float(shed), step),
                (f"{pre}/tokens", float(tokens), step),
                (f"{pre}/slo_met_fraction",
                 slo / completed if completed else 0.0, step),
            ]
        return out
