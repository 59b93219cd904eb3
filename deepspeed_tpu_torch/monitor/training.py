"""Training observability (the JAX package's ``monitor/training.py``): the
step loop's counters (``TrainPipelineStats``), the checkpoint counters
(``CheckpointStats``), the offloaded optimizer's (``OffloadPipelineStats``),
the colocated rollout's counters (``RolloutStats``) and the ``Event`` record
they emit.

Every stat class here aggregates the SAME measured intervals the span
tracer records as timeline spans (``train/step/*``, ``train/offload/*``,
``ckpt/*``; ``monitor/trace.py``): one set of ``perf_counter`` pairs per
site feeds both the window aggregate and the Perfetto track, so a
dashboard number always has a matching span to zoom into.

Step phase semantics (per step):

- ``enqueue_wait``: host time blocked on the prefetch queue. It is ALLOWED
  to grow: it is where the host waits when the device sets the pace. It is
  a problem only when ``queue_depth`` is 0 at the same time: then the
  producer (collate + host-to-device copy), not the device, is what the
  host waits for.
- ``host_build``: synchronous staging on the caller's thread (collate,
  curriculum truncation, PLD injection, the copy to the device). Near zero
  when prefetching (the producer does it).
- ``dispatch``: host time that launches the step's kernels (the Python of
  forward, backward and the optimizer; it can block in the caching
  allocator). NOT device execution time.
- ``drain``: host time materialising the DEFERRED metrics (step k-1's
  loss/lr/grad_norm, fetched one step late while step k runs). On a
  device-bound step this is about a whole step: the host waits here for
  the device. Under ``wall_clock_breakdown`` it is the step's full sync.
- ``queue_depth``: prefetch queue occupancy at dequeue time.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Tuple

Event = Tuple[str, float, int]
"""The event record every stats class emits (the JAX package's
``monitor/monitor.py`` ``Event``): ``(name, value, step)``, the shape a
monitor backend's ``write_events`` takes."""

#: step_wall_ms window: bounded so a long-lived engine (record_step fires on
#: every train_batch) cannot grow host memory without bound
WALL_WINDOW = 512


@dataclass
class TrainPipelineStats:
    """Aggregate counters for one engine's training loop (cumulative;
    ``reset()`` between measurement windows)."""

    steps: int = 0
    enqueue_wait_ms: float = 0.0
    host_build_ms: float = 0.0
    dispatch_ms: float = 0.0
    drain_ms: float = 0.0
    queue_depth_sum: int = 0
    prefetched_steps: int = 0        # steps fed by an already-staged batch
    #: wall times (ms) of the most recent ``WALL_WINDOW`` steps: a bounded
    #: p50/p99 latency window (``list(...)`` it for np.percentile)
    step_wall_ms: Deque[float] = field(
        default_factory=lambda: deque(maxlen=WALL_WINDOW))

    def record_step(self, wait_s: float, build_s: float = 0.0, dispatch_s: float = 0.0,
                    drain_s: float = 0.0, wall_s: float = 0.0, queue_depth: int = 0,
                    prefetched: bool = False) -> None:
        self.steps += 1
        self.enqueue_wait_ms += 1e3 * wait_s
        self.host_build_ms += 1e3 * build_s
        self.dispatch_ms += 1e3 * dispatch_s
        self.drain_ms += 1e3 * drain_s
        self.queue_depth_sum += int(queue_depth)
        self.prefetched_steps += int(bool(prefetched))
        self.step_wall_ms.append(1e3 * wall_s)

    def reset(self) -> None:
        self.steps = 0
        self.enqueue_wait_ms = 0.0
        self.host_build_ms = 0.0
        self.dispatch_ms = 0.0
        self.drain_ms = 0.0
        self.queue_depth_sum = 0
        self.prefetched_steps = 0
        self.step_wall_ms = deque(maxlen=WALL_WINDOW)

    def events(self, step: int = 0) -> List[Event]:
        """Monitor-ready ``(name, value, step)`` tuples; per-step averages so
        dashboards stay comparable across runs of different lengths."""
        n = max(1, self.steps)
        return [
            ("train/pipeline/steps", float(self.steps), step),
            ("train/pipeline/enqueue_wait_ms_per_step",
             self.enqueue_wait_ms / n, step),
            ("train/pipeline/host_build_ms_per_step",
             self.host_build_ms / n, step),
            ("train/pipeline/dispatch_ms_per_step",
             self.dispatch_ms / n, step),
            ("train/pipeline/drain_ms_per_step", self.drain_ms / n, step),
            ("train/pipeline/queue_depth", self.queue_depth_sum / n, step),
            ("train/pipeline/prefetched_fraction",
             self.prefetched_steps / n, step),
        ]


@dataclass
class CheckpointStats:
    """Checkpoint observability (``checkpoint/rolling.py`` +
    ``save_checkpoint`` / ``load_checkpoint``; ``events()`` gives the
    ``train/ckpt/*`` events).

    Phase semantics (per save):

    - ``snapshot``: device->host materialisation of the state flats (one
      policed drain) — the ONLY phase on the step loop's critical path when
      the async engine writes. Growing snapshot time means the state grew
      or the transfer link is contended, not that the disk is slow.
    - ``write``: handing the tag's files to the checkpoint engine: the full
      npz writes for the native engine, their submission for the async one
      (the JAX package counts this phase inside ``commit`` for a user save).
    - ``commit``: writer drain + manifest + ``latest`` flip (+ retention
      for rolling saves), on the background committer (rolling) or inline.
    - ``backpressure``: host time the step loop blocked because
      ``rolling.max_pending`` snapshots were still uncommitted — nonzero
      means the disk/writers cannot keep up with the cadence (raise
      ``every_n_steps``, add writers, or accept the stall).
    - ``queue_depth``: checkpoint-engine writer queue occupancy sampled at
      each save submit.
    - ``retries``: cumulative bounded-retry count from the writer path
      (``CheckpointEngine.retries``).
    - ``pruned``: rolling tags deleted by retention.

    Per load: ``read`` (the npz files into host arrays), ``verify`` (their
    crc32s against the manifest) and ``h2d`` (the copies into the live
    tensors, ended by a device sync).
    """

    saves: int = 0
    snapshot_ms: float = 0.0
    write_ms: float = 0.0
    commits: int = 0
    commit_ms: float = 0.0
    backpressure_ms: float = 0.0
    queue_depth_sum: int = 0
    retries: int = 0
    pruned: int = 0
    loads: int = 0
    load_read_ms: float = 0.0
    load_verify_ms: float = 0.0
    load_h2d_ms: float = 0.0

    def record_save(self, snapshot_s: float, backpressure_s: float = 0.0,
                    queue_depth: int = 0, write_s: float = 0.0) -> None:
        self.saves += 1
        self.snapshot_ms += 1e3 * snapshot_s
        self.write_ms += 1e3 * write_s
        self.backpressure_ms += 1e3 * backpressure_s
        self.queue_depth_sum += int(queue_depth)

    def record_commit(self, commit_s: float, pruned: int = 0) -> None:
        self.commits += 1
        self.commit_ms += 1e3 * commit_s
        self.pruned += int(pruned)

    def record_load(self, read_s: float, verify_s: float, h2d_s: float) -> None:
        self.loads += 1
        self.load_read_ms += 1e3 * read_s
        self.load_verify_ms += 1e3 * verify_s
        self.load_h2d_ms += 1e3 * h2d_s

    def reset(self) -> None:
        for name, default in type(self).__dataclass_fields__.items():
            setattr(self, name, default.default)

    def events(self, step: int = 0) -> List[Event]:
        n = max(1, self.saves)
        return [
            ("train/ckpt/saves", float(self.saves), step),
            ("train/ckpt/snapshot_ms_per_save", self.snapshot_ms / n, step),
            ("train/ckpt/write_ms_per_save", self.write_ms / n, step),
            ("train/ckpt/commit_ms_per_save", self.commit_ms / n, step),
            ("train/ckpt/backpressure_ms_per_save",
             self.backpressure_ms / n, step),
            ("train/ckpt/writer_queue_depth", self.queue_depth_sum / n, step),
            ("train/ckpt/retries", float(self.retries), step),
            ("train/ckpt/pruned_tags", float(self.pruned), step),
        ]


@dataclass
class OffloadPipelineStats:
    """Phase counters for the offloaded optimizer's fetch/step/upload group
    pipeline (``runtime/zero/offload.py`` ``step_groups`` and the engine's
    upload lane).

    Phase semantics (accumulated over every group of every step):

    - ``fetch``: host time blocked draining a group's grads D2H. Small in
      steady state — every group's transfer is queued up front, so group g's
      drain overlaps group g-1's kernel. Growing fetch with upload near zero
      means the link, not the host kernel, is the bottleneck.
    - ``kernel``: host optimizer wall time (chunked across the worker pool).
      The phase the other three exist to hide.
    - ``upload``: upload-lane wall time (a finished group's master cast to
      the compute dtype into a pinned buffer, and its copies into the device
      params queued). Runs on its own worker, overlapping later groups'
      kernels.
    - ``swap``: NVMe-mode only — time the state swapper's ``run`` spent
      outside the step function (read waits, write drains). The pure IO cost
      of the nvme tier over the cpu tier.
    - ``upload_depth``: pending uploads observed at each group completion;
      persistently high means H2D (or the merge) is the bottleneck.
    """

    steps: int = 0
    groups: int = 0
    fetch_ms: float = 0.0
    kernel_ms: float = 0.0
    upload_ms: float = 0.0
    swap_ms: float = 0.0
    upload_depth_sum: int = 0

    #: phase name -> attribute, the ``add(phase, seconds)`` contract shared
    #: with ``HostOffloadOptimizer.step_groups``'s ``record`` callback
    _PHASES = {"fetch": "fetch_ms", "kernel": "kernel_ms",
               "upload": "upload_ms", "swap": "swap_ms"}

    def add(self, phase: str, seconds: float) -> None:
        attr = self._PHASES[phase]
        setattr(self, attr, getattr(self, attr) + 1e3 * seconds)

    def record_step(self, groups: int, depth_sum: int = 0) -> None:
        self.steps += 1
        self.groups += int(groups)
        self.upload_depth_sum += int(depth_sum)

    def reset(self) -> None:
        self.steps = 0
        self.groups = 0
        self.fetch_ms = 0.0
        self.kernel_ms = 0.0
        self.upload_ms = 0.0
        self.swap_ms = 0.0
        self.upload_depth_sum = 0

    def events(self, step: int = 0) -> List[Event]:
        n = max(1, self.steps)
        g = max(1, self.groups)
        return [
            ("train/offload/steps", float(self.steps), step),
            ("train/offload/groups_per_step", self.groups / n, step),
            ("train/offload/fetch_ms_per_group", self.fetch_ms / g, step),
            ("train/offload/kernel_ms_per_group", self.kernel_ms / g, step),
            ("train/offload/upload_ms_per_group", self.upload_ms / g, step),
            ("train/offload/swap_ms_per_step", self.swap_ms / n, step),
            ("train/offload/upload_depth", self.upload_depth_sum / g, step),
        ]


@dataclass
class RolloutStats:
    """The colocated rollout loop's counters (``runtime/colocated.py``),
    aggregated from the SAME ``perf_counter`` stamp pairs that become the
    ``train/rollout/{sync,swap,generate}`` tracer spans: one ``record_*``
    call a span, so the sums equal the spans'.

    Phase semantics (per rollout round):

    - ``sync``: the WeightBridge's cast of the fp32 master into the serving
      layout on the card, waited on; ``sync_bytes`` is the serving tree's
      size, with no host round trip (the universal checkpoint's disk path,
      ``ckpt/*``, is what it replaces).
    - ``swap``: the rebind of the live serving engine's weights at a run
      boundary: the quiesce of in-flight decode (recompute preemption, or
      a shed for adapter-bound requests), the weight-version bump and the
      prefix cache's flush. ``preempted`` and ``shed`` count the quiesce's
      casualties; on an idle engine both are 0.
    - ``generate``: the serving leg of the round, submitting prompts and
      draining the rollouts that feed the next train batch.
    """

    rounds: int = 0
    sync_ms: float = 0.0
    swap_ms: float = 0.0
    generate_ms: float = 0.0
    sync_bytes: int = 0
    preempted: int = 0
    shed: int = 0
    requests: int = 0
    tokens: int = 0
    weight_version: int = 0

    def record_sync(self, seconds: float, *, nbytes: int = 0) -> None:
        self.rounds += 1
        self.sync_ms += 1e3 * seconds
        self.sync_bytes = int(nbytes)

    def record_swap(self, seconds: float, *, version: int = 0,
                    preempted: int = 0, shed: int = 0) -> None:
        self.swap_ms += 1e3 * seconds
        self.weight_version = int(version)
        self.preempted += int(preempted)
        self.shed += int(shed)

    def record_generate(self, seconds: float, *, requests: int = 0,
                        tokens: int = 0) -> None:
        self.generate_ms += 1e3 * seconds
        self.requests += int(requests)
        self.tokens += int(tokens)

    def reset(self) -> None:
        for name, default in type(self).__dataclass_fields__.items():
            setattr(self, name, default.default)

    def events(self, step: int = 0) -> List[Event]:
        n = max(1, self.rounds)
        return [
            ("train/rollout/rounds", float(self.rounds), step),
            ("train/rollout/sync_ms_per_round", self.sync_ms / n, step),
            ("train/rollout/swap_ms_per_round", self.swap_ms / n, step),
            ("train/rollout/generate_ms_per_round", self.generate_ms / n, step),
            ("train/rollout/sync_bytes", float(self.sync_bytes), step),
            ("train/rollout/preempted", float(self.preempted), step),
            ("train/rollout/shed", float(self.shed), step),
            ("train/rollout/requests", float(self.requests), step),
            ("train/rollout/tokens", float(self.tokens), step),
            ("train/rollout/weight_version", float(self.weight_version), step),
        ]
