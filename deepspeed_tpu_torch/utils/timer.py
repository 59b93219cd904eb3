"""Wall-clock and throughput timers (the JAX package's ``utils/timer.py``):
``Timer``, the ``wall_clock_breakdown`` group ``SynchronizedWallClockTimer``
and ``ThroughputTimer``.

``sync=True`` waits on the device before each edge, so the interval
measures execution and not the launch queue: ``torch.cuda.synchronize`` on
the timer's CUDA device (a CPU device has nothing to wait on). Every
``stop()`` records a ``timer/<name>`` span through ``monitor/trace.py``
when tracing is armed. Intervals are ``time.perf_counter()`` stamps (the
tracer's clock).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


def _sync_point(sync_obj: Any, sync: bool, device: torch.device) -> None:
    """One sync decision for every timer edge: wait on ``sync_obj``'s device
    if it is a CUDA tensor, else on the timer's device if the timer opted
    into sync, else not at all."""
    if isinstance(sync_obj, torch.Tensor):
        if sync_obj.is_cuda:
            torch.cuda.synchronize(sync_obj.device)
    elif sync and device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """One named stopwatch. ``device`` is the device a ``sync=True`` timer
    waits on (default: the current CUDA device)."""

    def __init__(self, name: str, sync: bool = False, device=None):
        self.name = name
        self.sync = sync
        self.device = torch.device("cuda" if device is None else device)
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0
        self._record: List[float] = []

    def start(self, sync_obj: Any = None):
        _sync_point(sync_obj, self.sync, self.device)
        self._start = time.perf_counter()
        self.started = True

    def stop(self, record: bool = True, sync_obj: Any = None):
        if not self.started:
            return
        _sync_point(sync_obj, self.sync, self.device)
        end = time.perf_counter()
        dt = end - self._start
        self._elapsed += dt
        if record:
            self._record.append(dt)
        if _tracer.enabled:
            _tracer.add("timer/" + self.name, self._start, end)
        self.started = False

    def reset(self):
        self.started = False
        self._elapsed = 0.0
        self._record.clear()

    def elapsed(self, reset: bool = True) -> float:
        now = time.perf_counter()
        out = self._elapsed
        if self.started:
            out += now - self._start
        if reset:
            self._elapsed = 0.0
            if self.started:
                # restart the running interval so it is not counted twice
                self._start = now
        return out

    def mean(self) -> float:
        return sum(self._record) / max(1, len(self._record))


class SynchronizedWallClockTimer:
    """Group of named timers; logs a breakdown line like DeepSpeed's
    ``wall_clock_breakdown`` output. ``sync=True`` makes every timer wait
    on ``device`` at its edges."""

    def __init__(self, sync: bool = False, device=None):
        self.sync = sync
        self.device = device
        self.timers: Dict[str, Timer] = {}

    def __call__(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name, sync=self.sync, device=self.device)
        return self.timers[name]

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False, ranks: Optional[List[int]] = None):
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=ranks or [0])

    def get_mean(self, names: List[str], normalizer: float = 1.0) -> Dict[str, float]:
        return {n: self.timers[n].mean() * 1000.0 / normalizer
                for n in names if n in self.timers}


class ThroughputTimer:
    """Samples/sec tracking (DeepSpeed's ``ThroughputTimer``); the first
    ``start_step`` steps are warm-up and not counted."""

    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50,
                 logging_fn=None, sync: bool = False, device=None):
        self.batch_size = max(1, batch_size)
        self.sync = sync
        self.device = torch.device("cuda" if device is None else device)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.total_elapsed_time = 0.0
        self.step_count = 0
        self.started = False
        self._start = 0.0
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))

    def start(self):
        self._start = time.perf_counter()
        self.started = True

    def stop(self, global_step: bool = True, report_speed: bool = True, sync_obj: Any = None):
        if not self.started:
            return
        self.started = False
        if global_step:
            self.step_count += 1
        if self.step_count > self.start_step:
            _sync_point(sync_obj, self.sync, self.device)
            self.total_elapsed_time += time.perf_counter() - self._start
            if report_speed and self.steps_per_output and self.step_count % self.steps_per_output == 0:
                self.logging(
                    f"step={self.step_count}, samples/sec={self.avg_samples_per_sec():.2f}")

    def avg_samples_per_sec(self) -> float:
        if self.total_elapsed_time <= 0 or self.step_count <= self.start_step:
            return 0.0
        return (self.step_count - self.start_step) * self.batch_size / self.total_elapsed_time
