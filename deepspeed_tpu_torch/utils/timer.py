"""A wall-clock stopwatch (the JAX package's ``utils/timer.py`` ``Timer``).

``sync=True`` waits on the device before each edge, so the interval
measures execution and not the launch queue: ``torch.cuda.synchronize`` on
the timer's CUDA device (a CPU device has nothing to wait on). Every
``stop()`` records a ``timer/<name>`` span through ``monitor/trace.py``
when tracing is armed. Intervals are ``time.perf_counter()`` stamps (the
tracer's clock).
"""

from __future__ import annotations

import time
from typing import Any, List

import torch

from deepspeed_tpu_torch.monitor.trace import tracer as _tracer


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
