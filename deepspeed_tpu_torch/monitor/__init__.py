"""Monitoring (the JAX package's ``monitor/``): so far the checkpoint
counters (``training.CheckpointStats``) and the ``(name, value, step)``
event record they emit. The monitor writers (TensorBoard, W&B, CSV) and
the span tracer wait for their slice; ``config.check_slice`` refuses their
sections by name."""

from deepspeed_tpu_torch.monitor.training import CheckpointStats, Event

__all__ = ["Event", "CheckpointStats"]
