"""Monitoring (the JAX package's ``monitor/``): so far the step loop's and
the checkpoint counters (``training.TrainPipelineStats``,
``training.CheckpointStats``) and the ``(name, value, step)`` event record
they emit. The monitor writers (TensorBoard, W&B, CSV) and
the span tracer wait for their slice; ``config.check_slice`` refuses their
sections by name."""

from deepspeed_tpu_torch.monitor.training import CheckpointStats, Event, TrainPipelineStats

__all__ = ["Event", "CheckpointStats", "TrainPipelineStats"]
