"""Monitoring (the JAX package's ``monitor/``): the step loop's and the
checkpoint counters (``training.TrainPipelineStats``,
``training.CheckpointStats``), the offloaded optimizer's
(``training.OffloadPipelineStats``), the colocated rollout's
(``training.RolloutStats``), the serving counters (``serving.FrontendStats``,
``HealthStats``, ``RouterStats``, ``PipelineStats``), the span tracer
(``trace.tracer``, armed by ``DSTPU_TRACE``) and the ``(name, value,
step)`` event record they emit. The monitor writers (TensorBoard, W&B, CSV)
wait for their slice; ``config.check_slice`` refuses their sections, and
the training config's ``monitor.trace``, by name."""

from deepspeed_tpu_torch.monitor.training import (CheckpointStats, Event, OffloadPipelineStats,
                                                  RolloutStats, TrainPipelineStats)

__all__ = ["Event", "CheckpointStats", "OffloadPipelineStats", "RolloutStats",
           "TrainPipelineStats"]
