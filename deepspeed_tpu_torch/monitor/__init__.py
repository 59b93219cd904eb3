"""Monitoring (the JAX package's ``monitor/``): the monitor backends
(``monitor.MonitorMaster`` over TensorBoard, W&B, CSV and the live
Prometheus exporter ``export.PrometheusExporter``, with the
``export.TelemetryPump`` push loop), the step loop's and the checkpoint
counters (``training.TrainPipelineStats``, ``training.CheckpointStats``),
the offloaded optimizer's (``training.OffloadPipelineStats``), the colocated
rollout's (``training.RolloutStats``), the serving counters
(``serving.PipelineStats``, ``FrontendStats``, ``HealthStats``,
``RouterStats``), the span tracer (``trace.tracer``, armed by
``DSTPU_TRACE`` or the ``monitor.trace`` config section) and the ``(name,
value, step)`` event record they emit."""

from deepspeed_tpu_torch.monitor.export import (PrometheusExporter, TelemetryPump,
                                                sanitize_metric_name)
from deepspeed_tpu_torch.monitor.monitor import (CsvMonitor, Monitor, MonitorMaster,
                                                 TensorBoardMonitor, WandbMonitor)
from deepspeed_tpu_torch.monitor.serving import PipelineStats
from deepspeed_tpu_torch.monitor.trace import Tracer, tracer
from deepspeed_tpu_torch.monitor.training import (CheckpointStats, Event, OffloadPipelineStats,
                                                  RolloutStats, TrainPipelineStats)

__all__ = ["Event", "Monitor", "MonitorMaster", "TensorBoardMonitor", "WandbMonitor",
           "CsvMonitor", "PrometheusExporter", "TelemetryPump", "sanitize_metric_name",
           "PipelineStats", "CheckpointStats", "OffloadPipelineStats", "RolloutStats",
           "TrainPipelineStats", "Tracer", "tracer"]
