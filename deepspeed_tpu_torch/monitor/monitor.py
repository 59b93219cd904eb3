"""Event monitoring: fan-out of ``(name, value, step)`` tuples to backends
(the JAX package's ``monitor/monitor.py``).

Parity: ``deepspeed/monitor/monitor.py:29 MonitorMaster``, a single object
the engine writes event lists to, which forwards them to every enabled
backend (TensorBoard / Weights & Biases / CSV / the live Prometheus
exporter). Backends are built from the config tree (``tensorboard`` /
``wandb`` / ``csv_monitor`` / ``prometheus`` sections) and only rank 0
writes: the ``torch.distributed`` rank where a process group is up, else
rank 0.
"""

from __future__ import annotations

from typing import Iterable

from deepspeed_tpu_torch.monitor.training import Event
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["Event", "Monitor", "TensorBoardMonitor", "WandbMonitor", "CsvMonitor",
           "MonitorMaster"]


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Monitor:
    """Abstract backend. Parity: ``deepspeed/monitor/monitor.py:16 Monitor``."""

    def __init__(self, config):
        self.enabled = bool(getattr(config, "enabled", False))

    def write_events(self, event_list: Iterable[Event]) -> None:
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    """Parity: ``deepspeed/monitor/tensorboard.py``. Uses
    ``torch.utils.tensorboard`` when importable; without the tensorboard
    wheel it warns and disables itself, as the JAX package does."""

    def __init__(self, config):
        super().__init__(config)
        self.summary_writer = None
        if not self.enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception as e:  # pragma: no cover - env without tensorboard
            logger.warning(f"tensorboard unavailable ({e}); TensorBoardMonitor disabled")
            self.enabled = False
            return
        import os
        log_dir = os.path.join(config.output_path or ".", config.job_name)
        self.summary_writer = SummaryWriter(log_dir=log_dir)

    def write_events(self, event_list: Iterable[Event]) -> None:
        if not self.enabled or self.summary_writer is None:
            return
        for name, value, step in event_list:
            self.summary_writer.add_scalar(name, float(value), int(step))
        self.summary_writer.flush()

    def close(self):
        if self.summary_writer is not None:
            self.summary_writer.flush()
            self.summary_writer.close()
            self.summary_writer = None


class WandbMonitor(Monitor):
    """Parity: ``deepspeed/monitor/wandb.py``. Gated on the wandb package."""

    def __init__(self, config):
        super().__init__(config)
        self._wandb = None
        if not self.enabled:
            return
        try:
            import wandb
        except Exception as e:  # pragma: no cover - env without wandb
            logger.warning(f"wandb unavailable ({e}); WandbMonitor disabled")
            self.enabled = False
            return
        self._wandb = wandb
        wandb.init(project=config.project, group=config.group, entity=config.team)

    def write_events(self, event_list: Iterable[Event]) -> None:
        if not self.enabled or self._wandb is None:
            return
        for name, value, step in event_list:
            self._wandb.log({name: float(value)}, step=int(step))

    def close(self):
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


class CsvMonitor(Monitor):
    """Parity: ``deepspeed/monitor/csv_monitor.py`` — one CSV file per event
    name under ``output_path/job_name/``."""

    def __init__(self, config):
        super().__init__(config)
        self._files = {}
        self.log_dir = None
        if not self.enabled:
            return
        import os
        self.log_dir = os.path.join(config.output_path or ".", config.job_name)
        os.makedirs(self.log_dir, exist_ok=True)

    def _file_for(self, name: str):
        import os
        if name not in self._files:
            # event names like Train/Samples/lr -> Train_Samples_lr.csv
            fname = name.replace("/", "_") + ".csv"
            path = os.path.join(self.log_dir, fname)
            new = not os.path.exists(path)
            f = open(path, "a")
            if new:
                f.write("step,value\n")
            self._files[name] = f
        return self._files[name]

    def write_events(self, event_list: Iterable[Event]) -> None:
        if not self.enabled:
            return
        for name, value, step in event_list:
            f = self._file_for(name)
            f.write(f"{int(step)},{float(value)}\n")
            f.flush()

    def close(self):
        for f in self._files.values():
            f.close()
        self._files = {}


class MonitorMaster(Monitor):
    """Fan-out master. Parity: ``deepspeed/monitor/monitor.py:29``.

    Only rank 0 writes (events are identical across ranks: the metrics are
    reduced before they are emitted)."""

    def __init__(self, config):
        # config here is the full DeepSpeedTPUConfig
        from deepspeed_tpu_torch.monitor.export import PrometheusExporter
        self._is_rank0 = _rank() == 0
        self.tb_monitor = TensorBoardMonitor(config.tensorboard)
        self.wandb_monitor = WandbMonitor(config.wandb)
        self.csv_monitor = CsvMonitor(config.csv_monitor)
        # live telemetry (monitor/export.py): configs predating the section
        # (tests building partial trees) degrade to a disabled exporter.
        # Only rank 0 BINDS — writes are rank-0-gated below, so an exporter
        # on any other rank would serve a live-but-forever-empty /metrics
        # (and race rank 0 for a fixed port on shared hosts)
        prom_cfg = getattr(config, "prometheus", None)
        self.prom_monitor = PrometheusExporter(
            prom_cfg if (prom_cfg is not None and self._is_rank0)
            else type("_Off", (), {"enabled": False})())
        self.enabled = (self.tb_monitor.enabled or self.wandb_monitor.enabled
                        or self.csv_monitor.enabled
                        or self.prom_monitor.enabled)

    def write_events(self, event_list: Iterable[Event]) -> None:
        if not self.enabled or not self._is_rank0:
            return
        event_list = list(event_list)
        self.tb_monitor.write_events(event_list)
        self.wandb_monitor.write_events(event_list)
        self.csv_monitor.write_events(event_list)
        self.prom_monitor.write_events(event_list)

    def close(self):
        """Flush and close every backend. ``engine.destroy()`` calls this
        AFTER draining the deferred metric queue, so the final step's events
        are on disk without the caller touching ``drain_metrics()``.
        Idempotent. The live exporter closes FIRST: its final snapshot
        (``metrics.prom``) is written before the CSV files shut."""
        self.prom_monitor.close()
        self.tb_monitor.close()
        self.wandb_monitor.close()
        self.csv_monitor.close()
