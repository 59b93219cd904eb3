"""Live cluster telemetry: a pull-based Prometheus-text snapshot endpoint
(the JAX package's ``monitor/export.py``).

The monitor stack so far is write-side only: ``MonitorMaster`` fans
``(name, value, step)`` events to TensorBoard / W&B / CSV files, which a
live dashboard cannot scrape — watching a serving cluster meant tailing
CSVs. This module adds the pull side: :class:`PrometheusExporter` is a
fourth ``MonitorMaster`` backend that keeps the LATEST value of every event
name in memory and serves them as Prometheus text exposition format
(version 0.0.4) from a tiny embedded HTTP endpoint (``GET /metrics``).
Everything already flowing through the event path — per-replica health
state (``serve/health/state/<replica>``), queue depth and KV-pool residency
(``serve/frontend/<replica>/*``), goodput rollups (``serve/router/*``)
— becomes scrapeable without
touching a CSV file.

Design constraints, matching the rest of ``monitor/``:

- **zero overhead when disabled**: a disabled exporter starts no thread,
  binds no socket, and ``write_events`` is a one-branch no-op;
- **no work on the event path beyond a dict store**: rendering happens at
  scrape time on the HTTP thread, never on the thread writing events;
- **rank-0 gating is the master's** (``MonitorMaster.write_events``), same
  as every other backend;
- **close drains the snapshot first**: ``close()`` writes a final
  ``metrics.prom`` snapshot (when ``output_path`` is configured) BEFORE the
  server stops — a run's last state survives the teardown, and
  ``MonitorMaster.close`` orders this ahead of the CSV close.

Metric names sanitize ``/``-namespaced event names into the Prometheus
grammar (``serve/frontend/r0/queue_depth`` ->
``dstpu_serve_frontend_r0_queue_dep``... see :func:`sanitize_metric_name`);
every metric is exported as a gauge carrying the last written value and its
step. :class:`TelemetryPump` is the optional push loop: a daemon thread
that periodically calls ``write_monitor_events(master, step)`` on whatever
sources it is given (engines, frontends, a ``ServingRouter``), so a
scraped endpoint stays fresh without the serving loops knowing about it.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from deepspeed_tpu_torch.monitor.monitor import Event, Monitor
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.threads import make_lock, thread_role

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str, prefix: str = "dstpu") -> str:
    """Map an event name onto the Prometheus metric-name grammar
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): every illegal character becomes ``_``
    and the configured prefix guards against a leading digit."""
    return f"{prefix}_{_NAME_RE.sub('_', name)}" if prefix \
        else _NAME_RE.sub("_", name)


class PrometheusExporter(Monitor):
    """Pull-based Prometheus-text snapshot endpoint over the monitor event
    path. ``write_events`` stores the latest value per name (one dict store
    per event, under a lock); ``GET /metrics`` on the embedded HTTP server
    renders the snapshot at scrape time. ``port=0`` binds an ephemeral port
    (tests; read it back from ``.port``)."""

    def __init__(self, config):
        super().__init__(config)
        self._lock = make_lock("monitor.prom.registry")
        self._values: Dict[str, Tuple[float, int]] = {}
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self.addr = getattr(config, "addr", "127.0.0.1")
        self.port = int(getattr(config, "port", 0) or 0)
        self.prefix = getattr(config, "prefix", "dstpu")
        self._snapshot_dir = ""
        if not self.enabled:
            return
        import os
        out = getattr(config, "output_path", "") or ""
        if out:
            self._snapshot_dir = os.path.join(
                out, getattr(config, "job_name", "") or "")
            os.makedirs(self._snapshot_dir, exist_ok=True)
        self._start_server()

    # -- event path ----------------------------------------------------- #

    def write_events(self, event_list: Iterable[Event]) -> None:
        if not self.enabled:
            return
        with self._lock:
            for name, value, step in event_list:
                self._values[name] = (float(value), int(step))

    # -- scrape side ---------------------------------------------------- #

    def render(self) -> str:
        """The Prometheus text exposition (format 0.0.4) of the current
        snapshot — what ``GET /metrics`` serves and what the close-time
        ``metrics.prom`` file contains. Every metric is a gauge; the event
        step rides along as a second ``<metric>_step`` gauge so a dashboard
        can tell how fresh a rollup is without a label-cardinality cost."""
        with self._lock:
            values = dict(self._values)
        lines: List[str] = []
        for name in sorted(values):
            value, step = values[name]
            metric = sanitize_metric_name(name, self.prefix)
            lines.append(f"# HELP {metric} {name}")
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {value!r}")
            lines.append(f"{metric}_step {step}")
        lines.append("")
        return "\n".join(lines)

    @property
    def url(self) -> Optional[str]:
        return f"http://{self.addr}:{self.port}/metrics" \
            if self._server is not None else None

    def _start_server(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (http.server API)
                if self.path.split("?")[0].rstrip("/") not in ("",
                                                               "/metrics"):
                    self.send_error(404)
                    return
                body = exporter.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):    # scrapes must not spam stderr
                pass

        try:
            self._server = ThreadingHTTPServer((self.addr, self.port),
                                               _Handler)
        except OSError as e:       # port taken: degrade, never kill the run
            logger.warning(f"prometheus exporter cannot bind "
                           f"{self.addr}:{self.port} ({e}); disabled")
            self.enabled = False
            self._server = None
            return
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="dstpu-prom-export", daemon=True)
        self._thread.start()
        logger.info(f"prometheus exporter serving on {self.url}")

    def close(self):
        """Write the final snapshot (``metrics.prom``) and stop the server.
        Idempotent; ``MonitorMaster.close`` calls this BEFORE the CSV close
        so the drained snapshot is on disk with the rest of the run."""
        if self._snapshot_dir and self._values:
            import os
            try:
                with open(os.path.join(self._snapshot_dir,
                                       "metrics.prom"), "w") as f:
                    f.write(self.render())
            except OSError as e:  # a failing snapshot must not mask teardown
                logger.warning(f"prometheus snapshot write failed: {e}")
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class TelemetryPump:
    """Optional push loop feeding a monitor from live sources: a daemon
    thread that every ``interval_s`` calls
    ``source.write_monitor_events(monitor, step)`` for each source (an
    engine, a frontend, a ``ServingRouter`` — anything with that surface),
    with ``step`` incrementing per tick. The serving loops stay oblivious;
    a scraped :class:`PrometheusExporter` (or any backend) stays fresh.
    ``close()`` runs one final pump so the last tick's state is never
    lost."""

    def __init__(self, monitor, sources, interval_s: float = 1.0):
        self.monitor = monitor
        self.sources = list(sources)
        self.interval_s = float(interval_s)
        self.step = 0  # threadlint: guarded-by=monitor.telemetry.step
        self._step_lock = make_lock("monitor.telemetry.step")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def pump_once(self) -> int:
        """One synchronous fan-in tick; returns the step it stamped. The
        step is RESERVED under its lock up front (the pump thread and a
        caller-side final drain both tick), so
        concurrent ticks stamp distinct steps; the slow source fan-in
        itself runs unlocked."""
        with self._step_lock:
            step = self.step
            self.step += 1
        for src in self.sources:
            try:
                src.write_monitor_events(self.monitor, step)
            except Exception as e:   # telemetry must never kill serving
                logger.warning(f"telemetry pump source "
                               f"{type(src).__name__} failed: {e}")
        return step

    def start(self) -> "TelemetryPump":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="dstpu-telemetry", daemon=True)
        self._thread.start()
        return self

    @thread_role("dstpu-telemetry")
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.pump_once()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.pump_once()           # final drain: the last state lands

    def __enter__(self) -> "TelemetryPump":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
