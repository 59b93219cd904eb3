"""The port's monitor sinks (``deepspeed_tpu_torch.monitor``: CSV,
TensorBoard, W&B, the live Prometheus exporter and ``MonitorMaster``) on
the JAX package's monitor and exporter tests, and against the JAX package:
the same engine run writes the same CSV files, and the same events render
to the same Prometheus text.

Tolerances: the CSV values of the two engines' ``train_loss`` / ``lr`` /
``grad_norm`` at rtol 1e-4, the fp32 engine tier of
``tests/test_torch_train.py`` (per-step f32 differences of ~1e-7 compound
through AdamW); everything else exact.
"""

import csv
import os
import socket
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.comm.mesh import build_topology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.monitor import PrometheusExporter as JaxExporter
from deepspeed_tpu_torch.config import DeepSpeedTPUConfig
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.monitor import (CsvMonitor, MonitorMaster, OffloadPipelineStats,
                                         PrometheusExporter, TelemetryPump, TensorBoardMonitor,
                                         WandbMonitor, sanitize_metric_name)
from deepspeed_tpu_torch.monitor import monitor as port_monitor

from tests._torch_threads import one_torch_thread  # noqa: F401


def _cfg(tmp_path, prom=None, csv_on=True, **over):
    d = {"train_batch_size": 8}
    if csv_on:
        d["csv_monitor"] = {"enabled": True, "output_path": str(tmp_path), "job_name": "job"}
    if prom is not None:
        d["prometheus"] = prom
    d.update(over)
    return DeepSpeedTPUConfig.load(d)


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _engine(tmp_path, job, **over):
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=0)
    cfg = {"train_batch_size": 8,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "csv_monitor": {"enabled": True, "output_path": str(tmp_path), "job_name": job}}
    cfg.update(over)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    return engine


BATCH = {"input_ids": np.zeros((8, 16), np.int32)}


# --------------------------------------------------------------------------- #
# the JAX package's tests/unit/test_monitor.py, against the port
# --------------------------------------------------------------------------- #

def test_csv_monitor_writes_files(tmp_path):
    cfg = _cfg(tmp_path)
    mon = CsvMonitor(cfg.csv_monitor)
    mon.write_events([("Train/Samples/train_loss", 1.5, 10),
                      ("Train/Samples/train_loss", 1.25, 20),
                      ("Train/Samples/lr", 1e-3, 10)])
    mon.close()
    loss_file = os.path.join(str(tmp_path), "job", "Train_Samples_train_loss.csv")
    rows = _rows(loss_file)
    assert rows[0] == ["step", "value"]
    assert rows[1] == ["10", "1.5"]
    assert rows[2] == ["20", "1.25"]
    assert os.path.exists(os.path.join(str(tmp_path), "job", "Train_Samples_lr.csv"))


def test_monitor_master_fanout_and_gating(tmp_path):
    master = MonitorMaster(_cfg(tmp_path))
    assert master.enabled
    master.write_events([("Train/Samples/train_loss", 2.0, 1)])
    assert os.path.exists(os.path.join(str(tmp_path), "job", "Train_Samples_train_loss.csv"))
    master_off = MonitorMaster(DeepSpeedTPUConfig.load({"train_batch_size": 8}))
    assert not master_off.enabled
    master_off.write_events([("x", 1.0, 1)])


def test_disabled_backends_degrade():
    cfg = DeepSpeedTPUConfig.load({"train_batch_size": 8})
    assert not TensorBoardMonitor(cfg.tensorboard).enabled
    assert not WandbMonitor(cfg.wandb).enabled


def test_engine_writes_monitor_events(tmp_path):
    engine = _engine(tmp_path, "engine_job")
    engine.train_batch(BATCH)
    loss_file = os.path.join(str(tmp_path), "engine_job", "Train_Samples_train_loss.csv")
    # metrics ride ONE STEP LATE: nothing lands until the next step drains step 1
    assert not os.path.exists(loss_file)
    engine.train_batch(BATCH)
    assert len(_rows(loss_file)) == 2
    engine.drain_metrics()
    assert len(_rows(loss_file)) == 3
    engine.destroy()



_SECTIONS = {
    "tensorboard": lambda out: {"tensorboard": {"enabled": True, "output_path": out,
                                                "job_name": "tb"}},
    "wandb": lambda out: {"wandb": {"enabled": True, "project": "p"}},
    "csv_monitor": lambda out: {"csv_monitor": {"enabled": True, "output_path": out,
                                                "job_name": "job"}},
    "prometheus": lambda out: {"prometheus": {"enabled": True, "port": 0}},
    "monitor.trace": lambda out: {"monitor": {"trace": {"enabled": True, "dir": out}}},
    "flops_profiler": lambda out: {"flops_profiler": {"enabled": True, "profile_step": 1,
                                                      "output_file": os.path.join(out, "fp.txt")}},
}


@pytest.mark.parametrize("section", list(_SECTIONS))
def test_ported_section_builds_engine_and_steps(tmp_path, monkeypatch, section):
    """Each monitor section the port accepts builds an engine through
    ``initialize`` and takes steps; without their wheels TensorBoard and
    W&B warn and disable themselves, as in the JAX package."""
    import sys
    from deepspeed_tpu_torch.monitor.trace import tracer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    out = str(tmp_path)
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=0)
    cfg = {"train_batch_size": 8, "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           **_SECTIONS[section](out)}
    tracer.reset()
    try:
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
        losses = [float(engine.train_batch(BATCH)) for _ in range(2)]
        assert all(np.isfinite(losses))
        m = engine.monitor
        if section in ("tensorboard", "wandb"):
            assert not (m.tb_monitor.enabled or m.wandb_monitor.enabled or m.enabled)
        elif section == "prometheus":
            engine.drain_metrics()
            assert m.prom_monitor.enabled
            assert "dstpu_Train_Samples_train_loss" in m.prom_monitor.render()
        elif section == "monitor.trace":
            assert tracer.enabled and tracer.summary()["train/step"][0] == 2
        elif section == "flops_profiler":
            assert engine.flops_profiler is not None
            assert engine.flops_profiler.get_total_flops() > 0
        engine.destroy()
        if section == "csv_monitor":
            rows = _rows(os.path.join(out, "job", "Train_Samples_train_loss.csv"))[1:]
            assert [float(v) for _, v in rows] == pytest.approx(losses, rel=1e-6)
        elif section == "monitor.trace":
            assert any(f.startswith("trace_") for f in os.listdir(out))
    finally:
        tracer.reset()

def test_offload_pipeline_stats_counters_and_events():
    st = OffloadPipelineStats()
    st.add("fetch", 0.001)
    st.add("kernel", 0.004)
    st.add("upload", 0.002)
    st.add("swap", 0.010)
    st.record_step(groups=2, depth_sum=1)
    st.add("kernel", 0.004)
    st.record_step(groups=2)
    assert st.steps == 2 and st.groups == 4
    assert st.kernel_ms == pytest.approx(8.0)
    ev = dict((name, val) for name, val, _ in st.events(16))
    assert ev["train/offload/kernel_ms_per_group"] == pytest.approx(2.0)
    assert ev["train/offload/swap_ms_per_step"] == pytest.approx(5.0)
    assert ev["train/offload/groups_per_step"] == pytest.approx(2.0)
    with pytest.raises(KeyError):
        st.add("bogus_phase", 0.1)
    st.reset()
    assert st.steps == 0 and st.kernel_ms == 0.0 and st.upload_depth_sum == 0


def test_monitor_master_rank0_gating(tmp_path, monkeypatch):
    """Only rank 0 writes (the torch.distributed rank where a group is up)."""
    monkeypatch.setattr(port_monitor, "_rank", lambda: 1)
    master = MonitorMaster(_cfg(tmp_path))
    assert master.enabled
    master.write_events([("Train/Samples/train_loss", 2.0, 1)])
    assert not os.path.exists(os.path.join(str(tmp_path), "job",
                                           "Train_Samples_train_loss.csv"))


def test_tensorboard_degrades_without_wheel(tmp_path, monkeypatch):
    """Without the tensorboard wheel an enabled section warns and disables
    its backend (the JAX package's rule); the master keeps its others."""
    import sys
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _cfg(tmp_path, tensorboard={"enabled": True, "output_path": str(tmp_path),
                                      "job_name": "tb"})
    tb = TensorBoardMonitor(cfg.tensorboard)
    assert not tb.enabled
    tb.write_events([("x", 1.0, 1)])
    tb.close()
    master = MonitorMaster(cfg)
    assert master.enabled and not master.tb_monitor.enabled
    master.write_events([("Train/Samples/train_loss", 1.0, 1)])
    assert os.path.exists(os.path.join(str(tmp_path), "job", "Train_Samples_train_loss.csv"))
    master.close()


def test_monitor_master_fanout_ordering(tmp_path):
    master = MonitorMaster(_cfg(tmp_path))
    calls = []

    class Recorder:
        def __init__(self, name):
            self.name = name
            self.enabled = True

        def write_events(self, events):
            calls.append((self.name, list(events)))

        def close(self):
            calls.append((self.name, "closed"))

    master.tb_monitor = Recorder("tb")
    master.wandb_monitor = Recorder("wandb")
    master.csv_monitor = Recorder("csv")
    events = [("a", 1.0, 1), ("b", 2.0, 1), ("a", 3.0, 2)]
    master.write_events(iter(events))
    assert [name for name, _ in calls] == ["tb", "wandb", "csv"]
    assert all(got == events for _, got in calls)
    calls.clear()
    master.close()
    assert calls == [("tb", "closed"), ("wandb", "closed"), ("csv", "closed")]


def test_monitor_master_close_closes_csv_files(tmp_path):
    master = MonitorMaster(_cfg(tmp_path))
    master.write_events([("Train/Samples/train_loss", 1.0, 1)])
    assert master.csv_monitor._files
    master.close()
    assert master.csv_monitor._files == {}
    master.close()


def test_engine_destroy_flushes_final_step_without_manual_drain(tmp_path):
    engine = _engine(tmp_path, "flush_job")
    engine.train_batch(BATCH)
    engine.train_batch(BATCH)
    loss_file = os.path.join(str(tmp_path), "flush_job", "Train_Samples_train_loss.csv")
    engine.destroy()
    assert len(_rows(loss_file)) == 3
    assert engine.monitor.csv_monitor._files == {}


def test_engine_emits_offload_events_at_print_boundary(tmp_path):
    engine = _engine(tmp_path, "off_job", steps_per_print=1,
                     zero_optimization={"stage": 1, "offload_optimizer": {"device": "cpu"}})
    engine.train_batch(BATCH)
    engine.train_batch(BATCH)
    engine.drain_metrics()
    kernel_file = os.path.join(str(tmp_path), "off_job", "train_offload_kernel_ms_per_group.csv")
    assert len(_rows(kernel_file)) >= 2
    engine.destroy()


# --------------------------------------------------------------------------- #
# the JAX package's tests/unit/test_export.py, against the port
# --------------------------------------------------------------------------- #

def _scrape(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def test_sanitize_metric_name_maps_event_namespace():
    assert sanitize_metric_name("serve/frontend/r0/queue_depth") == \
        "dstpu_serve_frontend_r0_queue_depth"
    assert sanitize_metric_name("a-b.c:d", prefix="") == "a_b_c:d"
    assert sanitize_metric_name("0weird")[0].isalpha()


def test_disabled_exporter_is_inert(tmp_path):
    exp = PrometheusExporter(_cfg(tmp_path, prom={"enabled": False}).prometheus)
    assert not exp.enabled
    assert exp._server is None and exp._thread is None
    assert exp.url is None
    exp.write_events([("x", 1.0, 1)])
    assert exp._values == {}
    exp.close()
    exp.close()


def test_default_config_has_exporter_off(tmp_path):
    master = MonitorMaster(_cfg(tmp_path))
    assert not master.prom_monitor.enabled
    assert master.prom_monitor._server is None
    master.close()


def test_scrape_serves_latest_values(tmp_path):
    exp = PrometheusExporter(_cfg(tmp_path, prom={"enabled": True, "port": 0}).prometheus)
    try:
        assert exp.enabled and exp.port != 0
        exp.write_events([("serve/frontend/queue_depth", 3.0, 1),
                          ("serve/slo/missed", 1.0, 1)])
        exp.write_events([("serve/frontend/queue_depth", 5.0, 2)])
        status, ctype, body = _scrape(exp.url)
        assert status == 200
        assert "version=0.0.4" in ctype
        assert "dstpu_serve_frontend_queue_depth 5.0" in body
        assert "dstpu_serve_frontend_queue_depth_step 2" in body
        assert "dstpu_serve_slo_missed 1.0" in body
        assert "# TYPE dstpu_serve_slo_missed gauge" in body
        with pytest.raises(urllib.error.HTTPError):
            _scrape(exp.url.replace("/metrics", "/other"))
    finally:
        exp.close()
    assert exp._server is None and exp._thread is None


def test_bind_failure_degrades_not_raises(tmp_path):
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    try:
        exp = PrometheusExporter(_cfg(tmp_path, prom={"enabled": True, "port": port}).prometheus)
        assert not exp.enabled and exp._server is None
        exp.write_events([("x", 1.0, 1)])
        exp.close()
    finally:
        blocker.close()


def test_master_fans_out_to_exporter(tmp_path):
    master = MonitorMaster(_cfg(tmp_path, prom={"enabled": True, "port": 0}))
    try:
        assert master.enabled
        master.write_events([("serve/router/completed", 7.0, 3)])
        assert os.path.exists(os.path.join(str(tmp_path), "job", "serve_router_completed.csv"))
        _, _, body = _scrape(master.prom_monitor.url)
        assert "dstpu_serve_router_completed 7.0" in body
    finally:
        master.close()


def test_exporter_alone_enables_master(tmp_path):
    master = MonitorMaster(_cfg(tmp_path, prom={"enabled": True, "port": 0}, csv_on=False))
    try:
        assert master.enabled
        master.write_events([("x", 2.0, 1)])
        assert master.prom_monitor._values["x"] == (2.0, 1)
    finally:
        master.close()


def test_master_rank0_gating_covers_exporter(tmp_path, monkeypatch):
    """A non-zero rank binds no exporter and writes nothing to it."""
    monkeypatch.setattr(port_monitor, "_rank", lambda: 1)
    master = MonitorMaster(_cfg(tmp_path, prom={"enabled": True, "port": 0}))
    try:
        assert not master.prom_monitor.enabled
        assert master.prom_monitor._server is None
        assert master.prom_monitor.url is None
        master.write_events([("serve/slo/missed", 1.0, 1)])
        assert master.prom_monitor._values == {}
    finally:
        master.close()


def test_master_close_drains_snapshot_before_csv_close(tmp_path):
    master = MonitorMaster(_cfg(tmp_path, prom={"enabled": True, "port": 0,
                                                "output_path": str(tmp_path),
                                                "job_name": "job"}))
    master.write_events([("serve/slo/missed", 4.0, 9)])
    prom_path = os.path.join(str(tmp_path), "job", "metrics.prom")
    assert not os.path.exists(prom_path)
    seen = []
    real_csv_close = master.csv_monitor.close
    master.csv_monitor.close = lambda: (seen.append(os.path.exists(prom_path)), real_csv_close())
    master.close()
    assert seen == [True]
    with open(prom_path) as f:
        body = f.read()
    assert "dstpu_serve_slo_missed 4.0" in body
    assert "dstpu_serve_slo_missed_step 9" in body
    master.close()


def test_master_degrades_on_config_without_prometheus_section(tmp_path):
    cfg = _cfg(tmp_path)
    partial = types.SimpleNamespace(tensorboard=cfg.tensorboard, wandb=cfg.wandb,
                                    csv_monitor=cfg.csv_monitor)
    master = MonitorMaster(partial)
    assert master.enabled and not master.prom_monitor.enabled
    master.write_events([("x", 1.0, 1)])
    master.close()


class _Source:
    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def write_monitor_events(self, monitor, step):
        if self.fail:
            raise RuntimeError("boom")
        self.calls.append(step)
        monitor.write_events([("pumped", float(step), step)])


def test_pump_once_fans_in_and_steps(tmp_path):
    exp = PrometheusExporter(_cfg(tmp_path, prom={"enabled": True, "port": 0}).prometheus)
    try:
        a, b = _Source(), _Source()
        pump = TelemetryPump(exp, [a, b], interval_s=60.0)
        assert pump.pump_once() == 0
        assert pump.pump_once() == 1
        assert a.calls == [0, 1] and b.calls == [0, 1]
        assert exp._values["pumped"] == (1.0, 1)
    finally:
        exp.close()


def test_pump_survives_failing_source(tmp_path):
    exp = PrometheusExporter(_cfg(tmp_path, prom={"enabled": True, "port": 0}).prometheus)
    try:
        ok = _Source()
        pump = TelemetryPump(exp, [_Source(fail=True), ok], interval_s=60.0)
        pump.pump_once()
        assert ok.calls == [0]
    finally:
        exp.close()


def test_pump_close_runs_final_drain(tmp_path):
    exp = PrometheusExporter(_cfg(tmp_path, prom={"enabled": True, "port": 0}).prometheus)
    try:
        src = _Source()
        with TelemetryPump(exp, [src], interval_s=60.0):
            pass
        assert src.calls
        assert exp._values["pumped"][1] == src.calls[-1]
    finally:
        exp.close()


# --------------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------------- #

T = 32


def _csv_config(out, job):
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
            "gradient_clipping": 1.0, "steps_per_print": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0, "warmup_max_lr": 1e-3, "warmup_num_steps": 3}},
            "csv_monitor": {"enabled": True, "output_path": str(out), "job_name": job}}


def _read_job(path):
    return {name: _rows(os.path.join(path, name)) for name in sorted(os.listdir(path))}


def test_engine_csv_files_match_jax_engine(tmp_path):
    """Tiny GPT-2 on the same weights, config and batches: the two engines
    write the same CSV file names and steps, and the same train_loss / lr /
    grad_norm values at the fp32 engine tier."""
    model = JaxGPT2(JaxGPT2Config.tiny())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            {"input_ids": jnp.zeros((1, T), jnp.int32)})["params"]
    rng = np.random.default_rng(0)
    flat = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
            for k, v in flatten_tree(shapes).items()}
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes),
                                          [flat[k] for k in flatten_tree(shapes)])
    jeng, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=_csv_config(tmp_path, "jax"),
        mesh_topology=build_topology(MeshConfig(data=1), devices=jax.devices()[:1]))
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=1), model_parameters=flat,
        config=_csv_config(tmp_path, "port"), device="cpu")
    batches = [{"input_ids": rng.integers(0, 256, (8, T)).astype(np.int32)} for _ in range(4)]
    for b in batches:
        jeng.train_batch(b)
        peng.train_batch(b)
    jeng.destroy()
    peng.destroy()
    jax_rows = _read_job(os.path.join(tmp_path, "jax"))
    port_rows = _read_job(os.path.join(tmp_path, "port"))
    assert set(port_rows) == set(jax_rows)
    assert "train_pipeline_dispatch_ms_per_step.csv" in port_rows
    for name in jax_rows:
        assert [r[0] for r in port_rows[name]] == [r[0] for r in jax_rows[name]], name
    for name in ("Train_Samples_train_loss.csv", "Train_Samples_lr.csv",
                 "Train_Samples_grad_norm.csv"):
        got = np.array([float(r[1]) for r in port_rows[name][1:]])
        want = np.array([float(r[1]) for r in jax_rows[name][1:]])
        assert len(got) == 4
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)


def test_prometheus_text_matches_jax_exporter():
    """The same event list renders to the same Prometheus text."""
    events = [("Train/Samples/train_loss", 2.5, 8), ("serve/frontend/r0/queue_depth", 3.0, 2),
              ("inference/v2/pipeline/dispatch_ms_per_step", 0.125, 1),
              ("Train/Samples/lr", 1e-4, 8), ("Train/Samples/train_loss", 2.25, 16)]
    cfg = types.SimpleNamespace(enabled=False, prefix="dstpu")
    jexp, pexp = JaxExporter(cfg), PrometheusExporter(cfg)
    for exp in (jexp, pexp):
        # enabled without a server: the event path and render() only
        exp.enabled = True
        exp.write_events(events)
    assert pexp.render() == jexp.render()
    assert "dstpu_Train_Samples_train_loss 2.25" in pexp.render()
