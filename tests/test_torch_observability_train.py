"""The training side of the port's timeline: the counters equal the spans.
``train_batch``'s five stamps feed both ``train_stats`` and the
``train/step/*`` spans (their sums agree to 1e-3 ms a step), the producer
records ``train/prefetch/stage``, checkpoints record ``ckpt/*`` spans whose
counts equal ``CheckpointStats``, tracing changes no loss, and every
exported trace passes ``scripts/trace_check.py`` unchanged. Against the
JAX package: a traced tiny GPT-2 run records the same set of span names on
the same lanes."""

import glob
import os
import subprocess
import sys
import time

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
from deepspeed_tpu.monitor.trace import tracer as jax_tracer
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.monitor.trace import tracer
from deepspeed_tpu_torch.utils.timer import Timer

from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 16


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracer.reset()
    yield
    tracer.reset()


def _trace_check(path, *args):
    r = subprocess.run([sys.executable, "scripts/trace_check.py", str(path), *args],
                       capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (8, T)).astype(np.int32)} for _ in range(n)]


def _engine(extra=None, data=None):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "steps_per_print": 1,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    cfg.update(extra or {})
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=0), config=cfg,
        training_data=data, device="cpu")
    return engine


def test_timer_emits_spans_when_tracing(tmp_path):
    t = Timer("fwd", device="cpu")
    t.start()
    t.stop()
    assert tracer.summary() == {}
    tracer.configure(trace_dir=str(tmp_path))
    t.reset()
    t.start()
    time.sleep(0.001)
    t.stop()
    count, total = tracer.summary()["timer/fwd"]
    assert count == 1 and total > 0
    assert total == pytest.approx(t.elapsed(reset=False), rel=1e-6)


def test_engine_traces_train_steps_and_exports(tmp_path):
    engine = _engine({"monitor": {"trace": {"dir": str(tmp_path), "ring_size": 512}}})
    assert tracer.enabled and tracer.trace_dir == str(tmp_path)
    for b in _batches(3):
        engine.train_batch(b)
    summary = tracer.summary()
    assert summary["train/step"][0] == engine.train_stats.steps == 3
    assert summary["train/step/dispatch"][0] == 3
    assert summary["train/step"][1] >= summary["train/step/dispatch"][1]
    # the phase sums read the stats' own stamps
    st = engine.train_stats
    for phase, field in (("dispatch", "dispatch_ms"), ("drain", "drain_ms"),
                         ("host_build", "host_build_ms")):
        assert 1e3 * summary[f"train/step/{phase}"][1] == \
            pytest.approx(getattr(st, field), abs=1e-3 * st.steps)
    assert len(st.step_wall_ms) == 3
    engine.destroy()
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert files
    _trace_check(tmp_path, "--require", "train/step", "train/drain")


def test_engine_tracing_does_not_change_loss_stream(tmp_path):
    batches = _batches(3, seed=1)
    plain = _engine()
    losses_plain = [float(plain.train_batch(b)) for b in batches]
    plain.destroy()
    tracer.reset()
    traced = _engine({"monitor": {"trace": {"dir": str(tmp_path)}},
                      "csv_monitor": {"enabled": True, "output_path": str(tmp_path),
                                      "job_name": "j"}})
    losses_traced = [float(traced.train_batch(b)) for b in batches]
    traced.destroy()
    assert losses_traced == losses_plain


def test_prefetch_producer_records_stage_spans(tmp_path):
    data = [{"input_ids": np.full((T,), i % 256, np.int32)} for i in range(64)]
    engine = _engine({"monitor": {"trace": {"dir": str(tmp_path)}},
                      "train_pipeline": {"prefetch": 2}}, data=data)
    for _ in range(4):
        engine.train_batch()
    summary = tracer.summary()
    assert summary["train/prefetch/stage"][0] >= 4
    assert summary["train/step/dequeue_wait"][0] == engine.train_stats.prefetched_steps == 4
    engine.destroy()
    _trace_check(tmp_path, "--require", "train/step", "train/drain", "train/prefetch")


def test_checkpoint_spans_match_checkpoint_stats(tmp_path):
    """Rolling async saves every 2 of 6 steps and one user save: every
    ckpt/* span name is recorded; the snapshot spans count the saves and
    the commit spans the commits."""
    engine = _engine({"monitor": {"trace": {"dir": str(tmp_path / "trace")}},
                      "checkpoint": {"engine": "async", "writers": 2,
                                     "rolling": {"every_n_steps": 2, "keep_last": 1,
                                                 "save_dir": str(tmp_path / "rolling")}}})
    for b in _batches(6, seed=2):
        engine.train_batch(b)
    engine._rolling.flush()
    summary = tracer.summary()
    st = engine.ckpt_stats
    assert st.saves == summary["ckpt/snapshot"][0] == summary["ckpt/backpressure"][0] == 3
    assert st.commits == summary["ckpt/commit"][0] == summary["ckpt/prune"][0] == 3
    assert 1e3 * summary["ckpt/snapshot"][1] == pytest.approx(st.snapshot_ms, abs=1e-3 * 3)
    assert summary["ckpt/write"][0] >= 6            # model + optim files a tag
    engine.save_checkpoint(str(tmp_path / "user"))
    assert tracer.summary()["ckpt/save"][0] == 1
    counters = [r for r in tracer.iter_records() if r[1] == "ckpt/writer_queue_depth"]
    assert len(counters) == 3
    engine.destroy()
    _trace_check(tmp_path / "trace", "--require", "train/step", "ckpt")


def _span_lanes(records):
    return {(r[1], r[4]) for r in records if r[3] is not None}


def test_span_names_and_lanes_match_jax_engine(tmp_path):
    """The same tiny GPT-2 config traced in both packages (steps_per_print
    1, so the metric drain runs every step): the same set of (span name,
    lane)."""
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "steps_per_print": 1,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "monitor": {"trace": {"enabled": True}}}
    model = JaxGPT2(JaxGPT2Config.tiny())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            {"input_ids": jnp.zeros((1, T), jnp.int32)})["params"]
    params = jax.tree_util.tree_map(lambda s: np.full(s.shape, 0.02, s.dtype), shapes)
    jax_tracer.reset()
    try:
        jeng, *_ = deepspeed_tpu.initialize(
            model=model, model_parameters=params, config=cfg,
            mesh_topology=build_topology(MeshConfig(data=1), devices=jax.devices()[:1]))
        for b in _batches(3, seed=4):
            jeng.train_batch(b)
        jeng.drain_metrics()
        jax_spans = _span_lanes(jax_tracer.iter_records())
    finally:
        jax_tracer.reset()
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=0),
        model_parameters={k: np.asarray(v) for k, v in flatten_tree(params).items()},
        config=cfg, device="cpu")
    for b in _batches(3, seed=4):
        peng.train_batch(b)
    peng.drain_metrics()
    port_spans = _span_lanes(tracer.iter_records())
    assert ("train/step/dispatch", "train/step") in port_spans
    assert ("train/drain/fetch_to_host", "train/drain") in port_spans
    assert port_spans == jax_spans
