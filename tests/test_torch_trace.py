"""The port's span tracer (deepspeed_tpu_torch.monitor.trace, a copy of the
JAX package's): the ring, request lanes and ``install_from_env``; the same
records export the same Chrome-trace events as the JAX tracer's; the flight
recorder on an injected fault; and traces of the port's serving frontend and
router that ``scripts/trace_check.py`` accepts unchanged."""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.monitor import trace as jax_trace
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.serving import ServingCluster, ServingRouter
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.monitor.trace import (DEFAULT_REQ_LANE_WINDOW, DEFAULT_RING_SIZE,
                                               _NOOP, Tracer, install_from_env, tracer)
from deepspeed_tpu_torch.utils import fault_injection as fi

from tests._torch_threads import one_torch_thread  # noqa: F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "trace_check", os.path.join(REPO_ROOT, "scripts", "trace_check.py"))
trace_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_check)

_CLASSES = [{"name": "hi", "priority": 2, "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6},
            {"name": "lo", "priority": 0, "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6}]


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """The module tracer is process-global: isolate every test."""
    tracer.reset()
    yield
    tracer.reset()


def _validate(path):
    errors = []
    events, tracks, *_ = trace_check.check_file(path, errors)
    assert errors == [], errors
    return events, tracks


def _run_trace_check(path, *args):
    r = subprocess.run([sys.executable, "scripts/trace_check.py", path, *args],
                       capture_output=True, text=True, cwd=REPO_ROOT, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr


def test_disabled_tracer_is_noop(tmp_path):
    assert not tracer.enabled
    assert tracer.span("x") is _NOOP
    with tracer.span("x", lane="l"):
        pass
    tracer.add("x", 0.0, 1.0)
    tracer.instant("x")
    tracer.counter("x", 1.0)
    assert tracer.summary() == {}
    assert tracer.export() is None
    assert tracer.crash_dump("nope") is None
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("env, ring, lanes", [
    ({"DSTPU_TRACE_RING": "128"}, 128, DEFAULT_REQ_LANE_WINDOW),
    ({"DSTPU_TRACE_REQ_LANES": "7"}, DEFAULT_RING_SIZE, 7),
], ids=["ring", "req_lanes"])
def test_install_from_env(tmp_path, monkeypatch, env, ring, lanes):
    """The JAX package's environment names arm the port's tracer; a second
    arm does not reconfigure it; building an engine arms it too."""
    monkeypatch.delenv("DSTPU_TRACE", raising=False)
    assert not install_from_env().enabled
    monkeypatch.setenv("DSTPU_TRACE", str(tmp_path))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tr = install_from_env()
    assert tr.enabled and tr.trace_dir == str(tmp_path)
    assert tr.ring_size == ring and tr.req_lane_window == lanes
    monkeypatch.setenv("DSTPU_TRACE", "/nonexistent")
    assert install_from_env().trace_dir == str(tmp_path)
    tracer.reset()
    monkeypatch.setenv("DSTPU_TRACE", str(tmp_path))
    _engine()
    assert tracer.enabled and tracer.trace_dir == str(tmp_path)


def test_ring_bounds_memory_keeps_newest(tmp_path):
    tracer.configure(trace_dir=str(tmp_path), ring_size=16)
    for i in range(40):
        tracer.add("s", float(i), float(i) + 0.5, i=i)
    count, _total = tracer.summary()["s"]
    assert count == 16
    events, _ = _validate(tracer.export())
    kept = sorted(e["args"]["i"] for e in events if e.get("ph") == "B")
    assert kept == list(range(24, 40))   # the NEWEST 16 survive


def test_req_lane_window_recycles_retired_lanes(tmp_path):
    tracer.configure(trace_dir=str(tmp_path), req_lane_window=2)
    base = time.perf_counter()
    for k in range(5):   # disjoint in time: u0 oldest ... u4 newest
        tracer.add("serve/req/decode", base + k, base + k + 0.5,
                   lane=f"serve/req/u{k}", uid=k)
    events, tracks = _validate(tracer.export())
    names = set(tracks.values())
    assert {"serve/req/u3", "serve/req/u4"} <= names
    assert not names & {"serve/req/u0", "serve/req/u1", "serve/req/u2"}
    assert "serve/req/recycled/0" in names and "serve/req/recycled/1" not in names
    assert sum(e.get("ph") == "B" for e in events) == 5


def _record(tr, t):
    """The same records through either tracer: spans on several lanes and a
    three-hop request flow (instants and counters stamp the clock at call
    time, so they are left out)."""
    tr.add("serve/router/route", t, t + 1e-3, lane="serve/router", uid=3,
           trace_id=11, replica="r0")
    tr.add("serve/req/queued", t + 1e-3, t + 2e-3, lane="serve/req/u3", uid=3,
           trace_id=11, cls="hi")
    tr.add("serve/req/decode", t + 2e-3, t + 5e-3, lane="serve/req/u3", uid=3,
           trace_id=11, cls="hi")
    tr.add("serve/req/prefill", t + 2e-3, t + 3e-3, lane="serve/req/u4", uid=4)
    tr.add("serve/health/detect", t, t + 4e-3, lane="serve/health", replica="r1",
           kind="stall")


def test_same_records_export_as_the_jax_tracer(tmp_path):
    """File-format parity: the port's exporter writes the JAX tracer's
    events for the same records (the process-name label aside), so the
    JAX package's trace scripts read the port's traces unchanged."""
    t = time.perf_counter()
    docs = []
    for name, cls in (("port", Tracer), ("jax", jax_trace.Tracer)):
        tr = cls()
        tr.configure(trace_dir=str(tmp_path / name), enabled=True)
        _record(tr, t)
        with open(tr.export()) as f:
            docs.append(json.load(f))
        tr.reset()
    port, ref = ([e for e in d["traceEvents"] if e.get("name") != "process_name"]
                 for d in docs)
    assert port == ref
    assert set(docs[0]) == set(docs[1])
    assert sum(e["ph"] in "stf" for e in port) == 3   # one flow chain, three hops


def test_injected_fault_dumps_flight_recorder(tmp_path):
    tracer.configure(trace_dir=str(tmp_path))
    with tracer.span("serve/req/decode", uid=7):
        pass
    fi.install(fi.parse_plan("unit.site:at=1:action=raise"))
    try:
        with pytest.raises(fi.InjectedFault):
            fi.maybe_fail("unit.site")
    finally:
        fi.clear()
    events, _ = _validate(str(tmp_path / "trace_crash.json"))
    names = {e["name"] for e in events}
    assert "serve/req/decode" in names
    assert any(n.startswith("crash: injected raise at unit.site") for n in names)


def _engine(num_blocks=24):
    cfg = LlamaConfig.tiny(vocab_size=128, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    econf = {"dtype": torch.float32,
             "state_manager": {"max_tracked_sequences": 8, "max_ragged_sequence_count": 4,
                               "max_ragged_batch_size": 96, "max_context": 176,
                               "prefill_chunk_size": 32},
             "kv_cache": {"block_size": 16, "num_blocks": num_blocks},
             "serving": {"decode_slice": 4, "idle_wait_s": 0.005, "classes": _CLASSES}}
    return InferenceEngineV2(model, econf, model.flat_params(), device="cpu")


def test_frontend_and_router_traces_pass_trace_check(tmp_path):
    """A frontend run through preemption, then a two-replica router run:
    the serve/req lifecycle spans, the serve/router placements and the
    request flow chains across lanes pass trace_check's gates."""
    tracer.configure(trace_dir=str(tmp_path))
    rng = np.random.RandomState(0)
    e = _engine(num_blocks=10)
    fe = e.serving_frontend()
    h_lo = fe.submit(rng.randint(0, 128, 24), priority="lo", max_new_tokens=40)
    for _ in range(5):
        fe.step()
    h_hi = fe.submit(rng.randint(0, 128, 112), priority="hi", max_new_tokens=8)
    for _ in range(400):
        if h_lo.finished and h_hi.finished:
            break
        fe.step()
    assert h_lo.status == h_hi.status == "finished" and fe.stats.preemptions >= 1
    fe.close()
    names = tracer.summary()
    for phase in ("queued", "prefill", "decode", "preempted", "restore"):
        assert f"serve/req/{phase}" in names, phase
    cluster = ServingCluster([_engine(), _engine()],
                             serving={"decode_slice": 4, "idle_wait_s": 0.005,
                                      "classes": _CLASSES})
    with ServingRouter(cluster, {"policy": "round_robin"}) as rt:
        hs = [rt.submit(rng.randint(0, 128, 16), priority="hi", max_new_tokens=4)
              for _ in range(3)]
        assert rt.drain(timeout=30)
        assert all(h.status == "finished" for h in hs)
    path = tracer.export()
    _validate(path)
    _run_trace_check(path, "--require", "serve/req", "serve/router",
                     "--require-flows", "serve/req")
