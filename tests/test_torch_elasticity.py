"""The port's elasticity (``deepspeed_tpu_torch.elasticity``: the elastic
batch solver and ``DSElasticAgent``) on the JAX package's elasticity tests,
with the agent's restart resuming a port checkpoint; and the fault-injection
parts this slice adds: ``install_from_env`` (``DSTPU_FAULTS``), the
``agent.run`` site, and the ``step.kill`` site of ``train_batch`` killing a
subprocess that leaves a crash trace ``scripts/trace_check.py`` accepts.

The solver results are compared to the JAX package's exactly."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu.elasticity import compute_elastic_config as jax_compute
from deepspeed_tpu_torch.checkpoint.engine import NativeCheckpointEngine
from deepspeed_tpu_torch.checkpoint.state import commit_checkpoint, write_checkpoint_files
from deepspeed_tpu_torch.checkpoint.universal import load_universal
from deepspeed_tpu_torch.elasticity import ElasticityError, compute_elastic_config
from deepspeed_tpu_torch.elasticity.elastic_agent import DSElasticAgent
from deepspeed_tpu_torch.elasticity.elasticity import (_get_compatible_gpus_v01,
                                                       _get_compatible_gpus_v02,
                                                       validate_elastic_nodes)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.utils import fault_injection as fi

from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ELASTIC = {"elasticity": {"enabled": True, "max_train_batch_size": 32,
                          "micro_batch_sizes": [4, 8], "min_gpus": 1, "max_gpus": 8}}


@pytest.fixture(autouse=True)
def no_plan():
    fi.clear()
    yield
    fi.clear()


def base_config(**over):
    e = {"enabled": True, "max_train_batch_size": 10000,
         "micro_batch_sizes": [8, 12, 16, 17], "min_gpus": 32,
         "max_gpus": 1500, "prefer_larger_batch": True, "version": 0.2}
    e.update(over)
    return {"elasticity": e}


def test_basic_v01():
    final_batch, valid = _get_compatible_gpus_v01(
        micro_batches=[8, 12, 16], max_acceptable_batch_size=10000, min_gpus=32, max_gpus=1500)
    assert final_batch <= 10000
    for w in valid:
        assert 32 <= w <= 1500
        assert any(final_batch % (mb * w) == 0 for mb in (8, 12, 16))
    assert len(valid) > 10


def test_v02_granularity():
    final_batch, valid, chosen = _get_compatible_gpus_v02(
        micro_batches=[2, 4], max_acceptable_batch_size=2048, current_num_gpus=16,
        min_gpus=4, max_gpus=256, num_gpus_per_node=8)
    for w in valid:
        assert w % 8 == 0
    assert chosen == 16


def test_v02_model_parallel():
    final_batch, valid, chosen = _get_compatible_gpus_v02(
        micro_batches=[2], max_acceptable_batch_size=512, current_num_gpus=16,
        min_gpus=4, max_gpus=64, num_gpus_per_node=4, model_parallel_size=8)
    for w in valid:
        assert w % 8 == 0


def test_compute_elastic_config():
    final_batch, valid = compute_elastic_config(base_config())
    assert final_batch <= 10000
    assert valid
    w = valid[0]
    fb, vg, micro = compute_elastic_config(base_config(), world_size=w, return_microbatch=True)
    assert fb % (micro * w) == 0
    # the same answer as the JAX package's solver
    assert (final_batch, valid) == jax_compute(base_config())
    assert (fb, vg, micro) == jax_compute(base_config(), world_size=w, return_microbatch=True)


def test_invalid_world_size_rejected():
    cfg = base_config()
    _, valid = compute_elastic_config(cfg)
    bad = max(valid) + 1
    if bad not in valid:
        with pytest.raises(ElasticityError):
            compute_elastic_config(cfg, world_size=bad)


def test_disabled_raises():
    with pytest.raises(ElasticityError):
        compute_elastic_config({"elasticity": {"enabled": False}})


def test_negative_micro_batch_rejected():
    with pytest.raises(ElasticityError):
        compute_elastic_config(base_config(micro_batch_sizes=[-1, 4]))


def test_validate_elastic_nodes():
    validate_elastic_nodes(4, 2, 8)
    with pytest.raises(ElasticityError):
        validate_elastic_nodes(1, 2, 8)
    with pytest.raises(ElasticityError):
        validate_elastic_nodes(9, 2, 8)


def test_agent_legacy_run_fn_signature_unchanged():
    seen = []

    def run_fn(world_size, micro_batch, gas, resume):
        seen.append((world_size, micro_batch, gas, resume))

    rec = DSElasticAgent(ELASTIC, run_fn, device_counts=[4]).run()
    assert len(seen) == 1 and seen[0][0] == 4 and seen[0][3] is False
    assert rec.resume_from is None


def test_agent_restart_resumes_from_newest_complete_checkpoint(tmp_path):
    """The restart resumes from a universal conversion of the newest
    COMPLETE tag; a torn tag (a death mid-write) is skipped."""
    ckpt_dir = str(tmp_path / "ck")
    eng = NativeCheckpointEngine()
    flat = {"w": np.arange(8, dtype=np.float32)}
    files = write_checkpoint_files(eng, ckpt_dir, "rolling_step3", flat, flat,
                                   {"global_steps": 3})
    commit_checkpoint(eng, ckpt_dir, "rolling_step3", files)
    os.makedirs(os.path.join(ckpt_dir, "rolling_step6"), exist_ok=True)
    np.savez(os.path.join(ckpt_dir, "rolling_step6", "model_states"), **flat)
    calls = []

    def run_fn(world_size, micro_batch, gas, resume, resume_from):
        calls.append((world_size, resume, resume_from))
        if len(calls) == 1:
            raise RuntimeError("preempted")

    agent = DSElasticAgent(ELASTIC, run_fn, device_counts=[4, 2], max_restarts=2,
                           ckpt_dir=ckpt_dir)
    rec = agent.run()
    assert [c[:2] for c in calls] == [(4, False), (2, True)]
    assert calls[0][2] is None
    resume_from = calls[1][2]
    assert resume_from is not None and "rolling_step3" in resume_from
    master, optim, meta = load_universal(resume_from)
    np.testing.assert_array_equal(master["w"], flat["w"])
    assert meta["source_tag"] == "rolling_step3"
    assert rec.world_size == 2 and rec.resume_from == resume_from


def test_agent_restart_without_any_checkpoint_starts_from_scratch(tmp_path):
    calls = []

    def run_fn(world_size, micro_batch, gas, resume, resume_from):
        calls.append((resume, resume_from))
        if len(calls) == 1:
            raise RuntimeError("died before the first checkpoint")

    DSElasticAgent(ELASTIC, run_fn, device_counts=[4, 2], max_restarts=1,
                   ckpt_dir=str(tmp_path / "empty")).run()
    assert calls == [(False, None), (True, None)]


def _engine_config(ckpt_dir, extra=None):
    cfg = {"train_batch_size": 8, "steps_per_print": 0,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "checkpoint": {"rolling": {"every_n_steps": 2, "keep_last": 2,
                                      "save_dir": str(ckpt_dir)}}}
    cfg.update(extra or {})
    return cfg


def _batches(n):
    rng = np.random.default_rng(3)
    return [{"input_ids": rng.integers(0, 256, (8, 16)).astype(np.int32)} for _ in range(n)]


def test_agent_restart_resumes_a_port_engine(tmp_path):
    """A tiny GPT-2 port engine dies after rolling_step2 committed; the
    restart loads the agent's universal conversion of it and finishes with
    the losses of a run that never died."""
    ckpt_dir = tmp_path / "ck"
    batches = _batches(4)
    ref = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=0),
        config=_engine_config(tmp_path / "ref"), device="cpu")[0]
    want = [float(ref.train_batch(b)) for b in batches]
    ref.destroy()
    got = {}

    def run_fn(world_size, micro_batch, gas, resume, resume_from):
        extra = {"checkpoint": {"load_universal": True}} if resume_from else None
        cfg = _engine_config(ckpt_dir)
        if extra:
            cfg["checkpoint"].update(extra["checkpoint"])
        eng = deepspeed_tpu_torch.initialize(
            model=GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=0), config=cfg,
            device="cpu")[0]
        try:
            if resume_from:
                eng.load_checkpoint(resume_from)
            for i in range(eng.global_steps, 4):
                got[i] = float(eng.train_batch(batches[i]))
                if not resume and i == 2:
                    raise RuntimeError("preempted after step 3")
        finally:
            eng.destroy()

    rec = DSElasticAgent(ELASTIC, run_fn, device_counts=[1, 1], max_restarts=1,
                         ckpt_dir=str(ckpt_dir)).run()
    assert rec.restarts == 1 and "rolling_step2" in rec.resume_from
    np.testing.assert_array_equal(np.array([got[i] for i in range(4)]), np.array(want))


# --------------------------------------------------------------------------- #
# fault injection: the parts this slice adds
# --------------------------------------------------------------------------- #

def test_install_from_env(monkeypatch):
    monkeypatch.setenv("DSTPU_FAULTS", "s:at=1")
    monkeypatch.setenv("DSTPU_SEED", "9")
    inj = fi.install_from_env()
    assert inj is not None and inj.seed == 9
    assert fi.install_from_env() is inj
    fi.clear()
    monkeypatch.setenv("DSTPU_FAULTS", "")
    assert fi.install_from_env() is None


def test_agent_run_site_consumes_restart_budget():
    fi.install(fi.parse_plan("agent.run:at=1:errno=104"))
    runs = []

    def run_fn(world_size, micro_batch, gas, resume):
        runs.append((world_size, resume))

    agent = DSElasticAgent(ELASTIC, run_fn, device_counts=[4, 2], max_restarts=2)
    rec = agent.run()
    assert runs == [(2, True)]
    assert rec.restarts == 1
    assert agent.records[0].error and "InjectedFault" in agent.records[0].error


def test_step_kill_from_env_kills_train_batch_and_leaves_crash_trace(tmp_path):
    """``DSTPU_FAULTS="step.kill:at=3:action=kill"`` armed by ``initialize``:
    the third ``train_batch`` exits the process with ``KILL_EXIT_CODE``
    before its step runs, and the flight recorder leaves a
    ``trace_crash.json`` with the first two steps that ``trace_check.py
    --expect-crash`` accepts."""
    trace_dir = tmp_path / "trace"
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np, torch
        torch.set_num_threads(1)
        import deepspeed_tpu_torch
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
        eng = deepspeed_tpu_torch.initialize(
            model=GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=0),
            config={{"train_batch_size": 8, "steps_per_print": 0}}, device="cpu")[0]
        for i in range(5):
            eng.train_batch({{"input_ids": np.zeros((8, 16), np.int32)}})
            print("step", i + 1, flush=True)
    """)
    env = dict(os.environ, DSTPU_FAULTS="step.kill:at=3:action=kill",
               DSTPU_TRACE=str(trace_dir), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == fi.KILL_EXIT_CODE, out.stderr[-2000:]
    # the port's logger writes to stdout too
    assert [l for l in out.stdout.splitlines() if l.startswith("step ")] == ["step 1", "step 2"]
    with open(trace_dir / "trace_crash.json") as f:
        names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                 or e.get("ph") == "B"]
    assert names.count("train/step") == 2
    check = subprocess.run([sys.executable, str(ROOT / "scripts" / "trace_check.py"),
                            str(trace_dir), "--expect-crash", "--require", "train/step"],
                           capture_output=True, text=True, timeout=60)
    assert check.returncode == 0, check.stdout + check.stderr
