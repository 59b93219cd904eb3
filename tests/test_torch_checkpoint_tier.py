"""The port's checkpoint tier within the port (CPU): checkpoint engines,
torn tags and manifests, sharded and universal formats, ``zero_to_fp32``,
and rolling saves — the tests of ``tests/unit/test_checkpoint_tier.py`` and
``tests/unit/test_rolling_checkpoint.py`` that need no mesh and no offload,
on a tiny GPT-2 (the JAX tests' MLP has no counterpart: the port's engine
trains modules with flax-named parameters). Slow writers are the
``ckpt.stall`` fault site and gates are events; no assertion waits on a
wall-clock deadline.

Within the port every comparison is exact: the same ops in the same order
on the CPU give the same bytes.
"""

import atexit
import json
import os
import threading
from unittest import mock

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.checkpoint import (AsyncCheckpointEngine, CheckpointCorrupt,
                                            NativeCheckpointEngine, build_checkpoint_engine,
                                            ds_to_universal, load_sharded, load_universal,
                                            save_sharded)
from deepspeed_tpu_torch.checkpoint import engine as ckpt_engine_mod
from deepspeed_tpu_torch.checkpoint import rolling as rolling_mod
from deepspeed_tpu_torch.checkpoint import state as state_mod
from deepspeed_tpu_torch.checkpoint.state import (find_resume_tag, read_latest_tag,
                                                  snapshot_state_flats, tag_problem,
                                                  write_latest_tag)
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.monitor import CheckpointStats
from deepspeed_tpu_torch.utils import fault_injection

from tests._torch_threads import one_torch_thread  # noqa: F401

T = 16


def _model(seed=0, dtype=torch.float32):
    return GPT2LMHead(GPT2Config(vocab_size=64, n_positions=T, n_embd=32, n_layer=2,
                                 n_head=2, dtype=dtype), device="cpu", seed=seed)


def _batch(step):
    rng = np.random.default_rng(100 + step)
    return {"input_ids": rng.integers(0, 64, (8, T)).astype(np.int32)}


def _engine(cfg_extra=None, seed=0, dtype=torch.float32):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
           "steps_per_print": 0, "gradient_clipping": 1.0,
           "bf16": {"enabled": dtype == torch.bfloat16},
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}}
    if cfg_extra:
        cfg.update(cfg_extra)
    engine, *_ = deepspeed_tpu_torch.initialize(model=_model(seed, dtype), config=cfg,
                                                device="cpu")
    return engine


def _rolling_engine(save_dir, every=2, keep_last=2, max_pending=1, writers=2):
    return _engine({"checkpoint": {"engine": "async", "writers": writers,
                                   "rolling": {"every_n_steps": every,
                                               "save_dir": str(save_dir),
                                               "keep_last": keep_last,
                                               "max_pending": max_pending}}})


def _master(engine):
    return {n: t.detach().clone() for n, t in engine.state["master"].items()}


@pytest.fixture
def stall_writes():
    """Every checkpoint file write stalls at the ``ckpt.stall`` site."""
    fault_injection.install(fault_injection.parse_plan(
        "ckpt.stall:every=1:action=stall:delay_s=0.15"))
    yield
    fault_injection.clear()


# --------------------------------------------------------------------------- #
# checkpoint engines
# --------------------------------------------------------------------------- #

def test_engine_registry():
    assert isinstance(build_checkpoint_engine("native"), NativeCheckpointEngine)
    eng = build_checkpoint_engine("nebula")
    assert isinstance(eng, AsyncCheckpointEngine)
    eng.close()
    with pytest.raises(ValueError):
        build_checkpoint_engine("bogus")


def test_async_engine_commit_barrier(tmp_path):
    eng = AsyncCheckpointEngine()
    data = {f"k{i}": np.random.rand(100).astype(np.float32) for i in range(4)}
    paths = [str(tmp_path / f"f{i}.npz") for i in range(4)]
    for p in paths:
        eng.save(data, p)
    assert eng.commit("tag")
    for p in paths:
        got = dict(np.load(p))
        for k in data:
            np.testing.assert_array_equal(got[k], data[k])
    eng.close()


def test_async_engine_snapshot_isolation(tmp_path, monkeypatch):
    """A queued async write holds the snapshot's bytes even when the engine
    trains on, mutating its live state in place, before the writer runs."""
    real = ckpt_engine_mod._atomic_savez
    gate = threading.Event()

    def gated_savez(path, state_dict):
        assert gate.wait(30.0)
        real(path, state_dict)

    monkeypatch.setattr(ckpt_engine_mod, "_atomic_savez", gated_savez)
    eng = _rolling_engine(tmp_path, every=2, keep_last=8)
    eng.train_batch(_batch(0))
    eng.train_batch(_batch(1))          # step 2 queues rolling_step2's writes
    at_save = _master(eng)
    eng.train_batch(_batch(2))          # the writers still wait on the gate
    assert any(not torch.equal(eng.state["master"][n], t) for n, t in at_save.items())
    gate.set()
    eng._rolling.flush()
    with np.load(str(tmp_path / "rolling_step2" / "model_states.npz")) as f:
        saved = dict(f)
    assert set(saved) == set(at_save)
    for n, t in at_save.items():
        assert saved[n].tobytes() == t.numpy().tobytes(), n
    eng.destroy()


def test_async_engine_bare_save_after_tagged_commit_drains(tmp_path):
    """commit() ends the create() scope: a later bare save() must drain at
    ANY commit."""
    eng = AsyncCheckpointEngine(max_workers=1)
    eng.create("t1")
    eng.save({"a": np.ones(8, np.float32)}, str(tmp_path / "a.npz"))
    assert eng.commit("t1")
    eng.save({"b": np.full(8, 2.0, np.float32)}, str(tmp_path / "b.npz"))
    assert eng.commit("anything")
    np.testing.assert_array_equal(np.load(str(tmp_path / "b.npz"))["b"],
                                  np.full(8, 2.0, np.float32))
    eng.close()


def test_async_engine_in_training(tmp_path):
    eng = _engine({"checkpoint": {"engine": "async"}})
    for s in range(2):
        eng.train_batch(_batch(s))
    eng.save_checkpoint(str(tmp_path), tag="a1")
    # latest only after commit; file must be complete
    assert open(str(tmp_path / "latest")).read() == "a1"
    eng2 = _engine(seed=1)
    eng2.train_batch(_batch(0))
    eng2.load_checkpoint(str(tmp_path), tag="a1")
    assert eng2.global_steps == 2
    eng.destroy()


def test_json_config_reaches_async_engine_with_writers():
    eng = _engine({"checkpoint": {"engine": "async", "writers": 1}})
    cke = eng._checkpoint_engine()
    assert isinstance(cke, AsyncCheckpointEngine)
    assert cke._pool._max_workers == 1
    assert eng._checkpoint_engine() is cke   # built once, reused
    eng.destroy()
    cke2 = build_checkpoint_engine("async", {"writers": 3})
    assert cke2._pool._max_workers == 3
    cke2.close()


def test_async_commit_ordering_holds_under_slow_writer(tmp_path, monkeypatch,
                                                       stall_writes):
    """``latest`` flips only after every queued write for the tag is
    durable, with the writers stalled at ``ckpt.stall``."""
    real = ckpt_engine_mod._atomic_savez
    order = []

    def recording_savez(path, state_dict):
        real(path, state_dict)
        order.append(("data", os.path.basename(path)))

    monkeypatch.setattr(ckpt_engine_mod, "_atomic_savez", recording_savez)
    eng = _engine({"checkpoint": {"engine": "async"}})
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path), tag="slow")
    order.append(("latest", open(str(tmp_path / "latest")).read()))
    assert [kind for kind, _ in order] == ["data", "data", "latest"]
    assert order[-1][1] == "slow"
    assert fault_injection.active().hits("ckpt.stall") == 2
    for f in ("model_states.npz", "optim_states.npz"):
        assert dict(np.load(str(tmp_path / "slow" / f)))
    eng.destroy()


class _ExplodingArray:
    """np.savez coerces via __array__ — raise mid-write."""

    def __array__(self, dtype=None, copy=None):
        raise ValueError("writer exploded")


@pytest.mark.parametrize("engine_name", ["native", "async"])
def test_atomic_savez_never_leaves_tmp_on_writer_exception(tmp_path, engine_name):
    eng = build_checkpoint_engine(engine_name)
    path = str(tmp_path / "state.npz")
    with pytest.raises(ValueError, match="writer exploded"):
        eng.save({"ok": np.zeros(4, np.float32), "bad": _ExplodingArray()}, path)
        eng.commit("t")   # async engine surfaces the writer error here
    assert [f for f in os.listdir(str(tmp_path)) if ".tmp" in f] == []
    assert not os.path.exists(path)
    if engine_name == "async":
        eng.close()


def test_injected_writer_fault_retries_then_surfaces(tmp_path):
    """``ckpt.writer`` fires before the write: one failure is retried and
    counted; a persistent one surfaces from the save."""
    eng = NativeCheckpointEngine({"writer_retries": 1, "writer_backoff_s": 0.0})
    fault_injection.install(fault_injection.parse_plan("ckpt.writer:at=1"))
    try:
        eng.save({"a": np.ones(3, np.float32)}, str(tmp_path / "a.npz"))
        assert eng.retries == 1 and os.path.exists(str(tmp_path / "a.npz"))
        fault_injection.install(fault_injection.parse_plan("ckpt.writer:every=1"))
        with pytest.raises(fault_injection.InjectedFault):
            eng.save({"b": np.ones(3, np.float32)}, str(tmp_path / "b.npz"))
        assert not os.path.exists(str(tmp_path / "b.npz"))
    finally:
        fault_injection.clear()


# --------------------------------------------------------------------------- #
# sharded and universal formats, zero_to_fp32
# --------------------------------------------------------------------------- #

def test_sharded_save_load_roundtrip(tmp_path):
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    b = torch.arange(8, dtype=torch.int32)
    save_sharded(str(tmp_path / "sc"), {"model": {"w": w, "b": b}})
    assert os.path.exists(tmp_path / "sc" / "index.json")
    assert os.path.exists(tmp_path / "sc" / "shards_h0.npz")
    out = load_sharded(str(tmp_path / "sc"),
                       {"model": {"w": torch.empty(8, 8), "b": torch.empty(8)}}, "cpu")
    assert torch.equal(out["model"]["w"], w) and torch.equal(out["model"]["b"], b)
    assert out["model"]["b"].dtype == torch.int32
    w += 1                                        # saved bytes are a copy
    assert not torch.equal(out["model"]["w"], w)


def test_universal_roundtrip_resumes_the_same_stream(tmp_path):
    """Save -> universal -> load_universal into a fresh engine: the next
    steps equal the source engine's."""
    eng = _engine()
    for s in range(2):
        eng.train_batch(_batch(s))
    eng.save_checkpoint(str(tmp_path / "ck"), tag="u1")
    ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "uni"), tag="u1")
    master, optim, meta = load_universal(str(tmp_path / "uni"))
    assert meta["source_tag"] == "u1" and master and optim
    assert any(k.startswith("opt/exp_avg/") for k in optim)
    eng2 = _engine({"checkpoint": {"load_universal": True}}, seed=1)
    eng2.train_batch(_batch(0))
    eng2.load_checkpoint(str(tmp_path / "uni"))
    assert eng2.global_steps == 2
    l1 = [float(eng.train_batch(_batch(s))) for s in range(2, 4)]
    l2 = [float(eng2.train_batch(_batch(s))) for s in range(2, 4)]
    assert l1 == l2


def test_universal_round_trip_is_byte_identical(tmp_path):
    """universal -> engine -> tag -> universal: every fragment equal."""
    eng = _engine()
    for s in range(2):
        eng.train_batch(_batch(s))
    eng.save_checkpoint(str(tmp_path / "ck_n"), tag="t")
    ds_to_universal(str(tmp_path / "ck_n"), str(tmp_path / "uni_n"), tag="t")
    eng2 = _engine({"checkpoint": {"load_universal": True}}, seed=1)
    eng2.load_checkpoint(str(tmp_path / "uni_n"))
    eng2.save_checkpoint(str(tmp_path / "ck_m"), tag="t")
    ds_to_universal(str(tmp_path / "ck_m"), str(tmp_path / "uni_m"), tag="t")
    m_n, o_n, _ = load_universal(str(tmp_path / "uni_n"))
    m_m, o_m, _ = load_universal(str(tmp_path / "uni_m"))
    assert sorted(m_m) == sorted(m_n) and sorted(o_m) == sorted(o_n)
    for k in m_n:
        assert m_m[k].dtype == m_n[k].dtype and m_m[k].tobytes() == m_n[k].tobytes(), k
    for k in o_n:
        np.testing.assert_array_equal(np.asarray(o_m[k]), np.asarray(o_n[k]))


def test_load_universal_restores_counters_lr_and_scaler(tmp_path):
    sched = {"scheduler": {"type": "WarmupLR",
                           "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
                                      "warmup_num_steps": 10}}}
    eng = _engine(sched)
    for s in range(3):
        eng.train_batch(_batch(s))
    # perturb the loss-scaler state so its restoration is observable
    eng.state["scaler"]["scale"].fill_(2048.0)
    eng.state["scaler"]["growth_tracker"].fill_(7)
    eng.save_checkpoint(str(tmp_path / "ck"), tag="t")
    ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "uni"), tag="t")
    eng2 = _engine(dict(sched, checkpoint={"load_universal": True}), seed=1)
    eng2.train_batch(_batch(0))
    eng2.load_checkpoint(str(tmp_path / "uni"))
    assert eng2.global_steps == 3 and eng2.global_samples == 24 and eng2.micro_steps == 6
    assert int(eng2.state["step"]) == int(eng.state["step"]) == 3
    assert eng2.get_lr() == eng.get_lr()
    assert float(eng2.state["scaler"]["scale"]) == 2048.0
    assert int(eng2.state["scaler"]["growth_tracker"]) == 7


def test_zero_to_fp32(tmp_path):
    from deepspeed_tpu_torch.utils.zero_to_fp32 import (
        convert_zero_checkpoint_to_fp32_state_dict, get_fp32_state_dict_from_zero_checkpoint)
    eng = _engine()
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path), tag="z")
    sd = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    assert all(v.dtype == np.float32 for v in sd.values())
    live = _master(eng)
    assert set(sd) == set(live)
    for k in live:
        assert sd[k].tobytes() == live[k].numpy().tobytes(), k
    out = convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path),
                                                     str(tmp_path / "consolidated.pt"))
    tsd = torch.load(out, map_location="cpu")
    assert set(tsd) == {k.replace("/", ".") for k in live}
    for k in live:
        assert torch.equal(tsd[k.replace("/", ".")], live[k])
    npz = convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path), str(tmp_path / "c.npz"))
    assert set(np.load(npz).files) == set(live)


def test_zero_to_fp32_returns_the_path_it_wrote(tmp_path):
    """An output name with no extension is written as an npz, and the
    returned path is the file that holds it."""
    from deepspeed_tpu_torch.utils.zero_to_fp32 import convert_zero_checkpoint_to_fp32_state_dict
    eng = _engine()
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path), tag="z")
    out = convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path), str(tmp_path / "plain"))
    assert out == str(tmp_path / "plain.npz")
    assert not os.path.exists(str(tmp_path / "plain"))
    live = _master(eng)
    with np.load(out) as f:
        assert set(f.files) == set(live)
        for k in live:
            assert f[k].tobytes() == live[k].numpy().tobytes(), k


# --------------------------------------------------------------------------- #
# torn / partially-written checkpoints
# --------------------------------------------------------------------------- #

def _save_two_tags(tmp_path):
    """Two complete checkpoints (c1 older, c2 newer) from a live engine."""
    eng = _engine()
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path), tag="c1")
    eng.train_batch(_batch(1))
    eng.save_checkpoint(str(tmp_path), tag="c2")
    return eng


def _bit_rot(path):
    flat = dict(np.load(path))
    key = sorted(flat)[0]
    flat[key] = flat[key] + 1.0
    np.savez(path.replace(".npz", ""), **flat)


def _truncate(path):
    full = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(full[:len(full) // 2])


def test_corrupt_latest_falls_back_to_newest_complete(tmp_path):
    _save_two_tags(tmp_path)
    with open(str(tmp_path / "latest"), "w") as f:
        f.write("no_such_tag")
    assert find_resume_tag(str(tmp_path)) == "c2"
    eng2 = _engine(seed=1)
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.global_steps == 2


def test_missing_shard_skips_to_older_complete_tag(tmp_path):
    _save_two_tags(tmp_path)
    os.remove(str(tmp_path / "c2" / "optim_states.npz"))
    assert "missing optim_states.npz" in tag_problem(str(tmp_path), "c2")
    assert find_resume_tag(str(tmp_path)) == "c1"
    eng2 = _engine(seed=1)
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.global_steps == 1


def test_truncated_npz_detected_and_skipped(tmp_path):
    _save_two_tags(tmp_path)
    _truncate(str(tmp_path / "c2" / "model_states.npz"))
    assert "truncated/corrupt" in tag_problem(str(tmp_path), "c2")
    assert find_resume_tag(str(tmp_path)) == "c1"


def test_missing_or_torn_client_state_marks_tag_torn(tmp_path):
    _save_two_tags(tmp_path)
    os.remove(str(tmp_path / "c2" / "client_state.json"))
    assert "missing client_state.json" in tag_problem(str(tmp_path), "c2")
    assert find_resume_tag(str(tmp_path)) == "c1"
    with open(str(tmp_path / "c2" / "client_state.json"), "w") as f:
        f.write('{"global_steps": 2')   # crash mid-dump
    assert "truncated/corrupt client_state.json" in tag_problem(str(tmp_path), "c2")
    eng2 = _engine(seed=1)
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.global_steps == 1


def test_monotonic_latest_ignores_non_step_tag_digits(tmp_path):
    write_latest_tag(str(tmp_path), "run_20260803")
    write_latest_tag(str(tmp_path), "rolling_step48", monotonic=True)
    assert read_latest_tag(str(tmp_path)) == "rolling_step48"
    write_latest_tag(str(tmp_path), "global_step50")
    write_latest_tag(str(tmp_path), "rolling_step49", monotonic=True)
    assert read_latest_tag(str(tmp_path)) == "global_step50"


def test_ds_to_universal_skips_torn_latest(tmp_path):
    _save_two_tags(tmp_path)
    _truncate(str(tmp_path / "c2" / "model_states.npz"))
    out = ds_to_universal(str(tmp_path), str(tmp_path / "uni"))
    meta = json.load(open(os.path.join(out, "universal_meta.json")))
    assert meta["client_state"]["global_steps"] == 1   # converted c1


def test_verify_scan_falls_back_past_checksum_corrupt_newest(tmp_path):
    _save_two_tags(tmp_path)
    _bit_rot(str(tmp_path / "c2" / "model_states.npz"))
    assert find_resume_tag(str(tmp_path), verify=True) == "c1"
    eng2 = _engine({"checkpoint": {"verify_load": True}}, seed=1)
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.global_steps == 1


def test_explicit_torn_tag_raises_checkpoint_corrupt(tmp_path):
    _save_two_tags(tmp_path)
    os.remove(str(tmp_path / "c2" / "model_states.npz"))
    eng2 = _engine(seed=1)
    with pytest.raises(CheckpointCorrupt, match="missing model_states.npz"):
        eng2.load_checkpoint(str(tmp_path), tag="c2")


def test_verified_load_catches_checksum_mismatch(tmp_path):
    _save_two_tags(tmp_path)
    _bit_rot(str(tmp_path / "c2" / "model_states.npz"))
    eng2 = _engine(seed=1)
    before = _master(eng2)
    with pytest.raises(CheckpointCorrupt, match="checksum mismatch"):
        eng2.load_checkpoint(str(tmp_path), tag="c2", verify=True)
    # nothing was written into the live tensors before the check failed
    assert all(torch.equal(before[n], t) for n, t in eng2.state["master"].items())
    eng2.load_checkpoint(str(tmp_path), tag="c2", verify=False)
    eng3 = _engine({"checkpoint": {"verify_load": True}}, seed=1)
    with pytest.raises(CheckpointCorrupt, match="checksum mismatch"):
        eng3.load_checkpoint(str(tmp_path), tag="c2")


def test_pre_manifest_checkpoint_still_loads(tmp_path):
    _save_two_tags(tmp_path)
    os.remove(str(tmp_path / "c2" / "manifest.json"))
    eng2 = _engine(seed=1)
    eng2.load_checkpoint(str(tmp_path), tag="c2", verify=True)
    assert eng2.global_steps == 2


# --------------------------------------------------------------------------- #
# the port's own: in-place load, the policed drain, resumed streams
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_load_keeps_every_parameter_object_and_loads_its_value(tmp_path, dtype):
    """The module trains the loaded weights: every ``nn.Parameter`` stays
    the same object, the master equals the saved one, and in bf16 the
    params are the master recast."""
    src = _engine(dtype=dtype)
    for s in range(2):
        src.train_batch(_batch(s))
    src.save_checkpoint(str(tmp_path), tag="t")
    dst = _engine(seed=1, dtype=dtype)
    params = dict(dst.module.named_flat_parameters())
    master_ids = {n: id(t) for n, t in dst.state["master"].items()}
    dst.load_checkpoint(str(tmp_path), tag="t", verify=True)
    after = dst.module.named_flat_parameters()
    assert all(after[n] is p for n, p in params.items())
    assert {n: id(t) for n, t in dst.state["master"].items()} == master_ids
    for n, t in src.state["master"].items():
        assert torch.equal(dst.state["master"][n], t), n
        assert torch.equal(after[n].data, t.to(dtype)), n
    assert dst.eval_loss(_batch(9)) == src.eval_loss(_batch(9))


def test_snapshot_is_one_policed_drain_and_never_aliases():
    eng = _engine()
    eng.train_batch(_batch(0))
    before = state_mod.DRAINS["count"]
    model_flat, optim_flat = snapshot_state_flats(eng.state)
    assert state_mod.DRAINS["count"] == before + 1
    live = {**state_mod.flatten_tree(eng.state["master"]),
            **state_mod.flatten_tree({"opt": eng.state["opt"], "step": eng.state["step"],
                                      "scaler": eng.state["scaler"],
                                      "skipped": eng.state["skipped"]})}
    snap = {**model_flat, **optim_flat}
    assert set(snap) == set(live)
    frozen = {k: v.copy() for k, v in snap.items()}
    for k, v in snap.items():
        assert isinstance(v, np.ndarray) and v.dtype in (np.float32, np.int32), k
        assert not np.shares_memory(v, live[k].detach().numpy()), k
    with torch.no_grad():                   # the engine's next step, in place
        for t in live.values():
            t.add_(1)
    eng.train_batch(_batch(1))
    assert all(snap[k].tobytes() == frozen[k].tobytes() for k in snap)
    with pytest.raises(TypeError, match="bfloat16"):
        state_mod.drain_to_host({"w": torch.zeros(2, dtype=torch.bfloat16)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_resumed_stream_is_byte_equal_to_the_uninterrupted_one(tmp_path, dtype):
    ref = _engine(dtype=dtype)
    uninterrupted = ref.train_steps(6, data_iter=iter([_batch(s) for s in range(6)]))
    a = _engine(dtype=dtype)
    a.train_steps(3, data_iter=iter([_batch(s) for s in range(3)]))
    a.save_checkpoint(str(tmp_path))
    b = _engine(seed=1, dtype=dtype)
    b.load_checkpoint(str(tmp_path), verify=True)
    assert (b.global_steps, b.global_samples, b.micro_steps) == (3, 24, 6)
    resumed = b.train_steps(3, data_iter=iter([_batch(s) for s in range(3, 6)]))
    assert resumed.tobytes() == uninterrupted[3:].tobytes()
    for n, t in ref.state["master"].items():
        assert torch.equal(b.state["master"][n], t), n


# --------------------------------------------------------------------------- #
# rolling checkpoints
# --------------------------------------------------------------------------- #

def test_rolling_cadence_and_latest_ordering(tmp_path):
    eng = _rolling_engine(tmp_path, every=2, keep_last=8)
    for step in range(5):
        eng.train_batch(_batch(step))
    eng._rolling.flush()
    for tag in ("rolling_step2", "rolling_step4"):
        assert tag_problem(str(tmp_path), tag, verify=True) is None
    assert read_latest_tag(str(tmp_path)) == "rolling_step4"
    assert eng._rolling.saves == 2
    eng2 = _engine(seed=1)
    eng2.train_batch(_batch(0))
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.global_steps == 4
    eng.destroy()


def test_rolling_resumed_stream_matches_uninterrupted(tmp_path):
    eng = _rolling_engine(tmp_path / "a", every=3, keep_last=8)
    uninterrupted = [float(eng.train_batch(_batch(s))) for s in range(6)]
    eng.destroy()
    eng2 = _rolling_engine(tmp_path / "b", every=3, keep_last=8)
    eng2.train_batch(_batch(0))
    eng2.load_checkpoint(str(tmp_path / "a"), tag="rolling_step3", verify=True)
    resumed = [float(eng2.train_batch(_batch(s))) for s in range(3, 6)]
    assert resumed == uninterrupted[3:]
    eng2.destroy()


def test_rolling_retention_prunes_but_never_latest(tmp_path):
    eng = _rolling_engine(tmp_path, every=1, keep_last=2)
    for step in range(5):
        eng.train_batch(_batch(step))
    eng._rolling.flush()
    tags = sorted(d for d in os.listdir(str(tmp_path)) if d.startswith("rolling_step"))
    assert tags == ["rolling_step4", "rolling_step5"]
    assert read_latest_tag(str(tmp_path)) == "rolling_step5"
    assert eng.ckpt_stats.pruned == 3
    eng.destroy()


def test_rolling_user_tags_never_pruned(tmp_path):
    eng = _rolling_engine(tmp_path, every=1, keep_last=1)
    eng.train_batch(_batch(0))
    eng.save_checkpoint(str(tmp_path), tag="user_milestone")
    for step in range(1, 4):
        eng.train_batch(_batch(step))
    eng._rolling.flush()
    assert os.path.isdir(str(tmp_path / "user_milestone"))
    assert tag_problem(str(tmp_path), "user_milestone") is None
    eng.destroy()


class _WatchedSemaphore:
    """A semaphore proxy that tells whether an acquire had to block."""

    def __init__(self, inner):
        self.inner = inner
        self.blocked = threading.Event()
        self.immediate = threading.Event()

    def acquire(self, blocking=True, timeout=None):
        if self.inner.acquire(blocking=False):
            self.immediate.set()
            return True
        self.blocked.set()
        return self.inner.acquire(blocking, timeout)

    def release(self, n=1):
        self.inner.release(n)


def test_rolling_backpressure_bounds_writer_lag(tmp_path, monkeypatch):
    """With the committer held on a gate, the next save BLOCKS in
    backpressure (at most ``max_pending`` uncommitted snapshots) and goes
    on once the gate opens; commits stay in tag order."""
    real_commit = rolling_mod.commit_checkpoint
    gate = threading.Event()
    committed = []

    def gated_commit(*a, **k):
        assert gate.wait(30.0)
        committed.append(a[2])
        return real_commit(*a, **k)

    monkeypatch.setattr(rolling_mod, "commit_checkpoint", gated_commit)
    eng = _rolling_engine(tmp_path, every=1, keep_last=8, max_pending=1)
    eng.train_batch(_batch(0))          # save 1 queues; the committer waits
    watched = _WatchedSemaphore(eng._rolling._pending)
    eng._rolling._pending = watched
    t = threading.Thread(target=lambda: eng.train_batch(_batch(1)))
    t.start()
    assert watched.blocked.wait(30.0) and not watched.immediate.is_set()
    assert eng._rolling._jobs.qsize() <= 1
    gate.set()
    t.join(30.0)
    assert not t.is_alive()
    eng._rolling.flush()
    assert committed == ["rolling_step1", "rolling_step2"]   # FIFO tag order
    assert eng.ckpt_stats.backpressure_ms > 0.0
    eng.destroy()


def test_rolling_commit_failure_surfaces_at_next_save(tmp_path, monkeypatch):
    def exploding_commit(*a, **k):
        raise OSError(28, "disk full")

    monkeypatch.setattr(rolling_mod, "commit_checkpoint", exploding_commit)
    eng = _rolling_engine(tmp_path, every=1)
    eng.train_batch(_batch(0))
    eng._rolling._jobs.join()
    with pytest.raises(OSError, match="disk full"):
        eng.train_batch(_batch(1))
    monkeypatch.undo()
    eng.destroy()


def test_destroy_surfaces_commit_error_after_full_teardown(tmp_path, monkeypatch):
    def exploding_commit(*a, **k):
        raise OSError(28, "disk full")

    monkeypatch.setattr(rolling_mod, "commit_checkpoint", exploding_commit)
    eng = _rolling_engine(tmp_path, every=1)
    eng.train_batch(_batch(0))
    eng._rolling._jobs.join()
    rolling = eng._rolling
    with pytest.raises(OSError, match="disk full"):
        eng.destroy()
    assert rolling._committer is None            # committer actually stopped
    assert eng._ckpt_engine._closed              # teardown past the raise ran
    eng.destroy()                                # idempotent, no re-raise


def test_destroy_flushes_inflight_rolling_writes(tmp_path, stall_writes):
    eng = _rolling_engine(tmp_path, every=1)
    eng.train_batch(_batch(0))
    eng.destroy()   # must wait for the stalled writers, then commit
    assert fault_injection.active().hits("ckpt.stall") == 2
    assert tag_problem(str(tmp_path), "rolling_step1", verify=True) is None
    assert read_latest_tag(str(tmp_path)) == "rolling_step1"


def test_async_engine_atexit_flush_is_registered(tmp_path):
    with mock.patch.object(atexit, "register") as reg, \
            mock.patch.object(atexit, "unregister") as unreg:
        eng = AsyncCheckpointEngine()
        reg.assert_called_once_with(eng._atexit_flush)
        eng.save({"a": np.zeros(4, np.float32)}, str(tmp_path / "x.npz"))
        eng.close()
        unreg.assert_called_once_with(eng._atexit_flush)
    assert os.path.exists(str(tmp_path / "x.npz"))
    eng._atexit_flush()


def test_rolling_config_requires_save_dir():
    with pytest.raises(ConfigError, match="save_dir"):
        _rolling_engine("", every=2)


def test_rolling_disabled_by_default(tmp_path):
    eng = _engine()
    eng.train_batch(_batch(0))
    assert eng._rolling is None
    assert os.listdir(str(tmp_path)) == []
    eng.destroy()


def test_ckpt_stats_follow_rolling_saves(tmp_path):
    """The port has no monitor writers yet (the JAX test reads a CSV
    monitor): the engine's ``ckpt_stats`` carry every save and commit, and
    ``events()`` names them ``train/ckpt/*``."""
    eng = _rolling_engine(tmp_path, every=1, keep_last=8)
    for s in range(3):
        eng.train_batch(_batch(s))
    eng._rolling.flush()
    ev = {name: val for name, val, _ in eng.ckpt_stats.events(3)}
    assert ev["train/ckpt/saves"] == 3.0
    assert ev["train/ckpt/snapshot_ms_per_save"] > 0.0
    assert ev["train/ckpt/commit_ms_per_save"] > 0.0
    eng.destroy()


def test_ckpt_stats_counters_and_events():
    st = CheckpointStats()
    st.record_save(snapshot_s=0.002, backpressure_s=0.001, queue_depth=3, write_s=0.006)
    st.record_commit(commit_s=0.004, pruned=2)
    st.record_save(snapshot_s=0.004)
    st.retries = 5
    st.record_load(read_s=0.5, verify_s=0.25, h2d_s=0.125)
    ev = {name: val for name, val, _ in st.events(7)}
    assert ev["train/ckpt/saves"] == 2.0
    assert ev["train/ckpt/snapshot_ms_per_save"] == pytest.approx(3.0)
    assert ev["train/ckpt/write_ms_per_save"] == pytest.approx(3.0)
    assert ev["train/ckpt/commit_ms_per_save"] == pytest.approx(2.0)
    assert ev["train/ckpt/backpressure_ms_per_save"] == pytest.approx(0.5)
    assert ev["train/ckpt/writer_queue_depth"] == pytest.approx(1.5)
    assert ev["train/ckpt/retries"] == 5.0
    assert ev["train/ckpt/pruned_tags"] == 2.0
    assert (st.loads, st.load_read_ms, st.load_verify_ms, st.load_h2d_ms) == \
        (1, 500.0, 250.0, 125.0)
    st.reset()
    assert st.saves == 0 and st.snapshot_ms == 0.0 and st.retries == 0 and st.loads == 0


def test_latest_never_rolls_backwards_past_user_save(tmp_path):
    write_latest_tag(str(tmp_path), "global_step7")
    write_latest_tag(str(tmp_path), "rolling_step6", monotonic=True)
    assert read_latest_tag(str(tmp_path)) == "global_step7"
    write_latest_tag(str(tmp_path), "rolling_step9", monotonic=True)
    assert read_latest_tag(str(tmp_path)) == "rolling_step9"
    write_latest_tag(str(tmp_path), "best_model")
    assert read_latest_tag(str(tmp_path)) == "best_model"

    real_commit = rolling_mod.commit_checkpoint
    gate = threading.Event()

    def gated_commit(*a, **k):
        assert gate.wait(30.0)
        return real_commit(*a, **k)

    with mock.patch.object(rolling_mod, "commit_checkpoint", gated_commit):
        eng = _rolling_engine(tmp_path / "run", every=1, max_pending=2)
        eng.train_batch(_batch(0))            # rolling_step1 queued, held
        eng.train_batch(_batch(1))
        eng.save_checkpoint(str(tmp_path / "run"), tag="global_step2")
        assert read_latest_tag(str(tmp_path / "run")) == "global_step2"
        gate.set()
        eng._rolling.flush()
    assert tag_problem(str(tmp_path / "run"), "rolling_step1") is None
    assert read_latest_tag(str(tmp_path / "run")) in ("global_step2", "rolling_step2")
    eng.destroy()


def test_failed_enqueue_hands_the_backpressure_permit_back(tmp_path):
    eng = _rolling_engine(tmp_path, every=100, max_pending=1)
    eng.train_batch(_batch(0))
    rc = eng._rolling
    rc.flush()
    real_put = rc._jobs.put

    def boom(*a, **k):
        raise RuntimeError("queue closed under save")

    rc._jobs.put = boom
    try:
        with pytest.raises(RuntimeError, match="queue closed under save"):
            rc.save()
    finally:
        rc._jobs.put = real_put
    assert rc._pending.acquire(blocking=False)
    rc._pending.release()
    rc.save()
    rc.flush()
    eng.destroy()
