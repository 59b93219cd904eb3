"""The port's offload tier (CPU): the NVMe swappers, the host optimizer's
group pipeline, the offload engine against the device step and against
the JAX package's offload engine, and checkpoints between the two
packages. The counterparts of ``tests/unit/test_offload.py``.

Tolerances, each with its reason:
- Within the port: bit for bit between the serial step, the pipeline and
  NVMe (the same elementwise host kernels on the same grads), between two
  delayed-update runs, and for a tag resumed in a fresh offload engine.
- Offload against the device step, and tags between offload and plain
  engines: rtol 2e-3 / atol 2e-3, the JAX package's tolerance (the host
  kernel's f32 chain and the device's foreach chain round differently).
- The port's offload engine against the JAX package's on the same weights
  and batches: losses at rtol 1e-4, the fp32 tier of
  ``tests/test_torch_train.py`` (per-step f32 differences of ~1e-7
  compound through AdamW); final masters at 1e-4 of each leaf's L2 norm
  (Adam scales a near-zero grad element into a full step either way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.comm.mesh import build_topology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.runtime.zero.offload import partition_leaves as jax_partition_leaves
from deepspeed_tpu_torch.checkpoint import state as ck_state
from deepspeed_tpu_torch.config import ConfigError, DeepSpeedTPUConfig, OffloadDeviceEnum
from deepspeed_tpu_torch.config import OffloadOptimizerConfig
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.monitor import OffloadPipelineStats
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.runtime.swap_tensor import (OptimizerStateSwapper,
                                                     PipelinedOptimizerSwapper, SwapBufferPool)
from deepspeed_tpu_torch.runtime.zero import offload as off_mod
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer, partition_leaves

from tests._torch_threads import one_torch_thread  # noqa: F401

GPT = dict(vocab_size=64, n_positions=16, n_embd=32, n_layer=2, n_head=2)


def _host_offload(leaves, **cfg_kw):
    """A HostOffloadOptimizer over fp32 leaves (cpu unless device= says)."""
    cfg_kw.setdefault("device", OffloadDeviceEnum.cpu)
    return HostOffloadOptimizer(FusedAdam(lr=1e-2, weight_decay=0.01),
                                {k: np.asarray(v, np.float32) for k, v in leaves.items()},
                                OffloadOptimizerConfig(**cfg_kw))


# --------------------------------------------------------------------------- #
# swapper units
# --------------------------------------------------------------------------- #

def test_buffer_pool_reuse():
    pool = SwapBufferPool(max_buffers=4)
    b1 = pool.get(1000)
    assert b1.nbytes >= 1000 and b1.nbytes % 4096 == 0
    pool.put(b1)
    b2 = pool.get(1000)
    assert b2 is b1
    v = pool.view(b2, (10, 25), torch.float32)
    assert tuple(v.shape) == (10, 25) and v.dtype == torch.float32


def test_optimizer_swapper_roundtrip(tmp_path):
    sw = OptimizerStateSwapper(str(tmp_path / "swap"))
    a = np.random.rand(257).astype(np.float32)
    b = np.random.rand(8, 33).astype(np.float32)
    sw.register("exp_avg/a", a)
    sw.register("exp_avg/b", b)
    views = sw.swap_in(["exp_avg/a", "exp_avg/b"])
    np.testing.assert_array_equal(views["exp_avg/a"], a)
    views["exp_avg/a"] += 1.0
    sw.swap_out()
    got = sw.swap_in(["exp_avg/a"])
    np.testing.assert_array_equal(got["exp_avg/a"], a + 1.0)
    sw.swap_out()
    np.testing.assert_array_equal(sw.read_all()["exp_avg/b"], b)
    assert sw.pool.outstanding == 0
    sw.close()


@pytest.mark.parametrize("pipeline", [False, True])
def test_pipelined_swapper_groups(tmp_path, pipeline):
    sw = PipelinedOptimizerSwapper(str(tmp_path / "swap"),
                                   pipeline_read=pipeline, pipeline_write=pipeline)
    arrays = {f"t{i}": np.full(100 + i, float(i), np.float32) for i in range(6)}
    for k, v in arrays.items():
        sw.register(k, v)
    groups = [["t0", "t1"], ["t2", "t3"], ["t4", "t5"]]
    seen = []

    def step(views):
        for name, v in views.items():
            v += 10.0
            seen.append(name)

    sw.run(groups, step)
    assert seen == [n for g in groups for n in g]
    final = sw.read_all()
    for i in range(6):
        np.testing.assert_array_equal(final[f"t{i}"], arrays[f"t{i}"] + 10.0)
    sw.close()


def _registered_pipelined(tmp_path, n=6, **kw):
    kw.setdefault("pipeline_read", True)
    kw.setdefault("pipeline_write", True)
    sw = PipelinedOptimizerSwapper(str(tmp_path / "swap"), **kw)
    for i in range(n):
        sw.register(f"t{i}", np.full(100 + i, float(i), np.float32))
    return sw, [[f"t{2 * i}", f"t{2 * i + 1}"] for i in range(n // 2)]


def test_swap_in_submit_failure_releases_buffers(tmp_path):
    sw = OptimizerStateSwapper(str(tmp_path / "swap"))
    sw.register("a", np.zeros(64, np.float32))
    sw.register("b", np.zeros(64, np.float32))
    calls = {"n": 0}

    def failing_pread(view, path):
        calls["n"] += 1
        return 0 if calls["n"] == 1 else -5

    sw.handle.async_pread = failing_pread
    with pytest.raises(OSError):
        sw.swap_in(["a", "b"])
    assert sw.pool.outstanding == 0 and not sw._views
    sw.close()


def test_swap_in_wait_failure_releases_buffers(tmp_path):
    sw = OptimizerStateSwapper(str(tmp_path / "swap"))
    sw.register("a", np.zeros(64, np.float32))
    sw.handle.wait = lambda: -9
    with pytest.raises(OSError):
        sw.swap_in(["a"])
    assert sw.pool.outstanding == 0
    sw.close()


def test_pipelined_run_read_failure_surfaces(tmp_path):
    sw, groups = _registered_pipelined(tmp_path)
    sw._read_handle.async_pread = lambda view, path: -5
    with pytest.raises(OSError):
        sw.run(groups, lambda views: None)
    assert sw.pool.outstanding == 0 and not sw._views
    sw.close()


def test_pipelined_run_write_failure_surfaces(tmp_path):
    sw, groups = _registered_pipelined(tmp_path)
    sw._write_handle.async_pwrite = lambda view, path: -7
    stepped = []
    with pytest.raises(OSError):
        sw.run(groups, lambda views: stepped.append(sorted(views)))
    assert stepped
    assert sw.pool.outstanding == 0 and not sw._views
    sw.close()


def test_pipelined_run_stepfn_abort_returns_buffers(tmp_path):
    sw, groups = _registered_pipelined(tmp_path)
    count = {"n": 0}

    def step(views):
        count["n"] += 1
        if count["n"] == 2:
            raise RuntimeError("boom mid-pipeline")
        for v in views.values():
            v += 1.0

    with pytest.raises(RuntimeError, match="boom"):
        sw.run(groups, step)
    assert sw.pool.outstanding == 0 and not sw._views
    seen = []
    sw.run(groups, lambda views: seen.extend(sorted(views)))
    assert seen == [n for g in groups for n in g]
    assert sw.pool.outstanding == 0
    sw.close()


# --------------------------------------------------------------------------- #
# the host step: grouping, chunked kernel, byte equality
# --------------------------------------------------------------------------- #

def test_leaf_groups_sizing_and_nvme_expansion():
    leaves = {f"l{i}": np.zeros(37 + i, np.float32) for i in range(5)}
    off = _host_offload(leaves, group_size=2)
    assert [len(g) for g in off.leaf_groups()] == [2, 2, 1]
    assert [n for g in off.leaf_groups() for n in g] == list(leaves)
    swap_groups = off._nvme_groups()
    assert [len(g) for g in swap_groups] == [6, 6, 3]
    assert swap_groups[0][:3] == ["master/l0", "exp_avg/l0", "exp_avg_sq/l0"]
    off.close()
    off2 = _host_offload(leaves, buffer_count=3)
    assert [len(g) for g in off2.leaf_groups()] == [3, 2]
    off2.close()


def test_step_groups_matches_serial_step_bytes(monkeypatch):
    """The pipelined walk (worker pool, each worker's OpenMP team, forced
    leaf chunking) is bit-identical to the serial ``step``."""
    rng = np.random.default_rng(1)
    leaves = {f"l{i}": rng.standard_normal(137 + 31 * i).astype(np.float32) for i in range(5)}
    a = _host_offload(leaves)
    b = _host_offload(leaves, host_workers=3, group_size=2)
    monkeypatch.setattr(off_mod, "_CHUNK_ELEMS", 32)
    phases = []
    for _ in range(3):
        g = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
             for k, v in leaves.items()}
        a.step({k: v.copy() for k, v in g.items()}, lr=1e-2)
        done = {}
        b.step_groups(lambda gi: {k: g[k].copy() for k in b.leaf_groups()[gi]}, lr=1e-2,
                      on_group_done=lambda gi, m: done.update(m),
                      record=lambda phase, s: phases.append(phase))
        assert set(done) == set(leaves)
    assert a.step_num == b.step_num == 3
    for k in leaves:
        assert a.master[k].tobytes() == b.master[k].tobytes()
        for sk in ("exp_avg", "exp_avg_sq"):
            assert a.moments[sk][k].tobytes() == b.moments[sk][k].tobytes()
    assert "fetch" in phases and "kernel" in phases
    assert off_mod.omp_team(3) == max(1, (__import__("os").cpu_count() or 1) // 3)
    a.close()
    b.close()
    assert b._kernel_pool is None


def test_delayed_update_config_alias():
    c = DeepSpeedTPUConfig.load({"zero_optimization": {"offload_optimizer": {
        "device": "cpu", "delayed_update": True}}})
    assert c.zero_optimization.offload_optimizer.delayed_param_update


def test_twin_flow_partition_matches_jax():
    rng = np.random.default_rng(2)
    leaves = {f"w{i}": np.zeros(int(n)) for i, n in enumerate(rng.integers(1, 5000, 17))}
    for ratio in (0.0, 0.2, 0.5, 0.9, 1.0):
        assert partition_leaves(leaves, ratio) == jax_partition_leaves(leaves, ratio)
    host, dev = partition_leaves({"a": np.zeros(100), "b": np.zeros(1000),
                                  "c": np.zeros(10)}, 0.2)
    assert "c" in host and "b" in dev


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #

def _batches(steps=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, GPT["vocab_size"], (8, GPT["n_positions"]))
             .astype(np.int32)} for _ in range(steps)]


def _config(offload=None, stage=1, bf16=False):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
           "steps_per_print": 0, "zero_optimization": {"stage": stage},
           "bf16": {"enabled": bf16},
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.01}}}
    if offload:
        cfg["zero_optimization"]["offload_optimizer"] = offload
    return cfg


def _port(cfg, params=None, bf16=False, seed=0):
    model = GPT2LMHead(GPT2Config(dtype=torch.bfloat16 if bf16 else torch.float32, **GPT),
                       device="cpu", seed=seed)
    return deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=cfg,
                                          device="cpu")[0]


def _run(cfg, batches, params=None, bf16=False, engine=None):
    engine = engine or _port(cfg, params, bf16)
    return engine, [float(engine.train_batch(b)) for b in batches]


def _host_master(engine):
    return engine._offload.state_leaves()[0]


def test_cpu_offload_matches_device_step():
    batches = _batches()
    _, base = _run(_config(), batches)
    eng, off = _run(_config({"device": "cpu"}), batches)
    assert eng._offload is not None and not eng._offload.nvme
    assert eng._offload.kernel.backend == "openmp"
    np.testing.assert_allclose(off, base, rtol=2e-3, atol=2e-3)
    assert off[-1] < off[0]
    eng.destroy()


def test_nvme_offload_trains_and_swaps(tmp_path):
    batches = _batches()
    _, base = _run(_config(), batches)
    eng, off = _run(_config({"device": "nvme", "nvme_path": str(tmp_path), "buffer_count": 3,
                             "pipeline_read": True, "pipeline_write": True}), batches)
    assert eng._offload.nvme and eng._offload.swapper.element_count() > 0
    np.testing.assert_allclose(off, base, rtol=2e-3, atol=2e-3)
    assert eng.offload_stats.swap_ms > 0.0
    eng.destroy()


def test_delayed_param_update_trains_and_drains():
    batches = _batches(steps=8)
    _, sync = _run(_config({"device": "cpu"}), batches)
    eng, dpu = _run(_config({"device": "cpu", "delayed_param_update": True}), batches)
    assert eng._offload_pending is not None
    assert dpu[-1] < dpu[0]
    np.testing.assert_allclose(dpu[-1], sync[-1], rtol=0.05)
    model_flat, _ = eng.checkpoint_flats()
    assert eng._offload_pending is None
    for k, v in _host_master(eng).items():
        assert model_flat[k].tobytes() == v.tobytes()
        # the drained params are the host master in the compute dtype
        assert eng.state["params"][k].detach().numpy().tobytes() == v.tobytes()
    eng2, dpu2 = _run(_config({"device": "cpu", "delayed_param_update": True}), batches)
    assert dpu2 == dpu
    eng.destroy()
    eng2.destroy()
    assert eng._offload_executor is None


def test_twin_flow_ratio_splits_leaves():
    batches = _batches()
    _, base = _run(_config(), batches)
    eng, off = _run(_config({"device": "cpu", "ratio": 0.5}), batches)
    assert eng._offload_dev_names and eng._offload_host_names
    assert set(eng.state["master"]) == set(eng._offload_dev_names)
    np.testing.assert_allclose(off, base, rtol=2e-3, atol=2e-3)
    eng.destroy()


def test_offload_checkpoint_interchange(tmp_path):
    """Offload tags load into a plain engine and back (the same flat
    keys); an offload tag resumed in a fresh offload engine continues bit
    for bit."""
    batches = _batches()
    eng_off, _ = _run(_config({"device": "cpu"}), batches[:3])
    eng_off.save_checkpoint(str(tmp_path / "ck"), tag="t1")
    eng_plain, _ = _run(_config(), batches[:1])
    eng_plain.load_checkpoint(str(tmp_path / "ck"), tag="t1")
    fresh = _port(_config({"device": "cpu"}), seed=5)
    fresh.load_checkpoint(str(tmp_path / "ck"), tag="t1")
    l_off = [float(eng_off.train_batch(b)) for b in batches[3:]]
    l_plain = [float(eng_plain.train_batch(b)) for b in batches[3:]]
    l_fresh = [float(fresh.train_batch(b)) for b in batches[3:]]
    np.testing.assert_allclose(l_off, l_plain, rtol=2e-3, atol=2e-3)
    assert l_fresh == l_off
    eng_plain.save_checkpoint(str(tmp_path / "ck2"), tag="t2")
    eng_off2, _ = _run(_config({"device": "cpu"}), batches[:1])
    eng_off2.load_checkpoint(str(tmp_path / "ck2"), tag="t2")
    assert eng_off2.global_steps == eng_plain.global_steps
    l3 = [float(eng_off2.train_batch(b)) for b in batches[3:]]
    l4 = [float(eng_plain.train_batch(b)) for b in batches[3:]]
    np.testing.assert_allclose(l3, l4, rtol=2e-3, atol=2e-3)
    for e in (eng_off, eng_plain, fresh, eng_off2):
        e.destroy()


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_overlap_step_matches_serial_engine_bytes(tmp_path, bf16):
    """The same device step under each orchestration: loss streams and
    final masters byte-identical between the serial step, the cpu pipeline
    (with a worker pool) and the nvme pipeline."""
    batches = _batches()
    runs = [_run(_config(off, bf16=bf16), batches, bf16=bf16) for off in (
        {"device": "cpu", "overlap_step": False, "buffer_count": 3},
        {"device": "cpu", "buffer_count": 3, "host_workers": 4},
        {"device": "nvme", "nvme_path": str(tmp_path), "buffer_count": 3,
         "pipeline_read": True, "pipeline_write": True})]
    (e_s, l_s), (e_p, l_p), (e_n, l_n) = runs
    assert l_s == l_p == l_n
    m_s, m_p, m_n = (_host_master(e) for e, _ in runs)
    for k in m_s:
        assert m_s[k].tobytes() == m_p[k].tobytes() == m_n[k].tobytes(), k
    for e, _ in runs:
        e.destroy()


def test_offload_engine_groups_align_with_optimizer():
    eng, _ = _run(_config({"device": "cpu", "group_size": 4}), _batches(steps=1))
    assert eng._offload_groups == eng._offload.leaf_groups()
    assert len(eng._offload_group_meta) == len(eng._offload_groups)
    for names, meta in zip(eng._offload_groups, eng._offload_group_meta):
        assert [m[0] for m in meta] == names
        off = 0
        for _, o, n, shape in meta:
            assert o == off and n == int(np.prod(shape))
            off += n
    eng.destroy()


def test_offload_ckpt_state_batches_drains():
    """The checkpoint view of an offload engine reads the device once (one
    policed drain), whatever the number of device-flow leaves."""
    eng, _ = _run(_config({"device": "cpu", "ratio": 0.5}), _batches(steps=2))
    assert len(eng._offload_dev_names) > 2
    before = ck_state.DRAINS["count"]
    model_flat, optim_flat = eng.checkpoint_flats()
    assert ck_state.DRAINS["count"] - before == 1
    assert set(model_flat) == set(eng._offload_dev_names) | set(eng._offload_host_names)
    assert {f"opt/exp_avg/{k}" for k in model_flat} <= set(optim_flat)
    eng.destroy()


def test_offload_pipeline_stats_recorded():
    batches = _batches(steps=3)
    eng, _ = _run(_config({"device": "cpu", "buffer_count": 3}), batches)
    st = eng.offload_stats
    assert isinstance(st, OffloadPipelineStats)
    assert st.steps == len(batches)
    assert st.groups == st.steps * len(eng._offload_groups)
    assert st.kernel_ms > 0.0
    names = [e[0] for e in st.events(0)]
    assert "train/offload/kernel_ms_per_group" in names
    assert "train/offload/swap_ms_per_step" in names
    st.reset()
    assert st.steps == 0 and st.kernel_ms == 0.0
    eng.destroy()


def test_offload_worker_pools_torn_down_on_destroy():
    eng, _ = _run(_config({"device": "cpu", "host_workers": 2}), _batches(steps=2))
    off = eng._offload
    eng.destroy()
    assert eng._offload_upload_pool is None and off._kernel_pool is None
    eng.destroy()   # idempotent


@pytest.mark.parametrize("opt", ["Lamb", "SGD"])
def test_offload_rejects_unsupported_optimizer(opt):
    cfg = _config({"device": "cpu"})
    cfg["optimizer"] = {"type": opt, "params": {"lr": 1e-2}}
    with pytest.raises(ValueError, match="offload_optimizer does not support"):
        _port(cfg)


def test_offload_config_checks(monkeypatch):
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    with pytest.raises(ConfigError, match="zero_quantized_weights"):
        _port({**_config(), "zero_optimization": {
            "stage": 1, "zero_quantized_weights": True,
            "offload_optimizer": {"device": "cpu"}}})
    warned = []
    monkeypatch.setattr(engine_mod.logger, "warning", lambda msg, *a: warned.append(msg))
    eng = _port(_config({"device": "cpu"}, stage=0))
    assert any("zero stage 0" in m for m in warned)
    eng.destroy()
    with pytest.raises(NotImplementedError, match="offload_param"):
        DeepSpeedTPUConfig.load({"zero_optimization": {"stage": 3, "offload_param": {
            "device": "cpu"}}})


def test_facade_runs_the_offload_step():
    """forward/backward/step a micro-batch at a time gives the bits of
    train_batch, the host step included."""
    batches = _batches(steps=2)
    a, la = _run(_config({"device": "cpu"}), batches)
    b = _port(_config({"device": "cpu"}))
    for batch in batches:
        for i in range(0, 8, 4):
            loss = b({"input_ids": batch["input_ids"][i:i + 4]})
            b.backward(loss)
            b.step()
    for k, v in _host_master(a).items():
        assert _host_master(b)[k].tobytes() == v.tobytes()
    a.destroy()
    b.destroy()


def test_upload_cast_matches_the_jax_engines_astype():
    """bf16: a host master cast for the upload rounds to nearest even and
    turns a NaN into ml_dtypes' sign | 0x7FC0 (the JAX engine's astype)."""
    import ml_dtypes
    eng = _port(_config({"device": "cpu", "group_size": 100}, bf16=True), bf16=True)
    meta = eng._offload_group_meta[0]
    rng = np.random.default_rng(9)
    special = np.array([0x7FC00001, 0xFFC00001, 0x7F800001, 0xFF812345, 0x3F808000,
                        0x3F818000, 0x7F7FFFFF, 0xFF800000], np.uint32).view(np.float32)
    masters = {}
    for k, _, n, shape in meta:
        v = rng.standard_normal(n).astype(np.float32)
        v[:min(n, special.size)] = special[:min(n, special.size)]
        masters[k] = v.reshape(shape)
    flat = eng._offload_stage(0, masters, canon_nan=True)
    with np.errstate(invalid="ignore"):   # numpy warns on casting a NaN
        want = np.concatenate([masters[k].reshape(-1) for k, _, _, _ in meta]) \
            .astype(ml_dtypes.bfloat16).view(np.uint16)
    assert flat.view(torch.int16).numpy().view(np.uint16).tobytes() == want.tobytes()
    eng.destroy()


def test_universal_load_into_an_offload_engine(tmp_path):
    from deepspeed_tpu_torch.checkpoint import ds_to_universal
    batches = _batches()
    a, _ = _run(_config(), batches[:3])
    a.save_checkpoint(str(tmp_path / "ck"), tag="t")
    ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "uni"), tag="t")
    cfg = _config({"device": "cpu", "ratio": 0.5})
    cfg["checkpoint"] = {"load_universal": True}
    b = _port(cfg, seed=3)
    b.load_checkpoint(str(tmp_path / "uni"))
    assert b.global_steps == 3
    np.testing.assert_allclose([float(b.train_batch(x)) for x in batches[3:]],
                               [float(a.train_batch(x)) for x in batches[3:]],
                               rtol=2e-3, atol=2e-3)
    a.destroy()
    b.destroy()


# --------------------------------------------------------------------------- #
# against the JAX package's offload engine, and tags between the packages
# --------------------------------------------------------------------------- #

def _jax_engine(cfg, params):
    model = JaxGPT2(JaxGPT2Config(dtype=jnp.float32, **GPT))
    return deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=cfg,
        mesh_topology=build_topology(MeshConfig(data=1), devices=jax.devices()[:1]))[0]


def _jax_params():
    model = JaxGPT2(JaxGPT2Config(dtype=jnp.float32, **GPT))
    return jax.jit(model.init)(jax.random.PRNGKey(0), {"input_ids": jnp.zeros(
        (1, GPT["n_positions"]), jnp.int32)})["params"]


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


@pytest.mark.parametrize("offload", [{"device": "cpu"}, {"device": "cpu", "ratio": 0.5}],
                         ids=["host", "twin"])
def test_offload_engine_matches_the_jax_offload_engine(offload):
    params = _jax_params()
    cfg = _config(offload)
    batches = _batches(steps=5)
    jeng = _jax_engine(cfg, params)
    peng = _port(cfg, params=_flat_np(params))
    lj = [float(jeng.train_batch(b)) for b in batches]
    lp = [float(peng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(lp, lj, rtol=1e-4)
    jm, _ = jeng._offload.state_leaves()
    pm = _host_master(peng)
    assert set(jm) == set(pm)
    for k in pm:
        a, b = pm[k], jm[k]
        if k.endswith("c_attn/bias"):
            # the key bias's gradient is zero up to rounding (softmax ignores
            # a constant shift of a row's scores), and Adam scales that noise
            # into steps of +-lr in either package: compare q and v only
            n = a.size // 3
            a, b = np.delete(a, np.s_[n:2 * n]), np.delete(b, np.s_[n:2 * n])
        # per leaf in L2: Adam turns a grad element near zero into a full
        # +-lr step either way, so single elements part where a leaf agrees
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), k
    jeng.destroy()
    peng.destroy()


def test_port_offload_tag_loads_into_jax_engines(tmp_path):
    params = _jax_params()
    batches = _batches()
    peng = _port(_config({"device": "cpu"}), params=_flat_np(params))
    for b in batches[:3]:
        peng.train_batch(b)
    peng.save_checkpoint(str(tmp_path / "ck"), tag="t")
    cont = [float(peng.train_batch(b)) for b in batches[3:]]
    for cfg in (_config(), _config({"device": "cpu"})):
        jeng = _jax_engine(cfg, params)
        jeng.load_checkpoint(str(tmp_path / "ck"), tag="t")
        assert jeng.global_steps == 3
        np.testing.assert_allclose([float(jeng.train_batch(b)) for b in batches[3:]], cont,
                                   rtol=2e-3, atol=2e-3)
        jeng.destroy()
    peng.destroy()


def test_jax_offload_tag_loads_into_the_port(tmp_path):
    params = _jax_params()
    batches = _batches()
    jeng = _jax_engine(_config({"device": "cpu"}), params)
    for b in batches[:3]:
        jeng.train_batch(b)
    jeng.save_checkpoint(str(tmp_path / "ck"), tag="t")
    cont = [float(jeng.train_batch(b)) for b in batches[3:]]
    for cfg in (_config({"device": "cpu"}), _config()):
        peng = _port(cfg, seed=4)
        peng.load_checkpoint(str(tmp_path / "ck"), tag="t")
        assert peng.global_steps == 3
        np.testing.assert_allclose([float(peng.train_batch(b)) for b in batches[3:]], cont,
                                   rtol=2e-3, atol=2e-3)
        peng.destroy()
    jeng.destroy()
