"""Checkpoints move both ways between the JAX engine and the port (CPU).

One tiny GPT-2 config (gas 2, clipping 1.0, AdamW with decay, WarmupLR),
the same numpy weights (shapes from ``jax.eval_shape``) and batches on both
sides. Each package trains 3 steps, saves and trains 3 more; a fresh engine
of the OTHER package loads the tag with ``verify=True`` and trains the last
3 batches.

Tolerances, each with its reason (the tiers of
``test_torch_train.py::test_engine_loss_stream_matches_jax_engine``):
- fp32 losses rtol 1e-4: the same products summed in other orders by XLA
  and torch, compounding through AdamW;
- bf16 losses rtol 2e-2: bf16 has 8 bits of mantissa and the two
  frameworks round at different places.
Everything read from a file is held byte for byte: the loaded masters, the
counters, the file formats, universal trees, sharded reassembly and the
``zero_to_fp32`` outputs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import sharded as jax_sharded
from deepspeed_tpu.checkpoint import state as jax_state
from deepspeed_tpu.checkpoint import universal as jax_universal
from deepspeed_tpu.comm.mesh import build_topology
from deepspeed_tpu.config import MeshConfig
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.utils import zero_to_fp32 as jax_zero_to_fp32
from deepspeed_tpu_torch.checkpoint import sharded, state, universal
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.utils import zero_to_fp32

from tests._torch_threads import one_torch_thread  # noqa: F401

T = 32
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
FILES = (state.MODEL_FILE, state.OPTIM_FILE)


def _config(bf16=False, fp16=None):
    cfg = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
           "gradient_clipping": 1.0, "bf16": {"enabled": bf16}, "steps_per_print": 0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "betas": [0.9, 0.95],
                                                     "eps": 1e-8, "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_min_lr": 0, "warmup_max_lr": 1e-3, "warmup_num_steps": 5}}}
    if fp16 is not None:
        cfg["fp16"] = fp16
    return cfg


def _batches(n, seed=0, rows=8):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (rows, T)).astype(np.int32)} for _ in range(n)]


def _shapes(jdt):
    model = JaxGPT2(JaxGPT2Config.tiny(dtype=jdt))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                 {"input_ids": jnp.zeros((1, T), jnp.int32)})["params"]


def _numpy_params(shapes):
    """GPT-2's init in numpy: N(0, 0.02) kernels and embeddings, unit
    scales, zero biases."""
    rng = np.random.default_rng(0)
    flat = {}
    for k, s in jax_state.flatten_tree(shapes).items():
        if k.endswith("scale"):
            flat[k] = np.ones(s.shape, np.float32)
        elif k.endswith("bias"):
            flat[k] = np.zeros(s.shape, np.float32)
        else:
            flat[k] = (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
    return flat


def _jax_engine(name, cfg=None):
    jdt = DTYPES[name][0]
    model, shapes = _shapes(jdt)
    params = jax_state.unflatten_into(shapes, _numpy_params(shapes))
    engine, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=cfg or _config(name == "bf16"),
        mesh_topology=build_topology(MeshConfig(data=1), devices=jax.devices()[:1]))
    return engine


def _port_engine(name, cfg=None, seed=1):
    jdt, tdt, _ = DTYPES[name]
    model = GPT2LMHead(GPT2Config.tiny(dtype=tdt), device="cpu", seed=seed)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=_numpy_params(_shapes(jdt)[1]),
        config=cfg or _config(name == "bf16"), device="cpu")
    return engine


def _losses(engine, batches):
    return np.array([float(engine.train_batch(b)) for b in batches])


def _read(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _counters(engine):
    return engine.global_steps, engine.global_samples, engine.micro_steps


@pytest.fixture(scope="module", params=sorted(DTYPES))
def runs(request, tmp_path_factory):
    """Each package trains 3 steps, saves ``global_step3`` and trains 3
    more, in ``<root>/jax`` and ``<root>/port``."""
    name = request.param
    root = tmp_path_factory.mktemp(f"ckpt_{name}")
    batches = _batches(6)
    out = {"name": name, "root": root, "batches": batches}
    for side, build in (("jax", _jax_engine), ("port", _port_engine)):
        engine = build(name)
        first = _losses(engine, batches[:3])
        engine.save_checkpoint(str(root / side))
        out[side] = {"losses": np.concatenate([first, _losses(engine, batches[3:])]),
                     "counters": (3, 24, 6)}
        if side == "port":
            engine.destroy()
    return out


# --------------------------------------------------------------------------- #
# resume across the packages
# --------------------------------------------------------------------------- #

def test_jax_checkpoint_resumes_in_the_port(runs):
    name, root = runs["name"], runs["root"]
    eng = _port_engine(name, seed=2)
    eng.load_checkpoint(str(root / "jax"), tag="global_step3", verify=True)
    assert _counters(eng) == runs["jax"]["counters"]
    saved = _read(str(root / "jax" / "global_step3" / state.MODEL_FILE))
    assert set(saved) == set(eng.state["master"])
    for k, a in saved.items():
        assert eng.state["master"][k].detach().numpy().tobytes() == a.tobytes(), k
    optim = _read(str(root / "jax" / "global_step3" / state.OPTIM_FILE))
    assert int(eng.state["step"]) == int(optim["step"]) == 3
    np.testing.assert_allclose(_losses(eng, runs["batches"][3:]), runs["jax"]["losses"][3:],
                               rtol=DTYPES[name][2])


def test_port_checkpoint_resumes_in_the_jax_engine(runs):
    name, root = runs["name"], runs["root"]
    eng = _jax_engine(name)
    eng.load_checkpoint(str(root / "port"), tag="global_step3", verify=True)
    assert _counters(eng) == runs["port"]["counters"]
    saved = _read(str(root / "port" / "global_step3" / state.MODEL_FILE))
    live = {k: np.asarray(v) for k, v in jax_state.flatten_tree(eng.state["master"]).items()}
    assert set(saved) == set(live)
    for k, a in saved.items():
        assert live[k].tobytes() == a.tobytes(), k
    assert int(eng.state["step"]) == 3
    np.testing.assert_allclose(_losses(eng, runs["batches"][3:]), runs["port"]["losses"][3:],
                               rtol=DTYPES[name][2])


def test_both_packages_write_the_same_files(runs):
    """Equal file names and npz key, dtype and shape sets; each package's
    ``tag_problem`` (verified) and ``read_manifest`` accept the other's
    tag."""
    root = runs["root"]
    tags = {side: str(root / side / "global_step3") for side in ("jax", "port")}
    assert sorted(os.listdir(tags["jax"])) == sorted(os.listdir(tags["port"]))
    for fname in FILES:
        a, b = (_read(os.path.join(tags[s], fname)) for s in ("jax", "port"))
        assert {k: (v.dtype, v.shape) for k, v in a.items()} == \
            {k: (v.dtype, v.shape) for k, v in b.items()}
    for side in ("jax", "port"):
        for mod in (jax_state, state):
            assert mod.tag_problem(str(root / side), "global_step3", verify=True) is None
            man = mod.read_manifest(tags[side])
            assert man["tag"] == "global_step3" and set(man["files"]) == set(FILES)
        assert state.read_latest_tag(str(root / side)) == \
            jax_state.read_latest_tag(str(root / side)) == "global_step3"


def _tree(root):
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            files[os.path.relpath(os.path.join(d, n), root)] = open(os.path.join(d, n), "rb").read()
    return files


def test_universal_trees_are_identical(runs):
    root = runs["root"]
    for side in ("jax", "port"):
        jax_universal.ds_to_universal(str(root / side), str(root / f"uni_{side}_by_jax"))
        universal.ds_to_universal(str(root / side), str(root / f"uni_{side}_by_port"))
        a, b = _tree(root / f"uni_{side}_by_jax"), _tree(root / f"uni_{side}_by_port")
        assert sorted(a) == sorted(b)
        assert all(a[k] == b[k] for k in a), [k for k in a if a[k] != b[k]][:4]


def test_zero_to_fp32_outputs_are_equal(runs):
    root = runs["root"]
    for side in ("jax", "port"):
        out_j = jax_zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict(
            str(root / side), str(root / f"{side}_by_jax.pt"))
        out_p = zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict(
            str(root / side), str(root / f"{side}_by_port.pt"))
        a, b = torch.load(out_j), torch.load(out_p)
        assert sorted(a) == sorted(b) and all("/" not in k for k in b)
        assert all(torch.equal(a[k], b[k]) for k in a)


# --------------------------------------------------------------------------- #
# universal state into the port, sharded both ways
# --------------------------------------------------------------------------- #

FP16 = {"enabled": True, "initial_scale_power": 17, "hysteresis": 1, "loss_scale_window": 2}


def test_port_loads_a_jax_universal_directory_with_an_overflowed_scaler(tmp_path):
    """fp16 with a dynamic scale that overflows once (as in
    ``test_torch_train.py``): the port restores the counters, ``step``,
    ``skipped``, the scaler's three leaves and so the lr."""
    cfg = dict(_config(), train_batch_size=4, train_micro_batch_size_per_gpu=2, fp16=FP16)
    model = JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float16))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            {"input_ids": jnp.zeros((1, T), jnp.int32)})["params"]
    flat = _numpy_params(shapes)
    jeng, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=jax_state.unflatten_into(shapes, flat), config=cfg,
        mesh_topology=build_topology(MeshConfig(data=1), devices=jax.devices()[:1]))
    for b in _batches(7, seed=3, rows=4):
        jeng.train_batch(b)
    assert int(jeng.state["skipped"]) >= 1            # the scaler overflowed
    jeng.save_checkpoint(str(tmp_path / "ck"), tag="t")
    jax_universal.ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "uni"), tag="t")
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(GPT2Config.tiny(dtype=torch.float16), device="cpu", seed=1),
        model_parameters=flat, config=dict(cfg, checkpoint={"load_universal": True}),
        device="cpu")
    peng.load_checkpoint(str(tmp_path / "uni"))
    assert _counters(peng) == (jeng.global_steps, jeng.global_samples, jeng.micro_steps)
    for k in ("step", "skipped"):
        assert int(peng.state[k]) == int(jeng.state[k]), k
    for k in ("scale", "growth_tracker", "hysteresis"):
        assert float(peng.state["scaler"][k]) == float(jeng.state["scaler"][k]), k
    assert peng.get_lr()[0] == pytest.approx(float(jeng.get_lr()[0]), rel=1e-6)
    master = jax_state.flatten_tree(jeng.state["master"])
    for k, t in peng.state["master"].items():
        assert t.detach().numpy().tobytes() == np.asarray(master[k]).tobytes(), k


def _sharded_values():
    return {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "b": np.arange(8, dtype=np.float32), "n": np.arange(6, dtype=np.int32)}


def test_jax_mesh_sharded_checkpoint_reassembles_in_the_port(eight_devices, tmp_path):
    mesh = Mesh(np.array(eight_devices).reshape(4, 2), ("fsdp", "tensor"))
    vals = _sharded_values()
    sh = {"w": NamedSharding(mesh, P("fsdp", "tensor")), "b": NamedSharding(mesh, P("fsdp")),
          "n": NamedSharding(mesh, P())}
    tree = {k: jax.device_put(v, sh[k]) for k, v in vals.items()}
    jax_sharded.save_sharded(str(tmp_path / "sc"), {"model": tree})
    out = sharded.load_sharded(str(tmp_path / "sc"),
                               {"model": {k: torch.empty(v.shape) for k, v in vals.items()}},
                               "cpu")
    for k, v in vals.items():
        got = out["model"][k].numpy()
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k


def test_port_sharded_checkpoint_reassembles_on_a_jax_mesh(eight_devices, tmp_path):
    vals = _sharded_values()
    sharded.save_sharded(str(tmp_path / "sc"),
                         {"model": {k: torch.from_numpy(v) for k, v in vals.items()}})
    mesh = Mesh(np.array(eight_devices).reshape(4, 2), ("fsdp", "tensor"))
    out = jax_sharded.load_sharded(
        str(tmp_path / "sc"),
        {"model": {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in vals.items()}},
        {"model": {"w": NamedSharding(mesh, P("fsdp", "tensor")),
                   "b": NamedSharding(mesh, P("fsdp")), "n": NamedSharding(mesh, P())}})
    for k, v in vals.items():
        got = np.asarray(out["model"][k])
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k
