"""ZeRO++ qwZ (``zero_optimization.zero_quantized_weights``) in the port's
training engine on a world of one, against the JAX engine on one device
(deepspeed_tpu_torch.runtime.engine, runtime.zero.zeropp,
checkpoint.state).

- ``quantize_leaf`` / ``dequantize_leaf`` (bits 8 and 4; one group a row,
  groups of 64, a group size that does not divide; 2-D and 3-D leaves; an
  all-zero row) and ``quantize_param_tree`` against JAX's: the scales
  equal in f32, the int8 bytes equal (a byte may differ only where the
  quotient sits within two f32 ulps of a rounding tie), the same set of
  quantized leaves. The v1 engine's ``quant`` shares these transforms.

- The loss stream of the GPT-2 tiny of JAX's ``test_qwz_training_tracks_fp``
  (bf16, AdamW at lr 1e-2) matches the JAX engine's at rtol 1e-3 (bf16
  forwards over the same int8 weights; the two frameworks round the bf16
  products at different places).
- The compute params are int8 ``{q, s}`` for JAX's set of leaves; between
  steps the module holds no dequantized copy.
- Within the port: step 1 is bit-equal to the plain engine started from
  the quantized master's dequantization; the facade equals ``train_batch``
  byte for byte.
- A qwZ tag moves both ways between the packages; offload + qwZ and the
  colocated bridge's source refuse, in the JAX engine's words."""

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
from deepspeed_tpu.runtime.zero import zeropp as jax_zeropp
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine
from deepspeed_tpu_torch.runtime.zero import zeropp

from tests._torch_threads import one_torch_thread  # noqa: F401

GPT2 = dict(vocab_size=64, n_positions=16, n_embd=64, n_layer=1, n_head=2)


def _config(qwz=True, **extra):
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 1,
            "bf16": {"enabled": True}, "steps_per_print": 0,
            "zero_optimization": {"stage": 3, "stage3_param_persistence_threshold": 0,
                                  "zero_quantized_weights": qwz},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}, **extra}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 64, (8, 16)).astype(np.int32)} for _ in range(n)]


@pytest.fixture(scope="module")
def jax_gpt2():
    model = JaxGPT2(JaxGPT2Config(dtype=jnp.bfloat16, **GPT2))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 {"input_ids": jnp.zeros((1, 16), jnp.int32)})["params"]
    return model, params, {k: np.asarray(v) for k, v in flatten_tree(params).items()}


def _jax_engine(jax_gpt2, qwz=True):
    model, params, _ = jax_gpt2
    eng, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=_config(qwz),
        mesh_topology=build_topology(MeshConfig(data=1), devices=jax.devices()[:1]))
    return eng


def _port_engine(flat, qwz=True, **extra):
    model = GPT2LMHead(GPT2Config(dtype=torch.bfloat16, **GPT2), device="cpu", seed=1)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=flat,
                                             config=_config(qwz, **extra), device="cpu")
    return eng


def _losses(eng, batches):
    return np.array([float(eng.train_batch(b)) for b in batches])


# --------------------------------------------------------------------------- #
# quantize_leaf / dequantize_leaf / quantize_param_tree
# --------------------------------------------------------------------------- #

def _assert_bytes_or_ties(q_port, q_jax, x32, s):
    """Equal int8 bytes, except where the quotient x / s is a rounding tie
    to within two f32 ulps."""
    diff = q_port != q_jax
    if not diff.any():
        return
    quot = (x32.astype(np.float64).reshape(s.shape[:-1] + (-1,))
            / s.astype(np.float64)).reshape(x32.shape)[diff]
    frac = np.abs(np.abs(quot) - np.floor(np.abs(quot)) - 0.5)
    assert (frac <= 2 * np.finfo(np.float32).eps * np.abs(quot)).all(), (quot, frac)
    assert (np.abs(q_port.astype(int) - q_jax.astype(int))[diff] == 1).all()


@pytest.mark.parametrize("bits, group, shape", [
    (8, None, (12, 128)), (8, 64, (4, 6, 128)), (8, 48, (12, 128)),
    (4, None, (4, 6, 128)), (4, 64, (12, 128)), (4, 48, (4, 6, 128)),
], ids=["8-row-2d", "8-g64-3d", "8-g48-nondividing-2d", "4-row-3d", "4-g64-2d",
        "4-g48-nondividing-3d"])
def test_quantize_leaf_matches_jax(bits, group, shape):
    x = np.random.RandomState(bits + (group or 0)).randn(*shape).astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0        # an all-zero row: its scales are 1.0
    got = zeropp.quantize_leaf(torch.from_numpy(x), num_bits=bits, group_size=group)
    want = jax_zeropp.quantize_leaf(jnp.asarray(x), num_bits=bits, group_size=group)
    s_jax = np.asarray(want["s"])
    assert tuple(got["s"].shape) == s_jax.shape
    n_groups = 2 if group == 64 else 1
    assert got["s"].shape == shape[:-1] + (n_groups, 1)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["s"].numpy(), s_jax)
    assert (got["s"].reshape(-1, n_groups)[1] == 1.0).all()
    _assert_bytes_or_ties(got["q"].numpy(), np.asarray(want["q"]), x, s_jax)
    qmax = 2 ** (bits - 1) - 1
    assert int(got["q"].max()) <= qmax and int(got["q"].min()) >= -qmax - 1
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        back = zeropp.dequantize_leaf(got, dt)
        ref = jax_zeropp.dequantize_leaf({"q": jnp.asarray(got["q"].numpy()),
                                          "s": jnp.asarray(got["s"].numpy())}, jdt)
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


def test_quantize_param_tree_quantizes_jax_set():
    rng = np.random.RandomState(0)
    tree = {"w": (64, 64), "b": (64,), "tiny": (2, 2), "stack": (4, 32, 32),
            "under": (32, 63), "at": (2048, 1)}
    flat = {k: rng.randn(*s).astype(np.float32) for k, s in tree.items()}
    got = zeropp.quantize_param_tree({k: torch.from_numpy(v) for k, v in flat.items()},
                                     torch.bfloat16)
    want = jax_zeropp.quantize_param_tree({k: jnp.asarray(v) for k, v in flat.items()},
                                          jnp.bfloat16)
    qset = {k for k, v in got.items() if zeropp._is_qleaf(v)}
    assert qset == {k for k, v in want.items() if jax_zeropp._is_qleaf(v)}
    assert qset == {"w", "stack", "at"}
    for k in qset:
        np.testing.assert_array_equal(got[k]["s"].numpy(), np.asarray(want[k]["s"]))
    for k in set(flat) - qset:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k].astype(jnp.float32)))
    back = zeropp.dequantize_param_tree(got, torch.float32)
    assert all(isinstance(v, torch.Tensor) for v in back.values())


def test_qwz_loss_stream_matches_jax_engine(jax_gpt2):
    batches = _batches(5)
    jeng, peng = _jax_engine(jax_gpt2), _port_engine(jax_gpt2[2])
    assert jeng.quantized_weights and peng.quantized_weights
    jl = _losses(jeng, batches)
    pl = _losses(peng, batches)
    np.testing.assert_allclose(pl, jl, rtol=1e-3)
    assert pl[-1] < pl[0]
    # the compute params: int8 {q, s} for exactly JAX's leaves, the scales
    # of this step's master equal to JAX's requantization of the port's
    params = peng.state["params"]
    qset = {n for n, v in params.items() if zeropp._is_qleaf(v)}
    assert qset == {k[:-2] for k in flatten_tree(jeng.state["params"]) if k.endswith("/q")}
    assert "wte/embedding" in qset and "wpe/embedding" not in qset
    for n in qset:
        assert params[n]["q"].dtype == torch.int8 and params[n]["s"].dtype == torch.float32
        want = jax_zeropp.quantize_leaf(jnp.asarray(peng.state["master"][n].numpy()))
        np.testing.assert_array_equal(params[n]["s"].numpy(), np.asarray(want["s"]))
    # between steps the module holds no dequantized copy of those leaves
    named = peng.module.named_flat_parameters()
    assert all(named[n].stride() == (0,) * named[n].dim() for n in qset)
    assert all(params[n] is named[n] for n in set(params) - qset)


def test_qwz_step_one_is_the_plain_engine_on_the_dequantized_master(jax_gpt2):
    """Step 1 (loss and grad norm) bit-equal to a plain bf16 engine whose
    master is ``dequantize_param_tree(quantize_param_tree(master), f32)``,
    and the facade (forward / backward / step) equal to ``train_batch``."""
    flat = jax_gpt2[2]
    master = {k: torch.tensor(v, dtype=torch.float32) for k, v in flat.items()}
    rt = zeropp.dequantize_param_tree(zeropp.quantize_param_tree(master, torch.bfloat16),
                                      torch.float32)
    batches = _batches(3, seed=1)
    q, plain = _port_engine(flat), _port_engine({k: v.float() for k, v in rt.items()},
                                                qwz=False)
    assert torch.equal(q.train_batch(batches[0]), plain.train_batch(batches[0]))
    assert q.get_global_grad_norm() == plain.get_global_grad_norm()
    facade, ref = _port_engine(flat), _port_engine(flat)      # gas 8
    for b in batches:
        for i in range(8):
            facade.backward(facade.forward({"input_ids": b["input_ids"][i:i + 1]}))
            facade.step()
        ref.train_batch(b)
    for n, t in ref.state["master"].items():
        assert torch.equal(facade.state["master"][n], t), n
    assert facade.global_steps == ref.global_steps == 3
    np.testing.assert_allclose(facade.eval_loss(batches[0]), ref.eval_loss(batches[0]))


def test_qwz_checkpoint_moves_both_ways(jax_gpt2, tmp_path):
    """A port qwZ tag resumes in the JAX engine and a JAX qwZ tag in the
    port's: the next losses agree at the stream's tolerance."""
    batches = _batches(4, seed=2)
    peng, jeng = _port_engine(jax_gpt2[2]), _jax_engine(jax_gpt2)
    _losses(peng, batches[:2])
    _losses(jeng, batches[:2])
    peng.save_checkpoint(str(tmp_path / "port"), tag="q")
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="q")
    port_next = _losses(peng, batches[2:])
    jax_next = _losses(jeng, batches[2:])
    j2 = _jax_engine(jax_gpt2)
    j2.load_checkpoint(str(tmp_path / "port"), tag="q")
    np.testing.assert_allclose(_losses(j2, batches[2:]), port_next, rtol=1e-3)
    p2 = _port_engine(jax_gpt2[2])
    p2.load_checkpoint(str(tmp_path / "jax"), tag="q")
    assert p2.global_steps == 2
    np.testing.assert_allclose(_losses(p2, batches[2:]), jax_next, rtol=1e-3)
    # and a port tag resumes the port bit for bit
    p3 = _port_engine(jax_gpt2[2])
    p3.load_checkpoint(str(tmp_path / "port"), tag="q")
    np.testing.assert_array_equal(_losses(p3, batches[2:]), port_next)


def test_qwz_refusals_keep_the_jax_words(jax_gpt2):
    with pytest.raises(ConfigError, match="zero_quantized_weights is not supported "
                                          "together with offload_optimizer"):
        _port_engine(jax_gpt2[2], zero_optimization={
            "stage": 1, "zero_quantized_weights": True,
            "offload_optimizer": {"device": "cpu"}})
    jeng, peng = _jax_engine(jax_gpt2), _port_engine(jax_gpt2[2])
    with pytest.raises(NotImplementedError) as jax_err:
        jeng.rollout_source_params()
    with pytest.raises(NotImplementedError) as port_err:
        peng.rollout_source_params()
    assert str(port_err.value) == str(jax_err.value)
    assert "quantized-weight (ZeRO++ qwZ)" in str(port_err.value)


def test_hybrid_engine_requantizes_its_int8_inference_weights():
    """A hybrid engine on a qwZ trainer generating through an int8 v1
    engine: after a step the refresh requantizes the new weights in place;
    the streams equal a fresh int8 engine's over the trained master."""
    model = LlamaForCausalLM(LlamaConfig.tiny(hidden_size=128, intermediate_size=256),
                             device="cpu")
    engine = DeepSpeedHybridEngine(model=model, device="cpu", config={
        "train_batch_size": 2, "steps_per_print": 0,
        "zero_optimization": {"stage": 0, "zero_quantized_weights": True},
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
        "hybrid_engine": {"enabled": True}},
        inference_config={"quant": {"enabled": True}, "max_out_tokens": 16})
    prompt = np.array([[5, 9, 2, 7]], np.int32)
    engine.generate(prompt, max_new_tokens=4)
    infer = engine._inference_engine()
    q = infer.params["layers_0/mlp/up_proj/kernel"]["q"]
    before = q.clone()
    engine.train_batch({"input_ids": np.random.default_rng(0).integers(
        0, 256, (2, 16)).astype(np.int32)})
    out = engine.generate(prompt, max_new_tokens=4)
    assert infer is engine._inference_engine()
    assert infer.params["layers_0/mlp/up_proj/kernel"]["q"] is q and not torch.equal(q, before)
    fresh = InferenceEngine(model, {"dtype": "float32", "quant": {"enabled": True}},
                            model_parameters=engine.state["master"], device="cpu")
    np.testing.assert_array_equal(fresh.generate(prompt, max_new_tokens=4), out)
