"""The port's hybrid engine and v1 inference engine on the CPU
(deepspeed_tpu_torch.runtime.hybrid_engine, inference.engine, and the dense
KV cache of models.llama).

- ``test_hybrid_engine_train_and_generate``: the JAX package's test of the
  same name (tests/unit/test_hybrid_misc.py) on one device at ZeRO stage 0,
  plus the generate held to a fresh ``InferenceEngine`` over the same
  cast weights.
- The dense cache: the port's ``LlamaForCausalLM.decode`` (a prefill, then
  single-token steps) against the JAX model's ``decode`` on the same
  numpy weights, without and with a sliding window, at rtol 1e-4 /
  atol 1e-5 (fp32; XLA and torch sum the same products in other orders).
- ``init_inference(...).generate`` (greedy, fp32) against the JAX
  package's token for token on the same converted tiny Llama, without and
  with an EOS id; the engine's weights from a training checkpoint; the
  budget rules.
- The refusals by name: tensor and expert parallelism, int8 weights and
  the int8 cache tier, the hybrid engine's ``inference_tp_size``, models
  by name and HuggingFace modules, the decoders without a dense decode.

Params come from ``jax.eval_shape`` plus numpy (no flax ``init``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint.state import flatten_tree, unflatten_into
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.llama import init_cache as jax_init_cache
from deepspeed_tpu_torch.config import DeepSpeedTPUConfig
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_cache
from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine

from tests._torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def _numpy_flax(model, seed=0):
    """(flax tree, flat numpy tree): norm weights near 1, embeddings at
    1/sqrt(hidden), kernels at 1/sqrt(fan_in)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        if k.endswith("weight"):
            flat[k] = 1.0 + 0.1 * noise
        elif k.endswith("embedding"):
            flat[k] = noise / np.float32(np.sqrt(v.shape[1]))
        else:
            flat[k] = noise / np.float32(np.sqrt(v.shape[0]))
    return unflatten_into(shapes, {k: jnp.asarray(a) for k, a in flat.items()}), flat


def _pair(**kw):
    """(JAX model, its flax params, the port model over the same weights,
    the flat numpy tree)."""
    jmodel = JaxLlama(JaxLlamaConfig.tiny(**kw))
    tree, flat = _numpy_flax(jmodel)
    port = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    port.load_flat({k: torch.from_numpy(v) for k, v in flat.items()})
    return jmodel, tree, port, flat


# --------------------------------------------------------------------------- #
# the hybrid engine
# --------------------------------------------------------------------------- #

def test_hybrid_engine_train_and_generate():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    cfg = {
        "train_batch_size": 8, "train_micro_batch_size_per_gpu": 1,
        "zero_optimization": {"stage": 0}, "steps_per_print": 0,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
        "hybrid_engine": {"enabled": True, "max_out_tokens": 16},
    }
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    assert isinstance(engine, DeepSpeedHybridEngine)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 256, (8, 16)).astype(np.int32)}
    engine.train_batch(batch)

    prompt = np.array([[5, 9, 2]], np.int32)
    out1 = np.asarray(engine.generate(prompt, max_new_tokens=4))
    assert out1.shape == (1, 7)
    assert engine.generate_count == 1 and engine.generate_time > 0

    # the weights change -> generation sees the NEW weights (the RLHF contract)
    before = engine._inference_engine().params["layers_0/self_attn/q_proj/kernel"].clone()
    for _ in range(4):
        engine.train_batch({"input_ids": rng.integers(0, 256, (8, 16)).astype(np.int32)})
    out2 = np.asarray(engine.generate(prompt, max_new_tokens=4))
    assert out2.shape == (1, 7)
    infer = engine._inference_engine()
    after = infer.params["layers_0/self_attn/q_proj/kernel"]
    assert not np.allclose(before.numpy(), after.numpy()), \
        "inference params not refreshed from training weights"
    assert engine.generate_count == 2
    # the refresh wrote into the engine's own tensors (no rebuild, no alias)
    assert infer is engine._inference_engine()
    assert after.data_ptr() != engine.state["master"]["layers_0/self_attn/q_proj/kernel"].data_ptr()
    fresh = InferenceEngine(model, InferenceConfig.load({"dtype": "float32"}),
                            model_parameters=engine.state["master"], device="cpu")
    assert (fresh.generate(prompt, max_new_tokens=4) == out2).all()

    engine.eval()
    assert engine._in_eval
    engine.train()
    assert not engine._in_eval


def test_hybrid_engine_release_inference_cache():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 2, "steps_per_print": 0,
        "hybrid_engine": {"enabled": True, "release_inference_cache": True}})
    engine.generate(np.array([[1, 2, 3]], np.int32), max_new_tokens=2)
    assert engine._infer is not None
    engine.train()
    assert engine._infer is None


# --------------------------------------------------------------------------- #
# the dense KV cache against the JAX model's decode
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [{}, {"sliding_window": 6}], ids=["full", "window"])
def test_llama_decode_matches_jax(kw):
    jmodel, tree, port, _ = _pair(**kw)
    B, T, S = 2, 9, 16
    ids = np.random.RandomState(1).randint(0, 256, (B, T + 3)).astype(np.int32)
    jcache = jax_init_cache(jmodel.config, B, S)
    cache = init_cache(port.config, B, S, device="cpu")
    for lo, hi in ((0, T), (T, T + 1), (T + 1, T + 2), (T + 2, T + 3)):
        want, jcache = jmodel.apply({"params": tree}, jnp.asarray(ids[:, lo:hi]), jcache,
                                    jnp.int32(lo), method=JaxLlama.decode)
        got, cache = port.decode(torch.from_numpy(ids[:, lo:hi]), cache, lo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("eos", [False, True], ids=["greedy", "eos"])
def test_init_inference_generate_matches_jax(eos):
    jmodel, tree, port, flat = _pair()
    prompts = np.random.RandomState(2).randint(0, 256, (2, 7)).astype(np.int32)
    conf = {"dtype": "float32", "max_tokens": 64, "max_out_tokens": 16}
    jeng = deepspeed_tpu.init_inference(jmodel, config=conf, model_parameters=tree)
    want = np.asarray(jeng.generate(prompts, max_new_tokens=10))
    eos_id = int(want[0, 7 + 3]) if eos else None
    if eos:
        want = np.asarray(jeng.generate(prompts, max_new_tokens=10, eos_token_id=eos_id))
    eng = deepspeed_tpu_torch.init_inference(port, config=conf, model_parameters=flat,
                                             device="cpu")
    assert isinstance(eng, InferenceEngine)
    got = eng.generate(prompts, max_new_tokens=10, eos_token_id=eos_id)
    np.testing.assert_array_equal(got, want)
    # the engine's forward is the model's dense forward over its weights
    np.testing.assert_allclose(eng.forward(prompts).numpy(),
                               port.forward_logits(torch.from_numpy(prompts).long()).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_init_inference_from_a_training_checkpoint(tmp_path):
    """``config.checkpoint.checkpoint_dir``: the engine reads a training
    tag's master (``latest`` when no tag is named) and casts it."""
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    trainer, *_ = deepspeed_tpu_torch.initialize(model=model, device="cpu", config={
        "train_batch_size": 2, "steps_per_print": 0})
    trainer.train_batch({"input_ids": np.random.default_rng(0).integers(
        0, 256, (2, 16)).astype(np.int32)})
    trainer.save_checkpoint(str(tmp_path))
    eng = deepspeed_tpu_torch.init_inference(model, config={
        "dtype": "bfloat16", "checkpoint": {"checkpoint_dir": str(tmp_path)}}, device="cpu")
    assert set(eng.params) == set(trainer.state["master"])
    for name, t in trainer.state["master"].items():
        assert torch.equal(eng.params[name], t.detach().to(torch.bfloat16)), name
    with pytest.raises(ValueError, match="model_parameters"):
        deepspeed_tpu_torch.init_inference(model, device="cpu")


def test_generate_budget_rules():
    _, _, port, flat = _pair()
    eng = deepspeed_tpu_torch.init_inference(port, config={"dtype": "float32",
                                                           "max_tokens": 12,
                                                           "max_out_tokens": 4},
                                             model_parameters=flat, device="cpu")
    with pytest.raises(ValueError, match="max_out_tokens"):
        eng.generate(np.zeros((1, 4), np.int32), max_new_tokens=5)
    with pytest.raises(ValueError, match="max_tokens"):
        eng.generate(np.zeros((1, 10), np.int32), max_new_tokens=4)
    out = eng.generate(np.zeros((1, 8), np.int32), max_new_tokens=4, do_sample=True, top_k=5)
    assert out.shape == (1, 12) and ((out >= 0) & (out < 256)).all()


# --------------------------------------------------------------------------- #
# refusals by name
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("conf, name", [
    ({"tensor_parallel": {"tp_size": 2}}, "tensor_parallel.tp_size"),
    ({"mp_size": 2}, "tensor_parallel.tp_size"),
    ({"moe": {"ep_size": 2}}, "moe.ep_size"),
    ({"quant": {"enabled": True}}, "quant.enabled"),
    ({"kv_quant": {"enabled": True}}, "kv_quant.enabled"),
])
def test_inference_config_refuses_by_name(conf, name):
    with pytest.raises(NotImplementedError, match=name):
        InferenceConfig.load(conf)


def test_unported_paths_refuse_by_name():
    with pytest.raises(NotImplementedError, match="hybrid_engine.inference_tp_size"):
        DeepSpeedTPUConfig.load({"train_batch_size": 8, "hybrid_engine": {
            "enabled": True, "inference_tp_size": 2}})
    with pytest.raises(NotImplementedError, match="by name or path"):
        deepspeed_tpu_torch.init_inference("meta-llama/Llama-2-7b-hf")

    class HFConfig:
        model_type = "llama"

    class HFModel(torch.nn.Module):
        config = HFConfig()

    with pytest.raises(NotImplementedError, match="HuggingFace"):
        deepspeed_tpu_torch.init_inference(HFModel())
    with pytest.raises(NotImplementedError, match="kv_bits=8"):
        init_cache(LlamaConfig.tiny(), 1, 8, kv_bits=8, device="cpu")
    from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
    for m in (DecoderLM(DecoderConfig.tiny("opt"), device="cpu"),
              MixtralForCausalLM(MixtralConfig.tiny(), device="cpu")):
        eng = InferenceEngine(m, {"dtype": "float32"}, model_parameters=m.flat_params(),
                              device="cpu")
        with pytest.raises(NotImplementedError, match="decode"):
            eng.generate(np.zeros((1, 4), np.int32), max_new_tokens=2)
