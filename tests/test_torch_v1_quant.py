"""The v1 inference engine's int8 weights and int8 KV cache against the
JAX package on the CPU (inference.engine, models.llama's int8 tier; the
``runtime.zero.zeropp`` transforms are held to JAX's in
tests/test_torch_qwz.py, the DecoderLM and Mixtral decodes in
tests/test_torch_dense_decode.py).

Tolerances, each with its reason:
- The int8 cache's append: bytes and scales equal; its attention, and the
  decodes' logits: rtol 1e-5 / atol 1e-5 in fp32 (the same products summed
  in other orders).
- ``module_state_dict``: rtol 1e-5 (a jitted JAX quantization may write a
  scale one f32 ulp away from the port's).
- Greedy streams: equal token for token.

The JAX side runs on one device's worth of work (the v1 engine's default
mesh has nothing to shard at these sizes); params come from
``jax.eval_shape`` plus numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint.state import flatten_tree, unflatten_into
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM, init_cache,
                                              quantized_cache_append,
                                              quantized_cache_attention, window_bias)
from deepspeed_tpu_torch.runtime.zero import zeropp

from tests._torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5
CONF = {"dtype": "float32", "max_tokens": 64, "max_out_tokens": 16}
QUANT = {"quant": {"enabled": True, "bits": 8, "group_size": 64}}
KVQ = {"kv_quant": {"enabled": True}}


def _numpy_tree(model, seed=0):
    """(flax tree, flat numpy tree) of ``model``'s parameter shapes: norm
    scales near 1, embeddings at 1/sqrt(hidden), biases small, matrices and
    expert stacks at 1/sqrt(fan_in)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        if k.endswith(("weight", "scale")):
            flat[k] = 1.0 + 0.1 * noise
        elif k.endswith("embedding"):
            flat[k] = noise / np.float32(np.sqrt(v.shape[1]))
        elif len(v.shape) == 1:
            flat[k] = 0.1 * noise
        else:
            flat[k] = noise / np.float32(np.sqrt(v.shape[-2]))
    return unflatten_into(shapes, {k: jnp.asarray(a) for k, a in flat.items()}), flat


def _prompts(vocab, B=2, T=9, seed=2):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(np.int32)


# --------------------------------------------------------------------------- #
# the int8 dense cache tier
# --------------------------------------------------------------------------- #

def test_quantized_cache_append_and_attention_match_jax():
    """GQA (4 heads over 2) under a window: 7 rows written at offset 3 of a
    cache of 12 slots (its first 3 empty, scale 0), then attended."""
    B, H, Hkv, D, S = 2, 4, 2, 16, 12
    rng = np.random.RandomState(3)
    jcache = {"k": jnp.zeros((B, S, Hkv, D), jnp.int8), "v": jnp.zeros((B, S, Hkv, D), jnp.int8),
              "k_scale": jnp.zeros((B, S, Hkv), jnp.float32),
              "v_scale": jnp.zeros((B, S, Hkv), jnp.float32)}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    attend = jax.jit(lambda q, c, b: jax_llama.quantized_cache_attention(q, c, b, Hkv))
    for lo, T in ((3, 7),):
        q = rng.randn(B, T, H, D).astype(np.float32)
        k = rng.randn(B, T, Hkv, D).astype(np.float32)
        v = rng.randn(B, T, Hkv, D).astype(np.float32)
        k[0, 0, 1] = 0.0                         # an all-zero row: scale 1e-8
        jcache = jax_llama.quantized_cache_append(jcache, jnp.asarray(k), jnp.asarray(v), lo)
        quantized_cache_append(cache, torch.from_numpy(k), torch.from_numpy(v), lo)
        for name in cache:
            np.testing.assert_array_equal(cache[name].numpy(), np.asarray(jcache[name]))
        pos = lo + np.broadcast_to(np.arange(T), (B, T))
        kpos = np.broadcast_to(np.arange(S), (B, S))
        jbias = jax_llama._window_bias(jnp.asarray(pos), jnp.asarray(kpos), 5)
        bias = window_bias(torch.from_numpy(pos.copy()), torch.from_numpy(kpos.copy()), 5)
        np.testing.assert_array_equal(bias.numpy(), np.asarray(jbias))
        want = attend(jnp.asarray(q), jcache, jbias)
        got = quantized_cache_attention(torch.from_numpy(q), cache, bias, Hkv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_kv_quant_cache_bytes_ratio_equals_jax():
    """JAX's ``test_kv_quant_cache_bytes_halve`` geometry: (D + 4) / (2 D)
    at D 128."""
    kw = dict(vocab_size=128, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256)

    def nbytes(cache):
        return sum(int(np.prod(v.shape)) * v.dtype.itemsize for v in cache.values())

    jcfg = jax_llama.LlamaConfig(dtype=jnp.bfloat16, **kw)
    jratio = nbytes(jax_llama.init_cache(jcfg, 4, 256, kv_bits=8)) / \
        nbytes(jax_llama.init_cache(jcfg, 4, 256))
    cfg = LlamaConfig(dtype=torch.bfloat16, **kw)
    ratio = sum(t.numel() * t.element_size() for t in
                init_cache(cfg, 4, 256, kv_bits=8, device="cpu").values()) / \
        sum(t.numel() * t.element_size() for t in init_cache(cfg, 4, 256, device="cpu").values())
    assert ratio == jratio == (128 + 4) / 256


# --------------------------------------------------------------------------- #
# the v1 engine on a tiny Llama against the JAX v1 engine
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tiny_llama():
    kw = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=1)
    jmodel = jax_llama.LlamaForCausalLM(jax_llama.LlamaConfig.tiny(**kw))
    tree, flat = _numpy_tree(jmodel)
    port = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    port.load_flat({k: torch.from_numpy(v) for k, v in flat.items()})
    return jmodel, tree, port, flat


@pytest.mark.parametrize("extra", [QUANT, KVQ, {**QUANT, **KVQ}], ids=["quant", "kv_quant", "both"])
def test_v1_engine_streams_match_jax(tiny_llama, extra):
    jmodel, tree, port, flat = tiny_llama
    prompts = _prompts(256)
    jeng = deepspeed_tpu.init_inference(jmodel, config={**CONF, **extra}, model_parameters=tree)
    eng = deepspeed_tpu_torch.init_inference(port, config={**CONF, **extra},
                                             model_parameters=flat, device="cpu")
    want = np.asarray(jeng.generate(prompts, max_new_tokens=10))
    np.testing.assert_array_equal(eng.generate(prompts, max_new_tokens=10), want)
    if "quant" in extra:
        qleaves = {n for n, v in eng.params.items() if zeropp._is_qleaf(v)}
        jq = {k[:-2] for k in flatten_tree(jeng.params) if k.endswith("/q")}
        assert qleaves == jq and "embed_tokens/embedding" not in qleaves
        assert "lm_head/kernel" in qleaves
        assert all(eng.params[n]["q"].dtype == torch.int8 for n in qleaves)
        assert eng.params["lm_head/kernel"]["s"].shape == (128, 4, 1)
        sd = eng.module_state_dict()
        jsd = {k: np.asarray(v) for k, v in flatten_tree(jeng.module_state_dict()).items()}
        assert set(sd) == set(jsd)
        for n, t in sd.items():
            np.testing.assert_allclose(t.numpy(), jsd[n], rtol=1e-5, atol=0, err_msg=n)
        # the quantized engine is the plain engine over its own export
        plain = deepspeed_tpu_torch.init_inference(port, config=CONF, model_parameters=sd,
                                                   device="cpu")
        np.testing.assert_array_equal(plain.forward(prompts).numpy(),
                                      eng.forward(prompts).numpy())


def test_cache_factory_without_the_int8_tier_raises(tiny_llama):
    _, _, port, flat = tiny_llama

    def plain_cache(config, batch_size, max_len, dtype=None, device=None):
        return init_cache(config, batch_size, max_len, dtype=dtype, device=device)

    eng = deepspeed_tpu_torch.init_inference(port, config={**CONF, **KVQ},
                                             model_parameters=flat, device="cpu")
    eng._init_cache_fn = plain_cache
    with pytest.raises(TypeError):
        eng._make_cache(1, 8)
    cache = deepspeed_tpu_torch.init_inference(port, config=CONF, model_parameters=flat,
                                               device="cpu",
                                               init_cache_fn=plain_cache)._make_cache(1, 8)
    assert set(cache) == {"k", "v"}


@pytest.mark.parametrize("conf, name", [
    ({"tensor_parallel": {"tp_size": 2}}, "tensor_parallel.tp_size"),
    ({"moe": {"ep_size": 2}}, "moe.ep_size"),
])
def test_quant_config_still_refuses_parallelism(conf, name):
    InferenceConfig.load({**QUANT, **KVQ})
    with pytest.raises(NotImplementedError, match=name):
        InferenceConfig.load({**QUANT, **KVQ, **conf})
