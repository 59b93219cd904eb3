"""The Llama lineage's Qwen2 and Gemma flags in the port against the JAX
package.

Qwen2 (``qkv_bias``: q/k/v with biases, here random and nonzero, and G = 3
query heads per kv head) and Gemma (``embed_scale_by_sqrt_dim``,
``norm_plus_one`` with norm weights around 0, ``mlp_act="gelu"``: the
tanh GELU, and ``head_dim_override``): the port's dense forward against
the JAX package's ``LlamaForCausalLM`` on the same weights, and the port's
engine (``family`` guessed, and named ``qwen2`` / ``gemma``) against the
JAX engine: ``put`` logits and greedy streams, as the JAX package's
``test_gemma_flags_match_v1``.

Tolerances: f32 logits 1e-4 absolute plus 1e-4 relative (the two
frameworks sum in other orders); greedy streams exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.checkpoint import params_from_flat, params_to_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.ragged_model import ADAPTERS, LLAMA
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

from tests._torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(vocab_size=256, hidden_size=96, intermediate_size=160, num_hidden_layers=2,
            max_position_embeddings=128)
FLAGS = {
    "qwen2": dict(num_attention_heads=6, num_key_value_heads=2, qkv_bias=True,
                  rope_theta=1e6, rms_norm_eps=1e-6),
    "gemma": dict(num_attention_heads=2, num_key_value_heads=2, head_dim_override=64,
                  embed_scale_by_sqrt_dim=True, norm_plus_one=True, mlp_act="gelu",
                  rms_norm_eps=1e-6),
}
ENGINE = {"state_manager": {"max_tracked_sequences": 4, "max_ragged_sequence_count": 4,
                            "max_ragged_batch_size": 68, "prefill_chunk_size": 16,
                            "max_context": 128},
          "kv_cache": {"block_size": 16}}


def _random_flax(model, seed, plus_one):
    """(params, flat numpy tree) from ``jax.eval_shape`` shapes and numpy:
    norm weights near 1 (near 0 under ``norm_plus_one``), embeddings at
    1/sqrt(hidden), kernels at 1/sqrt(fan_in), biases at 0.3 (nonzero: a
    dropped bias shows)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        if k.endswith("weight"):
            flat[k] = (0.0 if plus_one else 1.0) + 0.1 * noise
        elif k.endswith("embedding"):
            flat[k] = noise / np.float32(np.sqrt(v.shape[1]))
        elif k.endswith("bias"):
            flat[k] = 0.3 * noise
        else:
            flat[k] = noise / np.float32(np.sqrt(v.shape[0]))
    tree = {}
    for k, a in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree, flat


@pytest.fixture(scope="module", params=sorted(FLAGS))
def lineage(request):
    """(name, JAX model, JAX params, flat numpy tree, port model) for one
    lineage, on the same weights."""
    name = request.param
    kw = {**BASE, **FLAGS[name]}
    jmodel = JaxLlama(JaxLlamaConfig(dtype=jnp.float32, **kw))
    params, flat = _random_flax(jmodel, 11, kw.get("norm_plus_one", False))
    port = LlamaForCausalLM(LlamaConfig(**kw), device="cpu", seed=1)
    port.load_flat(params_from_flat(flat, device="cpu"))
    return name, jmodel, params, flat, port


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, BASE["vocab_size"], n).astype(np.int32) for n in lengths]


def test_dense_forward_matches_jax(lineage):
    """The port's dense forward against the JAX model's, in f32, and the
    flat tree's names (q/k/v biases for Qwen2) both ways."""
    name, jmodel, params, flat, port = lineage
    ids = np.random.RandomState(3).randint(0, BASE["vocab_size"], (2, 21)).astype(np.int32)
    ref = jmodel.apply({"params": params}, jnp.asarray(ids), method="forward_logits")
    got = port.forward_logits(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    back = params_to_flat(port.flat_params())
    assert set(back) == set(flat)
    assert ("layers_0/self_attn/q_proj/bias" in back) == (name == "qwen2")


def test_engine_matches_jax_engine(lineage):
    """The port's engine (the family guessed from the model, and named)
    against the JAX engine on the same weights: ``put`` logits (a prompt
    across two passes, decode rows mixed with a new prompt) and greedy
    streams through ``generate``."""
    name, jmodel, params, _, port = lineage
    jax_engine = JaxEngine(model=jmodel, model_parameters=params,
                           config={**ENGINE, "dtype": jnp.float32})
    cfg = {**ENGINE, "dtype": torch.float32}
    port_engine = InferenceEngineV2(port, cfg, port.flat_params(), device="cpu")
    spec = port_engine.spec
    assert spec.activation == ("geglu" if name == "gemma" else "swiglu")
    assert spec.norm_plus_one == spec.embed_scale_by_sqrt_dim == (name == "gemma")
    assert ("bq" in port_engine.weights["layers"][0]) == (name == "qwen2")
    prompts = _prompts(1, [40, 9, 23])
    ref = jax_engine.put([0, 1, 2], prompts)
    np.testing.assert_allclose(port_engine.put([0, 1, 2], prompts), ref, **TOL)
    step = [np.array([int(np.argmax(r))], np.int32) for r in ref[:2]]
    new = _prompts(2, [20])
    np.testing.assert_allclose(port_engine.put([0, 1, 3], step + new),
                               jax_engine.put([0, 1, 3], step + new), **TOL)
    jax_engine.flush([0, 1, 2, 3])
    named = InferenceEngineV2(port, cfg, port.flat_params(), family=name, device="cpu")
    prompts = _prompts(3, [30, 5, 17])
    ref = [list(map(int, o)) for o in jax_engine.generate(prompts, max_new_tokens=6)]
    assert [list(map(int, o)) for o in named.generate(prompts, max_new_tokens=6)] == ref


def test_adapters_and_refusals():
    """``qwen2`` and ``gemma`` ride the Llama adapter; a gate activation
    with no gated mapping is refused by name."""
    assert ADAPTERS["qwen2"] is LLAMA and ADAPTERS["gemma"] is LLAMA
    with pytest.raises(ValueError, match="mlp_act 'relu'"):
        LlamaForCausalLM(LlamaConfig.tiny(mlp_act="relu"), device="cpu").forward_logits(
            torch.zeros(1, 2, dtype=torch.long))
    model = LlamaForCausalLM(LlamaConfig.tiny(mlp_act="relu"), device="cpu")
    with pytest.raises(ValueError, match="mlp_act 'relu'"):
        InferenceEngineV2(model, {**ENGINE, "dtype": torch.float32}, model.flat_params(),
                          device="cpu")
