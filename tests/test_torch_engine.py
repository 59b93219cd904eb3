"""The port's serving slice against the JAX package, on the same weights.

The weight carrier moves the JAX package's flax parameters into the port;
then the port's dense forward is held against flax's, and the port's v2
engine (on the CPU, kernels' plain versions) against the JAX v2 engine
(Pallas in interpret mode) for two tiny Llama configs: head_dim 16 (which
JAX serves through its small-D decode-step path) and head_dim 128 (its
side-buffer decode step). A small block size and chunk budget make every
prompt span passes. Everything runs in f32.

Tolerances: logits 1e-4 absolute (magnitudes ~1; the two frameworks sum
the same f32 products in different orders through several layers); greedy
token streams exactly equal.
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
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

from tests._torch_threads import one_torch_thread  # noqa: F401

LOGITS_ATOL = 1e-4

CONFIGS = {
    "d16": dict(vocab_size=128, max_position_embeddings=128),
    "d128": dict(vocab_size=128, hidden_size=256, intermediate_size=128,
                 num_attention_heads=2, num_key_value_heads=1,
                 max_position_embeddings=128),
}
STATE = {"max_tracked_sequences": 8, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 36, "max_context": 128,
         "prefill_chunk_size": 16}
BLOCK = 8


def _flax(name):
    cfg = JaxLlamaConfig.tiny(**CONFIGS[name])
    model = JaxLlama(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    return cfg, model, params


def _port_model(cfg, flat):
    pcfg = LlamaConfig.tiny(**CONFIGS[cfg])
    model = LlamaForCausalLM(pcfg, device="cpu", seed=1)
    model.load_flat(params_from_flat(flat, device="cpu"))
    return model


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def engines(request):
    """One JAX engine and one port engine per config, on the same weights."""
    name = request.param
    cfg, model, params = _flax(name)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    jax_engine = JaxEngine(model=model, model_parameters=params,
                           config={"dtype": jnp.float32, "state_manager": STATE,
                                   "kv_cache": {"block_size": BLOCK}})
    port_model = _port_model(name, flat)
    port_engine = InferenceEngineV2(
        port_model, {"dtype": torch.float32, "state_manager": STATE,
                     "kv_cache": {"block_size": BLOCK}},
        port_model.flat_params(), device="cpu")
    return jax_engine, port_engine


def _prompts(seed, lengths, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_weight_carrier_round_trip_is_byte_equal(dtype):
    _, _, params = _flax("d16")
    flat = {k: np.asarray(v.astype(dtype)) for k, v in flatten_tree(params).items()}
    back = params_to_flat(params_from_flat(flat, device="cpu"))
    assert set(back) == set(flat)
    for k, a in flat.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        assert back[k].tobytes() == a.tobytes(), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dense_forward_matches_flax(name):
    cfg, model, params = _flax(name)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    ids = _prompts(3, [2 * 11])[0].reshape(2, 11)
    ref = model.apply({"params": params}, jnp.asarray(ids), method="forward_logits")
    port = _port_model(name, flat).forward_logits(torch.from_numpy(ids).long())
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=LOGITS_ATOL)


def test_put_logits_match_for_prompts_and_a_mixed_pass(engines):
    jax_engine, port_engine = engines
    base = port_engine.free_blocks
    # 40 tokens span three 32-token passes of this budget
    prompts = _prompts(4, [40, 7, 13])
    ref = jax_engine.put([0, 1, 2], prompts)
    got = port_engine.put([0, 1, 2], prompts)
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGITS_ATOL)
    # one decode row each for 0 and 1, a new prompt in the same pass (chunk
    # slots + decode rows: the mixed pass)
    step = [np.array([int(np.argmax(r))], np.int32) for r in ref[:2]]
    new = _prompts(5, [19])
    ref2 = jax_engine.put([0, 1, 3], step + new)
    got2 = port_engine.put([0, 1, 3], step + new)
    np.testing.assert_allclose(got2, ref2, rtol=0, atol=LOGITS_ATOL)
    # the host-side capacity answers agree too
    for uid, n in [(0, 100), (3, 5), (9, 40)]:
        assert port_engine.query(uid, n) == jax_engine.query(uid, n)
    assert port_engine.can_schedule([4, 5], [60, 60]) == \
        jax_engine.can_schedule([4, 5], [60, 60])
    for e in engines:
        e.flush([0, 1, 2, 3])
    assert port_engine.free_blocks == base


def test_generate_greedy_streams_equal(engines):
    jax_engine, port_engine = engines
    base = port_engine.free_blocks
    prompts = _prompts(6, [5, 33, 12])
    ref = jax_engine.generate(prompts, max_new_tokens=8)
    got = port_engine.generate(prompts, max_new_tokens=8)
    assert [list(map(int, o)) for o in got] == [list(map(int, o)) for o in ref]
    assert port_engine.free_blocks == base
    assert not port_engine.scheduler.seqs
    # an EOS token retires its stream mid-run while the others go on
    eos = int(ref[0][len(prompts[0]) + 2])
    ref = jax_engine.generate(prompts, max_new_tokens=8, eos_token_id=eos)
    got = port_engine.generate(prompts, max_new_tokens=8, eos_token_id=eos)
    assert [list(map(int, o)) for o in got] == [list(map(int, o)) for o in ref]
    assert len(got[0]) <= len(prompts[0]) + 3
    assert port_engine.free_blocks == base
