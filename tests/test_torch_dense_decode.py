"""The v1 engine's DecoderLM and Mixtral dense decodes against the JAX
package on the CPU (models.decoder ``DecoderLM.decode`` with
``init_decoder_cache``, models.mixtral's decode, through
inference.engine), in their own file to keep each file's time alone
under 25 s (the JAX side's compiles dominate).

Tolerances: the decode logits at rtol 1e-5 / atol 1e-5 in fp32 (the same
products summed in other orders); greedy streams token for token."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from deepspeed_tpu.models.decoder import DecoderLM as JaxDecoderLM
from deepspeed_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM
from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
from tests.test_torch_v1_quant import ATOL, CONF, KVQ, QUANT, RTOL, _numpy_tree, _prompts

from tests._torch_threads import one_torch_thread  # noqa: F401



def _engine_logits(jeng, eng, ids, T, new):
    """A prefill of ``ids[:, :T]`` then ``new - 1`` single-token steps
    through the JAX engine's compiled ``decode`` (the programs its
    ``generate`` built) and the port engine's: the last-position logits of
    each step."""
    B = ids.shape[0]
    jcache, cache = jeng._make_cache(B, T + new), eng._make_cache(B, T + new)
    want, jcache = jeng._prefill(jeng.params, jnp.asarray(ids[:, :T]), jcache)
    got, cache = eng._net.decode(torch.from_numpy(ids[:, :T]), cache, 0)
    yield got[:, -1].numpy(), np.asarray(want)
    for i in range(T, T + new - 1):
        want, jcache = jeng._decode_step(jeng.params, jnp.asarray(ids[:, i:i + 1]), jcache,
                                         jnp.int32(i))
        got, cache = eng._net.decode(torch.from_numpy(ids[:, i:i + 1]), cache, i)
        yield got[:, -1].numpy(), np.asarray(want)


def _streams_and_logits(jmodel, tree, port, flat, conf, ids, T=9, new=6):
    """Greedy streams of both v1 engines on ``ids[:, :T]`` equal, and the
    decode logits along ``ids`` within RTOL / ATOL."""
    jeng = deepspeed_tpu.init_inference(jmodel, model_parameters=tree, config=conf)
    eng = deepspeed_tpu_torch.init_inference(port, config=conf, model_parameters=flat,
                                             device="cpu")
    np.testing.assert_array_equal(eng.generate(ids[:, :T], new),
                                  np.asarray(jeng.generate(ids[:, :T], new)))
    for got, want in _engine_logits(jeng, eng, ids, T, new):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return eng


@pytest.mark.parametrize("family", ["opt", "bloom", "gpt_neox", "falcon"])
def test_decoder_decode_and_streams_match_jax(family):
    """Both caches (fp32, and the int8 tier under ``kv_quant``, as JAX's
    ``test_kv_quant_decoder_zoo_greedy_match``); BLOOM's ALiBi reaches the
    int8 attention through the shared bias."""
    jmodel = JaxDecoderLM(JaxDecoderConfig.tiny(family, dtype=jnp.float32,
                                                num_hidden_layers=1))
    tree, flat = _numpy_tree(jmodel)
    port = DecoderLM(DecoderConfig.tiny(family, num_hidden_layers=1), device="cpu")
    port.load_flat(params_from_flat(flat, device="cpu"))
    ids = _prompts(256, T=14, seed=4)
    for extra in ({}, KVQ):
        eng = _streams_and_logits(jmodel, tree, port, flat,
                                  {"dtype": "fp32", "max_tokens": 48, **extra}, ids)
        assert (eng._make_cache(1, 4)["k"].dtype == torch.int8) == bool(extra)


def test_mixtral_decode_and_quant_stream_match_jax():
    """Dropless routing over int8 expert stacks: the decode logits and the
    greedy stream against the JAX v1 engine's."""
    jmodel = JaxMixtral(JaxMixtralConfig.tiny(dtype=jnp.float32, dispatch_mode="dropless",
                                              num_hidden_layers=1))
    tree, flat = _numpy_tree(jmodel)
    port = MixtralForCausalLM(MixtralConfig.tiny(num_hidden_layers=1), device="cpu")
    port.load_flat({k: torch.from_numpy(v) for k, v in flat.items()})
    ids = _prompts(256, T=14, seed=5)
    eng = _streams_and_logits(jmodel, tree, port, flat, {**CONF, **QUANT}, ids)
    stack = eng.params["layers_0/block_sparse_moe/w_gate"]
    assert stack["q"].shape == (4, 64, 128) and stack["s"].shape == (4, 64, 2, 1)
