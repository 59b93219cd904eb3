"""The KV page fabric of the port's v2 engine against the JAX engine's.

``page_payload_spec`` (shape; bytes per page), the bucketed
``fetch_pages`` -> ``put_pages`` round trip (byte-exact for f32, bf16 and
int8 pools, pow2 buckets whose pad slots touch only the scratch page), page
handoffs in both directions (a JAX ``export_kv`` payload imports into the
port byte for byte and decodes the JAX engine's greedy continuation; a port
payload imports into the JAX engine byte for byte) and
``adopt_sequence``'s refusals in the JAX package's words.

A bf16 pool's payload is numpy ``uint16`` in the port (numpy has no
bfloat16): the same bytes as the JAX engine's ``bfloat16`` array, which
``import_kv`` takes as they are.

Tolerances: page payloads byte-equal; greedy streams exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JaxSMConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import \
    BlockedAllocator as JaxAllocator
from deepspeed_tpu.inference.v2.ragged.kv_cache import BlockedKVCache as JaxKVCache
from deepspeed_tpu.inference.v2.ragged.kv_cache import KVCacheConfig as JaxKVConfig
from deepspeed_tpu.inference.v2.scheduler import DynamicSplitFuseScheduler as JaxScheduler
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache, KVCacheConfig
from deepspeed_tpu_torch.inference.v2.scheduler import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

from tests._torch_threads import one_torch_thread  # noqa: F401

LLAMA = dict(vocab_size=128, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=256)
STATE = {"max_tracked_sequences": 6, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 80, "prefill_chunk_size": 16, "max_context": 256}
POOLS = {
    "f32": ({"kv_cache": {"block_size": 8, "num_blocks": 40}}, torch.float32, jnp.float32),
    "bf16": ({"kv_cache": {"block_size": 8, "num_blocks": 40}}, torch.bfloat16,
             jnp.bfloat16),
    "int8": ({"kv_cache": {"block_size": 64, "num_blocks": 12},
              "kv_quant": {"enabled": True}}, torch.float32, jnp.float32),
}


def _params(seed=0):
    """The tiny Llama's flax tree and flat numpy tree, every leaf from numpy
    (shapes from ``jax.eval_shape``)."""
    model = JaxLlama(JaxLlamaConfig(dtype=jnp.float32, **LLAMA))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        flat[k] = (1.0 + 0.1 * noise if k.endswith("weight")
                   else noise / np.float32(np.sqrt(v.shape[-1 if "embedding" in k else 0])))
    tree = {}
    for k, a in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree, flat


@pytest.fixture(scope="module", params=sorted(POOLS))
def pair(request):
    """(pool kind, JAX engine, port engine) on the same converted weights."""
    extra, tdt, jdt = POOLS[request.param]
    params, flat = _params()
    model = JaxLlama(JaxLlamaConfig(dtype=jdt, **LLAMA))
    jax_engine = JaxEngine(model=model, model_parameters=params,
                           config={"state_manager": STATE, **extra, "dtype": jdt})
    port_model = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu", seed=1)
    port_model.load_flat(params_from_flat(flat, device="cpu"))
    port = InferenceEngineV2(port_model, {"state_manager": STATE, **extra, "dtype": tdt},
                             port_model.flat_params(), device="cpu")
    return request.param, jax_engine, port


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 128, n).astype(np.int32)


def _bytes(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def test_page_payload_spec_matches_jax(pair):
    kind, jax_engine, port = pair
    (pshape, pdt), (jshape, jdt) = port.page_payload_spec, jax_engine.page_payload_spec
    assert tuple(pshape) == tuple(jshape)
    assert np.dtype(pdt).itemsize == np.dtype(jdt).itemsize
    assert np.dtype(pdt) == {"f32": np.float32, "bf16": np.uint16, "int8": np.uint8}[kind]
    assert port.kv.config.bytes_per_block() == jax_engine.kv.config.bytes_per_block()
    if kind == "int8":
        assert pshape == (port.kv.config.bytes_per_block(),)


def test_fetch_put_round_trip_is_byte_exact(pair):
    """Three pages (a bucket of 4: one pad slot on the scratch page) out and
    back into three other slots: the same bytes; the pad slot writes zeros
    into the scratch page, and no other page changes."""
    kind, _, port = pair
    g = torch.Generator().manual_seed(3)
    kv = port.kv.kv
    if kind == "int8":
        kv.copy_(torch.randint(-127, 128, kv.shape, generator=g, dtype=torch.int8))
        port.kv.scales.copy_(torch.rand(port.kv.scales.shape, generator=g))
    else:
        kv.copy_(torch.randn(kv.shape, generator=g).to(kv.dtype))
    src, dst = [5, 2, 9], [1, 7, 3]
    pages = port.fetch_pages(src)
    shape, dtype = port.page_payload_spec
    assert pages.shape == (3,) + tuple(shape) and pages.dtype == dtype
    before_kv = kv.clone()
    port.put_pages(pages, dst)
    assert np.array_equal(_bytes(port.fetch_pages(dst)), _bytes(pages))
    assert np.array_equal(_bytes(port.fetch_page(dst[1])), _bytes(pages[1]))
    scratch = port.scratch_block
    assert int(kv[:, scratch].abs().sum()) == 0
    untouched = [b for b in range(kv.shape[1]) if b not in dst + [scratch]]
    assert torch.equal(kv[:, untouched], before_kv[:, untouched])
    port.put_page(pages[0], 11)
    assert np.array_equal(_bytes(port.fetch_page(11)), _bytes(pages[0]))
    kv.zero_()
    if port.kv.scales is not None:
        port.kv.scales.zero_()


def test_jax_export_imports_into_port_and_decodes_its_continuation(pair):
    """A prompt prefilled by the JAX engine and exported (pages + last
    logits) imports into the port byte for byte; the port's greedy burst on
    it equals the JAX engine's on its own re-import."""
    kind, jax_engine, port = pair
    prompt = _prompt(7, 70)
    jax_engine.put([0], [prompt])
    pages, logits = jax_engine.export_kv(0)
    if kind == "bf16":
        assert pages.dtype.name == "bfloat16"          # ml_dtypes, on the JAX side
    jax_engine.import_kv(1, prompt, pages, logits)
    ref = np.asarray(jax_engine.decode_steps([1], 6))
    ids = port.import_kv(5, prompt, pages, logits)
    assert len(ids) == len(pages) and port.scheduler.seqs[5].seen_tokens == 70
    assert np.array_equal(_bytes(port.fetch_pages(ids)), _bytes(pages))
    assert port.decode_steps([5], 6).tolist() == ref.tolist()
    for e, u in ((jax_engine, 1), (port, 5)):
        e.flush([u])


def test_port_export_imports_into_jax_byte_for_byte(pair):
    kind, jax_engine, port = pair
    prompt = _prompt(8, 40)
    port.put([2], [prompt])
    pages, logits = port.export_kv(2)
    assert 2 not in port.scheduler.seqs
    payload = pages.view(jnp.bfloat16) if kind == "bf16" else pages
    ids = jax_engine.import_kv(3, prompt, payload, logits)
    assert np.array_equal(_bytes(jax_engine.fetch_pages(ids)), _bytes(pages))
    jax_engine.flush([3])


def test_import_kv_refuses_another_layout(pair):
    _, jax_engine, port = pair
    shape, dtype = port.page_payload_spec
    bad = np.zeros((1,) + tuple(s + 1 for s in shape), dtype)
    for e in (jax_engine, port):
        with pytest.raises(ValueError, match="does not match this engine's KV page layout"):
            e.import_kv(9, [1, 2], bad, np.zeros(128, np.float32))


# --------------------------------------------------------------------- #
# adopt_sequence against the JAX scheduler
# --------------------------------------------------------------------- #

def _schedulers(window=None, nb=6):
    kw = dict(max_tracked_sequences=2, max_ragged_sequence_count=2,
              max_ragged_batch_size=34, max_context=40, prefill_chunk_size=8)
    kv = dict(num_layers=1, num_kv_heads=1, head_dim=8, block_size=8, num_blocks=nb + 1)
    jsc = JaxScheduler(JaxSMConfig(**kw), JaxKVCache(JaxKVConfig(**kv)), JaxAllocator(nb))
    psc = DynamicSplitFuseScheduler(DSStateManagerConfig(**kw),
                                    BlockedKVCache(KVCacheConfig(**kv), "cpu"),
                                    BlockedAllocator(nb))
    jsc.window = psc.window = window
    return jsc, psc


def _same_refusal(scheds, call):
    """``call`` raises the same exception type and message on the JAX
    scheduler and the port's."""
    errors = []
    for sched in scheds:
        with pytest.raises(Exception) as info:
            call(sched)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1], errors


def test_adopt_sequence_matches_jax_and_refuses_in_its_words():
    scheds = _schedulers()
    for s in scheds:
        assert list(map(int, s.adopt_sequence(4, np.arange(10), 2))) == [0, 1]
        assert s.seqs[4].seen_tokens == 10 and s.allocator.free_blocks == 4
    _same_refusal(scheds, lambda s: s.adopt_sequence(4, np.arange(3), 1))    # tracked
    _same_refusal(scheds, lambda s: s.adopt_sequence(5, np.arange(0), 1))    # no token
    _same_refusal(scheds, lambda s: s.adopt_sequence(5, np.arange(41), 6))   # > max_context
    _same_refusal(scheds, lambda s: s.adopt_sequence(5, np.arange(20), 2))   # pages too few
    _same_refusal(scheds, lambda s: s.adopt_sequence(5, np.arange(20), 5))   # pool short
    for s in scheds:
        s.adopt_sequence(5, np.arange(3), 1)
    _same_refusal(scheds, lambda s: s.adopt_sequence(6, np.arange(3), 1))    # slots full
    ringed = _schedulers(window=16)
    _same_refusal(ringed, lambda s: s.adopt_sequence(1, np.arange(3), 1))    # page ring
    with pytest.raises(NotImplementedError, match="sliding-window page ring"):
        ringed[1].adopt_sequence(1, np.arange(3), 1)
