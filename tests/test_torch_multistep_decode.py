"""Burst decode (``decode_steps``) in the port against its own per-token loop,
its dense model and the JAX engine.

Mirrors ``tests/unit/test_multistep_decode.py`` (the burst equals the
``sample_next`` + ``put`` loop and its next sample; ``put`` continues after a
burst; a burst crosses a page boundary; the side-buffer burst at D = 128
follows the dense model's greedy continuation, and so does a second burst
after the flush), then holds the port's bursts against the JAX engine's
``decode_steps`` on converted weights: f32 pools at split rungs 1/2/4, an
int8 pool, ALiBi (a tiny BLOOM at D = 64) and a window smaller than the
burst (``tests/unit/test_window_serving.py:116``, with the ring bound). The
per-step-write loop (``max_side_bytes=0``), the slab flush's int8 bytes and
the pad rows' page footprint are checked within the port.

Tolerances: greedy streams exactly equal; final logits 1e-4 absolute in f32
(the engines' logits tolerance in ``test_torch_window_serving.py``), and
1e-3 over int8 pages: the two packages' K/V rows agree to f32 rounding,
which may cross an int8 rounding edge (``test_torch_quant_serving.py``
holds such pages within one int8 step), and one step moved the final
logits by 1.8e-4 here; the slab flush's bytes exactly equal to per-step
writes of the same rows.
Test parameters come from ``jax.eval_shape`` plus numpy (a jitted flax
``init`` costs seconds per model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import decoder as jdec
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.attention import write_token_rows
from deepspeed_tpu_torch.inference.v2.ragged_model import (flush_side_slab,
                                                           multistep_schedule)
from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_write_dequant, scale_tile_rows
from deepspeed_tpu_torch.utils.caching import LRUCache

from tests._torch_threads import one_torch_thread  # noqa: F401

LOGITS_ATOL = 1e-4
INT8_LOGITS_ATOL = 1e-3
LLAMA = dict(vocab_size=128, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=128)
STATE = {"max_tracked_sequences": 8, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 80, "prefill_chunk_size": 16, "max_context": 128}
ENGINE = {"state_manager": STATE, "kv_cache": {"block_size": 8},
          "attention": {"decode_splits": 4, "min_ctx_per_split": 16}}
PROMPTS = [np.array([3, 14, 15, 92, 6], np.int32),
           np.array([27, 18, 28, 18], np.int32),
           np.array([31, 41, 59, 26, 53, 58], np.int32)]


def _random_flax(model, seed):
    """(params, flat numpy tree) with every leaf drawn from numpy: norm
    scales near 1, embeddings and kernels at unit-variance outputs."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        if k.endswith(("scale", "weight")):
            flat[k] = 1.0 + 0.1 * noise
        elif k.endswith("embedding"):
            flat[k] = noise / np.float32(np.sqrt(v.shape[1]))
        elif k.endswith("kernel") or v.ndim == 2:
            flat[k] = noise / np.float32(np.sqrt(v.shape[0]))
        else:
            flat[k] = 0.05 * noise
    tree = {}
    for k, a in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree, flat


def _llama_pair(conf, seed=0, **cfg_kw):
    """A JAX engine and the port's on the same converted tiny Llama."""
    cfg = {**LLAMA, **cfg_kw}
    model = JaxLlama(JaxLlamaConfig(dtype=jnp.float32, **cfg))
    params, flat = _random_flax(model, seed)
    jax_engine = JaxEngine(model=model, model_parameters=params,
                           config={**conf, "dtype": jnp.float32})
    port_model = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu", seed=1)
    port_model.load_flat(params_from_flat(flat, device="cpu"))
    port_engine = InferenceEngineV2(port_model, {**conf, "dtype": torch.float32},
                                    port_model.flat_params(), device="cpu")
    return jax_engine, port_engine, port_model


def _close(port, ref, atol=LOGITS_ATOL):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               rtol=0, atol=atol)


def _last_logits(engine, uids):
    engine._materialize(uids)
    return np.stack([engine._last_logits[u] for u in uids])


def _loop_decode(engine, uids, n):
    outs = [[] for _ in uids]
    for _ in range(n):
        ids = engine.sample_next(uids)
        for i, t in enumerate(ids):
            outs[i].append(int(t))
        engine.put(uids, [np.asarray([t], np.int32) for t in ids])
    return outs


def _general(engine, n_steps, bucket, rung=1):
    """Route the engine's next ``n_steps`` burst at ``bucket`` rows and
    ``rung`` to the per-step-write loop (``max_side_bytes=0``)."""
    engine._multistep = LRUCache(maxsize=8)
    engine._multistep.get_or_create(
        (n_steps, bucket, False, 0, rung),
        lambda: engine._build_multistep(n_steps, False, 0, rung, max_side_bytes=0))


@pytest.fixture(scope="module")
def llama():
    return _llama_pair(ENGINE)


# --------------------------------------------------------------------- #
# the JAX package's multistep tests, in the port and against the JAX engine
# --------------------------------------------------------------------- #

def test_burst_matches_put_loop_and_jax(llama):
    """The burst equals the sample_next + put loop, its next sample too, and
    the JAX engine's decode_steps (tokens equal, final logits at 1e-4)."""
    jax_engine, port, _ = llama
    n = 7
    port.put([0, 1, 2], PROMPTS)
    ref = _loop_decode(port, [0, 1, 2], n)
    ref_next = port.sample_next([0, 1, 2])
    port.put([3, 4, 5], PROMPTS)
    assert multistep_schedule(port.spec, n, 4) == "sidebuf"
    got = port.decode_steps([3, 4, 5], n)
    assert got.shape == (3, n) and got.tolist() == ref
    assert port.sample_next([3, 4, 5]).tolist() == ref_next.tolist()
    jax_engine.put([3, 4, 5], PROMPTS)
    jref = jax_engine.decode_steps([3, 4, 5], n)
    assert got.tolist() == np.asarray(jref).tolist()
    _close(_last_logits(port, [3, 4, 5]), _last_logits(jax_engine, [3, 4, 5]))
    for u in range(6):
        assert port.scheduler.seqs[u].seen_tokens == len(PROMPTS[u % 3]) + n
    for e in (port, jax_engine):
        e.flush(range(6))


def test_burst_then_put_continues(llama):
    _, port, _ = llama
    uids = [0, 1]
    port.put(uids, PROMPTS[:2])
    first = port.decode_steps(uids, 3)
    nxt = port.sample_next(uids)
    logits = port.put(uids, [np.asarray([t], np.int32) for t in nxt])
    assert first.shape == (2, 3) and logits.shape[0] == 2
    second = port.decode_steps(uids, 2)
    assert second.shape == (2, 2)
    for u, p in zip(uids, PROMPTS[:2]):
        assert port.scheduler.seqs[u].seen_tokens == len(p) + 3 + 1 + 2
    port.flush(uids)


def test_burst_across_page_boundary_matches_loop_and_jax(llama):
    """12 prompt tokens, pages of 8: ten steps cross the 16-token page."""
    jax_engine, port, _ = llama
    prompt = [np.arange(12, dtype=np.int32)]
    port.put([0], prompt)
    ref = _loop_decode(port, [0], 10)
    port.put([1], prompt)
    got = port.decode_steps([1], 10)
    assert got[0].tolist() == ref[0]
    jax_engine.put([1], prompt)
    assert got.tolist() == np.asarray(jax_engine.decode_steps([1], 10)).tolist()
    _close(_last_logits(port, [1]), _last_logits(jax_engine, [1]))
    for e in (port, jax_engine):
        e.flush([0, 1])


def test_sidebuf_burst_matches_dense_model(llama):
    """D = 128: the side-buffer burst follows the dense model's greedy
    continuation across page boundaries, and a second burst after the
    flush continues it."""
    _, port, model = llama
    assert port.spec.head_dim == 128
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 128, size=(n,)).astype(np.int32) for n in (9, 16, 23)]
    uids = [1, 2, 3]
    port.put(uids, prompts)
    ids = port.decode_steps(uids, 20)
    ids2 = port.decode_steps(uids, 6)
    for i, prompt in enumerate(prompts):
        # one causal forward over prompt + both bursts: row p's argmax is the
        # greedy continuation of the first p + 1 tokens
        seq = np.concatenate([prompt, ids[i], ids2[i]])
        lg = model.forward_logits(torch.from_numpy(seq).long()[None])[0]
        greedy = torch.argmax(lg[len(prompt) - 1:-1], dim=-1).numpy()
        assert greedy.tolist() == seq[len(prompt):].tolist()
    port.flush(uids)


@pytest.mark.parametrize("rung", [2, 4])
def test_burst_at_pinned_rung_matches_jax(llama, rung):
    """K7's side piece at 2 and 4 splits: tokens equal to rung 1's and to
    the JAX engine's at the same rung, final logits at 1e-4."""
    jax_engine, port, _ = llama
    rng = np.random.RandomState(rung)
    prompts = [rng.randint(0, 128, size=(n,)).astype(np.int32) for n in (40, 17, 6)]
    try:
        port.put([0, 1, 2], prompts)
        base = port.decode_steps([0, 1, 2], 12)
        jax_engine.attn_rung_override = port.attn_rung_override = rung
        port.attn_stats.reset()
        port.put([3, 4, 5], prompts)
        got = port.decode_steps([3, 4, 5], 12)
        assert port.attn_stats.rungs == {rung: 1}
        assert got.tolist() == base.tolist()
        jax_engine.put([3, 4, 5], prompts)
        assert got.tolist() == np.asarray(jax_engine.decode_steps([3, 4, 5], 12)).tolist()
        _close(_last_logits(port, [3, 4, 5]), _last_logits(jax_engine, [3, 4, 5]))
    finally:
        jax_engine.attn_rung_override = port.attn_rung_override = None
        for e in (port, jax_engine):
            e.flush(range(6))


def test_per_step_write_loop_matches_sidebuf(llama):
    """max_side_bytes=0 routes the burst to the per-step-write loop: the
    same tokens and final logits as the side-buffer burst, and pages of the
    same values (the current token's column sits elsewhere in each softmax
    sum, so f32 association noise only)."""
    _, port, _ = llama
    assert multistep_schedule(port.spec, 9, 4, max_side_bytes=0) == "general"
    try:
        for rung in (1, 2):
            port.attn_rung_override = rung
            port.put([0, 1, 2], PROMPTS)
            side = port.decode_steps([0, 1, 2], 9)
            port.put([3, 4, 5], PROMPTS)
            _general(port, 9, 4, rung)
            general = port.decode_steps([3, 4, 5], 9)
            assert general.tolist() == side.tolist()
            _close(_last_logits(port, [3, 4, 5]), _last_logits(port, [0, 1, 2]), atol=1e-5)
            a = port.fetch_pages([b for u in (0, 1, 2) for b in port.scheduler.seqs[u].blocks])
            b = port.fetch_pages([b for u in (3, 4, 5) for b in port.scheduler.seqs[u].blocks])
            _close(a, b, atol=1e-5)
            port.flush(range(6))
    finally:
        port.attn_rung_override = None
        port._multistep = LRUCache(maxsize=8)


def test_pad_rows_touch_only_the_scratch_page(llama):
    """Three live rows run at a bucket of 4: the pad row decodes on the
    scratch page, so no page but the live rows' and the scratch page
    changes (another sequence's pages included)."""
    _, port, _ = llama
    port.put([0, 1, 2, 7], PROMPTS + [np.arange(20, dtype=np.int32)])
    before = port.kv.kv.clone()
    port.decode_steps([0, 1, 2], 11)
    mine = {b for u in (0, 1, 2) for b in port.scheduler.seqs[u].blocks}
    changed = {int(p) for p in torch.nonzero(
        (port.kv.kv != before).flatten(2).any(-1).any(0)).flatten()}
    assert changed - mine == {port.scratch_block}
    port.flush([0, 1, 2, 7])


# --------------------------------------------------------------------- #
# int8 pool: the f32 slab and its flush
# --------------------------------------------------------------------- #

def test_slab_flush_stores_per_step_write_bytes():
    """The flush re-quantizes the slab's kv_write_dequant rows (f32) to the
    int8 bytes and scale tiles that per-step writes of the raw rows store,
    at positions that cross pages."""
    rng = np.random.RandomState(3)
    L, NB, Hkv, bs, D, S, C = 2, 9, 2, 64, 128, 2, 5
    k = torch.from_numpy(rng.randn(L, S, C, Hkv, D).astype(np.float32) * 3)
    v = torch.from_numpy(rng.randn(L, S, C, Hkv, D).astype(np.float32))
    bt = torch.tensor([[4, 2, 7], [1, 5, 0]], dtype=torch.int32)
    prefix = torch.tensor([61, 3], dtype=torch.int32)
    r8 = scale_tile_rows(Hkv, bs)
    pools = [torch.zeros(L, NB, 2, Hkv, bs, D, dtype=torch.int8) for _ in range(2)]
    tiles = [torch.zeros(L, NB, r8, 128) for _ in range(2)]
    flush_side_slab(pools[0], kv_write_dequant(k).reshape(L, S, C * Hkv, D),
                    kv_write_dequant(v).reshape(L, S, C * Hkv, D), bt, prefix, tiles[0])
    for l in range(L):
        for c in range(C):
            write_token_rows(pools[1][l], k[l, :, c], v[l, :, c], bt, prefix + c, tiles[1][l])
    assert torch.equal(pools[0], pools[1]) and torch.equal(tiles[0], tiles[1])
    assert int(pools[0].ne(0).sum()) > 0


INT8_ENGINE = {"state_manager": {**STATE, "max_context": 256},
               "kv_cache": {"block_size": 64}, "quantization": {"weight_bits": 8},
               "kv_quant": {"enabled": True},
               "attention": {"decode_splits": 4, "min_ctx_per_split": 16}}


def test_int8_burst_matches_jax_and_per_step_loop():
    """int8 weights and pages (f32 slab): tokens equal to the JAX engine's
    burst, final logits at 1e-3; the per-step-write loop gives the same
    tokens, final logits and page bytes."""
    jax_engine, port, _ = _llama_pair(INT8_ENGINE, seed=2, hidden_size=512,
                                      num_attention_heads=4)
    assert port.kv.scales is not None and port.spec.head_dim == 128
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 128, size=(n,)).astype(np.int32) for n in (70, 33, 9)]
    port.put([0, 1, 2], prompts)
    got = port.decode_steps([0, 1, 2], 10)
    jax_engine.put([0, 1, 2], prompts)
    assert got.tolist() == np.asarray(jax_engine.decode_steps([0, 1, 2], 10)).tolist()
    _close(_last_logits(port, [0, 1, 2]), _last_logits(jax_engine, [0, 1, 2]),
           atol=INT8_LOGITS_ATOL)
    port.put([3, 4, 5], prompts)
    _general(port, 10, 4)
    assert port.decode_steps([3, 4, 5], 10).tolist() == got.tolist()
    _close(_last_logits(port, [3, 4, 5]), _last_logits(port, [0, 1, 2]), atol=1e-5)
    pages = [port.fetch_pages([b for u in us for b in port.scheduler.seqs[u].blocks])
             for us in ((0, 1, 2), (3, 4, 5))]
    assert pages[0].dtype == np.uint8 and np.array_equal(pages[0], pages[1])
    port._multistep = LRUCache(maxsize=8)


# --------------------------------------------------------------------- #
# ALiBi and the sliding window
# --------------------------------------------------------------------- #

def test_alibi_burst_matches_jax():
    """A tiny BLOOM at D = 64: the ALiBi side rows sit at prefix + cc; at
    rungs 1 and 2, tokens equal to the JAX engine's and final logits at
    1e-4."""
    kw = dict(hidden_size=256, num_attention_heads=4)
    model = jdec.DecoderLM(jdec.DecoderConfig.tiny("bloom", dtype=jnp.float32, **kw))
    params, flat = _random_flax(model, 4)
    conf = {**ENGINE, "state_manager": {**STATE, "max_context": 120}}
    jax_engine = JaxEngine(model=model, model_parameters=params,
                           config={**conf, "dtype": jnp.float32})
    port_model = DecoderLM(DecoderConfig.tiny("bloom", **kw), device="cpu", seed=1)
    port_model.load_flat(params_from_flat(flat, device="cpu"))
    port = InferenceEngineV2(port_model, {**conf, "dtype": torch.float32},
                             port_model.flat_params(), device="cpu")
    assert port.spec.alibi and port.spec.head_dim == 64
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 256, size=(n,)).astype(np.int32) for n in (50, 21, 7)]
    for rung in (1, 2):
        jax_engine.attn_rung_override = port.attn_rung_override = rung
        port.put([0, 1, 2], prompts)
        jax_engine.put([0, 1, 2], prompts)
        got = port.decode_steps([0, 1, 2], 12)
        assert got.tolist() == np.asarray(jax_engine.decode_steps([0, 1, 2], 12)).tolist()
        _close(_last_logits(port, [0, 1, 2]), _last_logits(jax_engine, [0, 1, 2]))
        for e in (port, jax_engine):
            e.flush([0, 1, 2])


def test_window_burst_longer_than_window_matches_jax_and_ring_bound():
    """Window 16, pages of 8 (take cap 24): a 20-step burst (j >= window
    inside the slab) takes the side-buffer schedule and a 30-step one the
    per-step-write loop, as in the JAX engine; tokens equal to its, final
    logits at 1e-4, and no sequence holds more than ring_pages pages."""
    conf = {"state_manager": {"max_tracked_sequences": 4, "max_ragged_sequence_count": 4,
                              "max_ragged_batch_size": 40, "prefill_chunk_size": 8,
                              "max_context": 128},
            "kv_cache": {"block_size": 8}}
    jax_engine, port, _ = _llama_pair(conf, seed=7, sliding_window=16)
    sched = port.scheduler
    assert port.spec.window == 16 and sched.ring_pages == jax_engine.scheduler.ring_pages
    rng = np.random.RandomState(4)
    prompt = [rng.randint(0, 128, size=(40,)).astype(np.int32)]
    for uid, n in ((1, 20), (2, 30)):
        want = "sidebuf" if sched.ring_covers(n + 1) else "general"
        assert multistep_schedule(port.spec, n, 1, sched.ring_covers(n + 1)) == want
        port.put([uid], prompt)
        jax_engine.put([uid], prompt)
        got = port.decode_steps([uid], n)
        assert got.tolist() == np.asarray(jax_engine.decode_steps([uid], n)).tolist()
        _close(_last_logits(port, [uid]), _last_logits(jax_engine, [uid]))
        assert len(set(sched.seqs[uid].blocks)) <= sched.ring_pages
        assert sched.seqs[uid].blocks == list(map(int, jax_engine.scheduler.seqs[uid].blocks))
    assert not sched.ring_covers(31) and sched.ring_covers(21)
