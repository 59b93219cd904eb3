"""The port's prefix cache (``inference/v2/prefix_cache.py``, the
scheduler's hooks, ``BlockedKVCache.copy_page``) against the JAX
package's.

Mirrors the tree and scheduler tests of ``tests/unit/test_prefix_cache.py``
on the port's copy (hit, miss, the cap below the full prompt, COW adoption,
deduplicated release, LRU order with parent exposure, shared pages never
evicted, the COW allocation under pressure, the eager insert, the sealed
history), runs one scripted sequence of match, insert, release and evict
through both packages' ``RadixPrefixCache`` (equal matches, refcounts and
eviction order), and serves a tiny fp32 Llama carried across with the
converter: cache-on logits against cache-off logits and against the JAX
engine's cache-on logits, COW adoption copying an int8 page's scale tile,
and the sliding-window refusal in the JAX package's words.

Tolerances: tree state exactly equal; cache-on against cache-off logits
within rtol 1e-5 of the row's largest |logit| (the hit's continuation
pass runs the chunk kernel's plain version where the cache-off prompt runs
the packed kernel's, so f32 association differs; where they are bitwise
equal the test says so by asserting nothing looser); the port against the
JAX engine 1e-4 absolute in f32 (the engines' tolerance in
``test_torch_window_serving.py``); a COW copy byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.attention import AttentionKernelSpec as JaxAttention
from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.prefix_cache import RadixPrefixCache as JaxRadix
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import \
    BlockedAllocator as JaxAllocator
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.config_v2 import (DSStateManagerConfig,
                                                        PrefixCacheConfig)
from deepspeed_tpu_torch.inference.v2.prefix_cache import RadixPrefixCache
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache, KVCacheConfig
from deepspeed_tpu_torch.inference.v2.scheduler import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

from tests._torch_threads import one_torch_thread  # noqa: F401

BS = 8
RTOL = 1e-5
LOGITS_ATOL = 1e-4


def _toks(*vals):
    return np.asarray(vals, np.int32)


# --------------------------------------------------------------------- #
# the radix tree alone (tests/unit/test_prefix_cache.py:40-231)
# --------------------------------------------------------------------- #

def _cache(nb=32, **kw):
    alloc = BlockedAllocator(nb)
    return RadixPrefixCache(alloc, BS, **kw), alloc


def test_miss_on_empty_tree():
    cache, _ = _cache()
    m = cache.match(np.arange(20))
    assert m.blocks == [] and m.n_cached == 0
    assert cache.stats.misses == 1 and cache.stats.hits == 0


def test_full_block_hit_and_refcounts():
    cache, alloc = _cache()
    toks = np.arange(20)                       # 2 full pages + 4 tail
    blocks = alloc.allocate(3).tolist()
    assert cache.release(toks, blocks) == []
    assert cache.cached_blocks == 3            # 2 full + 1 partial leaf
    assert all(alloc.ref_count(b) == 1 for b in blocks)
    m = cache.match(toks)
    assert m.blocks == blocks[:2] and m.n_cached == 16
    assert alloc.ref_count(blocks[0]) == 2
    alloc.free(m.blocks)
    assert alloc.ref_count(blocks[0]) == 1


def test_match_is_capped_below_full_prompt():
    cache, alloc = _cache()
    toks = np.arange(16)                       # exactly 2 pages
    cache.release(toks, alloc.allocate(2).tolist())
    m = cache.match(toks)
    assert m.n_cached == 8                     # the last page is not matched
    alloc.free(m.blocks)


def test_divergent_prompt_matches_common_prefix_only():
    cache, alloc = _cache()
    cache.release(np.arange(24), alloc.allocate(3).tolist())
    b = np.concatenate([np.arange(8), _toks(99, 98, 97, 96, 95, 94, 93, 92), np.arange(8)])
    m = cache.match(b)
    assert m.n_cached == 8
    alloc.free(m.blocks)


def test_partial_leaf_cow_adoption():
    copies = []
    cache, alloc = _cache(cow_fn=lambda s, d: copies.append((s, d)))
    blocks = alloc.allocate(2).tolist()
    cache.release(np.arange(12), blocks)       # 1 full page + 4 tail
    m = cache.match(np.arange(20))
    assert m.n_cached == 12 and m.cow
    assert copies == [(blocks[1], m.blocks[-1])]
    assert m.blocks[-1] != blocks[1]
    assert alloc.ref_count(m.blocks[-1]) == 1
    assert alloc.ref_count(blocks[1]) == 1
    assert cache.stats.partial_hits == 1 and cache.stats.cow_copies == 1


def test_release_dedupes_already_cached_content():
    cache, alloc = _cache()
    toks = np.arange(16)
    cache.release(toks, alloc.allocate(2).tolist())
    dup = alloc.allocate(2).tolist()
    assert sorted(cache.release(toks, dup)) == sorted(dup)
    assert cache.cached_blocks == 2


def test_lru_eviction_order_and_parent_exposure():
    cache, alloc = _cache()
    a = np.arange(17)
    b = np.concatenate([_toks(*range(50, 58)), _toks(*range(70, 78))])
    cache.release(a[:16], alloc.allocate(2).tolist())
    cache.release(b, alloc.allocate(2).tolist())
    m = cache.match(a)
    assert m.n_cached == 16
    alloc.free(m.blocks)
    assert cache.evictable_blocks == 4
    assert cache.evict(2) == 2                 # path B, leaf first
    m2 = cache.match(a)
    assert m2.n_cached == 16
    alloc.free(m2.blocks)
    assert cache.match(b).n_cached == 0
    assert cache.evict(10) == 2
    assert cache.cached_blocks == 0


def test_fresh_partial_tail_is_not_the_lru_victim():
    cache, alloc = _cache()
    old = _toks(*range(100, 109))
    cache.release(old, alloc.allocate(1).tolist())
    cache.release(np.arange(12), alloc.allocate(2).tolist())
    assert cache.evict(1) == 1
    m = cache.match(np.arange(12))
    assert m.n_cached == 8
    alloc.free(m.blocks)
    assert cache.match(old).n_cached == 0


def test_eviction_never_touches_shared_blocks():
    cache, alloc = _cache()
    blocks = alloc.allocate(2).tolist()
    cache.release(np.arange(16), blocks)
    m = cache.match(np.arange(16))
    assert cache.evict(10) == 1
    assert alloc.ref_count(m.blocks[0]) == 2
    alloc.free(m.blocks)
    assert cache.evict(10) == 1
    assert alloc.free_blocks == alloc.total_blocks


def test_cow_allocation_pressure_cannot_evict_match_or_source():
    copies = []
    alloc = BlockedAllocator(3)
    cache = RadixPrefixCache(alloc, BS, cow_fn=lambda s, d: copies.append((s, d)))
    a_blocks = alloc.allocate(2).tolist()
    cache.release(np.arange(12), a_blocks)
    cache.release(_toks(*range(200, 208)), alloc.allocate(1).tolist())
    assert alloc.free_blocks == 0
    m = cache.match(np.arange(20))
    assert m.n_cached == 12 and m.cow
    assert copies and copies[0][0] == a_blocks[1]
    assert m.blocks[0] == a_blocks[0]
    assert cache.stats.evictions == 1
    assert alloc.ref_count(a_blocks[0]) == 2
    assert alloc.ref_count(a_blocks[1]) == 1
    alloc.free(m.blocks)


def test_evictable_excludes_interior_pinned_under_shared_child():
    cache, alloc = _cache(nb=3)
    b1, b2 = alloc.allocate(2).tolist()
    cache.release(np.arange(16), [b1, b2])
    c = int(alloc.allocate(1)[0])
    cache.insert(np.arange(24), [b1, b2, c], transfer_refs=False)
    assert alloc.ref_count(c) == 2
    assert cache.evictable_blocks == 0
    assert cache.evict(3) == 0
    alloc.free([c])
    assert cache.evictable_blocks == 3
    assert cache.evict(3) == 3
    assert alloc.free_blocks == alloc.total_blocks


def test_max_cached_blocks_cap():
    cache, alloc = _cache(max_cached_blocks=2)
    cache.release(np.arange(16), alloc.allocate(2).tolist())
    cache.release(_toks(*range(100, 124)), alloc.allocate(3).tolist())
    assert cache.cached_blocks <= 2
    assert cache.stats.evictions >= 3


def test_refcount_never_negative_through_lifecycle():
    cache, alloc = _cache()
    toks = np.arange(24)
    cache.release(toks, alloc.allocate(3).tolist())
    for _ in range(3):
        alloc.free(cache.match(toks).blocks)
    cache.evict(10)
    assert alloc.free_blocks == alloc.total_blocks
    with pytest.raises(ValueError):
        alloc.free([0])


def test_listeners_and_match_len_and_weight_version():
    events = []
    cache, alloc = _cache()
    cache.add_listener(lambda op, chain: events.append(op))
    cache.release(np.arange(20), alloc.allocate(3).tolist())
    assert events == ["insert", "insert"]      # the partial leaf is not routable
    assert cache.match_len(np.arange(20)) == 16 and cache.stats.lookups == 0
    assert cache.set_weight_version(1) == 3
    assert events == ["insert", "insert", "evict", "evict"]
    assert cache.match(np.arange(20)).n_cached == 0
    assert alloc.free_blocks == alloc.total_blocks


# --------------------------------------------------------------------- #
# one scripted sequence through both packages' trees
# --------------------------------------------------------------------- #

def _script(cache_cls, alloc_cls):
    """match / insert / release / evict on one package's tree; returns what
    each step observed: matches, the refcount of every page, the free
    list's order (eviction order included) and the stats."""
    alloc = alloc_cls(12)
    copies = []
    cache = cache_cls(alloc, BS, max_cached_blocks=9,
                      cow_fn=lambda s, d: copies.append((s, d)))
    seen = []

    def snap(tag, extra=None):
        seen.append((tag, extra, [alloc.ref_count(b) for b in range(12)],
                     list(alloc._free), cache.cached_blocks, cache.evictable_blocks))

    a = np.arange(21)                           # 2 full pages + 5 tail
    b = np.concatenate([np.arange(8), _toks(*range(60, 76))])
    c = _toks(*range(100, 117))
    cache.release(a, [int(x) for x in alloc.allocate(3)])
    snap("release a")
    m = cache.match(np.concatenate([a, _toks(7, 7, 7)]))
    snap("match a+", (m.blocks, m.n_cached, m.cow))
    live = [int(x) for x in alloc.allocate(2)]
    cache.insert(b, m.blocks[:1] + live, transfer_refs=False)
    snap("eager insert b")
    cache.release(c, [int(x) for x in alloc.allocate(3)])
    snap("release c")
    alloc.free(m.blocks)
    snap("drop a+")
    m2 = cache.match(b)
    snap("match b", (m2.blocks, m2.n_cached, m2.cow))
    alloc.free(m2.blocks)
    alloc.free(live)
    snap("drop b")
    for n in (1, 2, 3, 20):
        snap("evict", cache.evict(n))
    st = cache.stats
    return seen, copies, (st.lookups, st.hits, st.misses, st.matched_blocks,
                          st.partial_hits, st.tokens_saved, st.tokens_requested,
                          st.insertions, st.evictions, st.cow_copies)


def test_scripted_tree_matches_jax():
    port = _script(RadixPrefixCache, BlockedAllocator)
    ref = _script(JaxRadix, JaxAllocator)
    assert port == ref
    assert port[1] and port[2][-2] > 0         # a COW copy and evictions ran


# --------------------------------------------------------------------- #
# the scheduler's hooks (tests/unit/test_prefix_cache.py:234-320)
# --------------------------------------------------------------------- #

def _sched(num_blocks=32, **cache_kw):
    cfg = DSStateManagerConfig(max_tracked_sequences=8, max_ragged_sequence_count=4,
                               max_ragged_batch_size=20, max_context=64,
                               prefill_chunk_size=8)
    kv = BlockedKVCache(KVCacheConfig(num_layers=1, num_kv_heads=1, head_dim=8,
                                      block_size=BS, num_blocks=num_blocks,
                                      dtype=torch.float32), "cpu")
    alloc = BlockedAllocator(num_blocks)
    cache = RadixPrefixCache(alloc, BS, **cache_kw)
    return DynamicSplitFuseScheduler(cfg, kv, alloc, prefix_cache=cache), alloc, cache


def _drain(sched):
    while sched.has_pending():
        sched.complete_pass(sched.schedule_pass())


def test_admission_attaches_cached_blocks_and_skips_prefill():
    sched, _, _ = _sched()
    prompt = np.arange(20, dtype=np.int32)
    sched.add_tokens(1, prompt)
    _drain(sched)
    sched.flush(1)
    sched.add_tokens(2, prompt)
    seq = sched.seqs[2]
    assert seq.seen_tokens == 16 and seq.cached_tokens == 16 and len(seq.pending) == 4
    before = sched.prefill_tokens_completed
    _drain(sched)
    assert sched.prefill_tokens_completed - before == 4
    sched.flush(2)


def test_eager_insert_shares_before_flush():
    sched, _, cache = _sched()
    prompt = np.arange(20, dtype=np.int32)
    sched.add_tokens(1, prompt)
    _drain(sched)
    assert cache.cached_blocks == 2
    sched.add_tokens(2, prompt)
    assert sched.seqs[2].seen_tokens == 16
    assert sched.seqs[2].blocks[:2] == sched.seqs[1].blocks[:2]
    _drain(sched)
    sched.flush(1)
    sched.flush(2)


def test_flush_releases_to_tree_not_free_list():
    sched, alloc, cache = _sched()
    sched.add_tokens(1, np.arange(20, dtype=np.int32))
    _drain(sched)
    used = alloc.total_blocks - alloc.free_blocks
    sched.flush(1)
    assert alloc.total_blocks - alloc.free_blocks == used
    assert cache.evictable_blocks == used


def test_allocation_pressure_evicts_idle_cached_blocks():
    sched, alloc, cache = _sched(num_blocks=4)
    sched.add_tokens(1, np.arange(20, dtype=np.int32))
    _drain(sched)
    sched.flush(1)
    assert alloc.free_blocks == 1
    assert sched.can_schedule([2], [30])
    sched.add_tokens(2, _toks(*range(100, 130)))
    _drain(sched)
    assert cache.stats.evictions >= 2
    sched.flush(2)


def test_device_generated_gap_seals_cacheable_history():
    sched, alloc, cache = _sched()
    sched.add_tokens(1, np.arange(16, dtype=np.int32))
    _drain(sched)
    seq = sched.seqs[1]
    sched.reserve(1, 9)
    sched.advance(1, 8)                        # device tokens, unrecorded
    for t in (101, 102):
        sched.add_tokens(1, _toks(t))
        _drain(sched)
    assert seq.history_valid == 16
    assert sched._cacheable_tokens(seq) == 16
    sched.flush(1)
    assert cache.cached_blocks == 2
    m = cache.match(np.arange(24))
    assert m.n_cached == 16
    alloc.free(m.blocks)


def test_refcounts_settle_after_many_sharers():
    sched, alloc, cache = _sched()
    prompt = np.arange(33, dtype=np.int32)
    for uid in range(5):
        sched.add_tokens(uid, prompt)
        _drain(sched)
    for uid in range(5):
        sched.flush(uid)
    assert cache.evictable_blocks == cache.cached_blocks
    cache.evict(alloc.total_blocks)
    assert alloc.free_blocks == alloc.total_blocks


def test_admission_shares_a_whole_page_prefix():
    # a matched prefix attaches as shared pages (refcount 2: the tree and
    # the sequence) ahead of the sequence's own fresh ones (refcount 1)
    sched, alloc, cache = _sched()
    prompt = np.arange(20, dtype=np.int32)
    sched.add_tokens(1, prompt)
    _drain(sched)
    sched.add_tokens(2, np.concatenate([prompt[:16], _toks(9, 9, 9, 9, 9)]))
    _drain(sched)
    blocks = sched.seqs[2].blocks
    assert blocks[:2] == sched.seqs[1].blocks[:2]
    assert [alloc.ref_count(b) for b in blocks] == [3, 3] + [1] * (len(blocks) - 2)
    sched.flush(1)
    sched.flush(2)
    cache.evict(alloc.total_blocks)
    assert alloc.free_blocks == alloc.total_blocks


def test_config_surface():
    cfg = RaggedInferenceEngineConfig.load(
        {"prefix_cache": {"enabled": True, "max_cached_blocks": 64}})
    assert cfg.prefix_cache.enabled and cfg.prefix_cache.max_cached_blocks == 64
    assert cfg.prefix_cache.eviction == "lru"
    assert RaggedInferenceEngineConfig.load({}).prefix_cache.enabled is False
    for kw, match in (({"eviction": "fifo"}, "eviction"), ({"max_cached_blocks": 0},
                                                            "max_cached_blocks")):
        with pytest.raises(ValueError, match=match) as port_err:
            PrefixCacheConfig(**kw)
        from deepspeed_tpu.inference.v2.config_v2 import PrefixCacheConfig as JaxPC
        with pytest.raises(ValueError) as jax_err:
            JaxPC(**kw)
        assert str(port_err.value) == str(jax_err.value)


# --------------------------------------------------------------------- #
# engines on a tiny fp32 Llama carried across with the converter
# --------------------------------------------------------------------- #

LLAMA = dict(vocab_size=128, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=256)
STATE = {"max_tracked_sequences": 8, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 40, "prefill_chunk_size": 16, "max_context": 128}
POOL = {"kv_cache": {"block_size": BS, "num_blocks": 48}}
INT8_POOL = {"kv_cache": {"block_size": 64, "num_blocks": 12}, "kv_quant": {"enabled": True}}


def _flat(seed=0):
    model = JaxLlama(JaxLlamaConfig(dtype=jnp.float32, **LLAMA))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        flat[k] = (1.0 + 0.1 * noise if k.endswith("weight")
                   else noise / np.float32(np.sqrt(v.shape[-1 if "embedding" in k else 0])))
    return model, flat


def _tree(flat):
    tree = {}
    for k, a in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree


@pytest.fixture(scope="module")
def weights():
    jax_model, flat = _flat()
    port_model = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu", seed=1)
    port_model.load_flat(params_from_flat(flat, device="cpu"))
    return jax_model, flat, port_model


def _port(port_model, cache, pool=POOL):
    return InferenceEngineV2(port_model, {"state_manager": STATE, **pool,
                                          "dtype": torch.float32,
                                          "prefix_cache": {"enabled": cache}},
                             port_model.flat_params(), device="cpu")


def _near(a, b, rtol=RTOL):
    """Logit rows within ``rtol`` of each row's largest |logit|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max(axis=-1, keepdims=True)
    assert (np.abs(a - b) <= rtol * scale).all(), float((np.abs(a - b) / scale).max())


def _prompts(seed, prefix_len, tails):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, 128, prefix_len).astype(np.int32)
    return [np.concatenate([prefix, rng.randint(0, 128, n).astype(np.int32)]) for n in tails]


def test_cache_on_logits_equal_cache_off_and_jax(weights):
    """Three prompts sharing a 29-token prefix (3 full pages + 5): the
    second and third adopt the cached pages and prefill only their tails
    as continuation passes. Logits against the cache-off engine at rtol
    1e-5, against the JAX engine's cache-on logits at 1e-4; computed
    prefill drops; a COW adoption of the flushed partial tail too."""
    jax_model, flat, port_model = weights
    prompts = _prompts(3, 29, (6, 4, 9))
    on, off = _port(port_model, True), _port(port_model, False)
    jax_on = JaxEngine(model=jax_model, model_parameters=_tree(flat),
                       config={"state_manager": STATE, **POOL, "dtype": jnp.float32,
                               "prefix_cache": {"enabled": True}})
    for i, p in enumerate(prompts):
        got = on.put([i], [p])
        _near(got, off.put([i], [p]))
        np.testing.assert_allclose(got, jax_on.put([i], [p]), rtol=0, atol=LOGITS_ATOL)
    st = on.prefix_cache.stats
    assert st.hits == 2 and st.tokens_saved == 2 * 24
    assert on.scheduler.prefill_tokens_completed < off.scheduler.prefill_tokens_completed
    assert vars(st) == vars(jax_on.prefix_cache.stats)
    # the first sequence's flush files its partial tail (tokens 32..34);
    # a prompt extending it adopts that page copy-on-write
    ext = np.concatenate([prompts[0], _toks(5, 6, 7)])
    for e in (on, off, jax_on):
        e.flush([0, 1, 2])
    got = on.put([5], [ext])
    assert on.prefix_cache.stats.cow_copies == 1
    _near(got, off.put([5], [ext]))
    np.testing.assert_allclose(got, jax_on.put([5], [ext]), rtol=0, atol=LOGITS_ATOL)


def test_fully_cached_prompt_still_prefills_one_token(weights):
    _, _, port_model = weights
    prompt = _prompts(5, 16, (0,))[0]          # 2 exact pages
    eng = _port(port_model, True)
    first = eng.put([1], [prompt])
    eng.flush([1])
    before = eng.scheduler.prefill_tokens_completed
    second = eng.put([2], [prompt])
    assert eng.scheduler.prefill_tokens_completed - before == BS   # the last page
    _near(second, first)


def test_generate_streams_equal_under_pool_pressure(weights):
    """A pool of 6 pages, 3 a sequence: cached pages of retired
    ones evict as needed, and greedy streams equal the cache-off engine's
    (the tiny f32 model has no near-ties at these prompts)."""
    _, _, port_model = weights
    small = {"kv_cache": {"block_size": BS, "num_blocks": 6}}
    on, off = _port(port_model, True, small), _port(port_model, False, small)
    for p in _prompts(8, 14, (1, 2, 3, 1)):
        assert on.generate([p], max_new_tokens=4) == off.generate([p], max_new_tokens=4)
    assert on.prefix_cache.stats.tokens_saved > 0 and on.prefix_cache.stats.evictions > 0
    on.prefix_cache.evict(on.allocator.total_blocks)
    assert on.free_blocks == on.allocator.total_blocks


def test_int8_cow_copies_the_scale_tile(weights):
    """Over an int8 pool, the COW copy equals its source byte for byte: the
    int8 values and the scale tile of every layer; the hit's logits stay
    within rtol of the cache-off int8 engine's."""
    _, _, port_model = weights
    on, off = _port(port_model, True, INT8_POOL), _port(port_model, False, INT8_POOL)
    base = _prompts(11, 90, (0,))[0]            # 1 full page of 64 + 26
    ext = np.concatenate([base, _toks(1, 2, 3, 4, 5)])
    on.put([1], [base])
    on.flush([1])
    kv = on.kv
    copied = []
    cow = on.prefix_cache.cow_fn

    def checked(src, dst):
        cow(src, dst)
        copied.append((torch.equal(kv.kv[:, src], kv.kv[:, dst]),
                       torch.equal(kv.scales[:, src].view(torch.int32),
                                   kv.scales[:, dst].view(torch.int32)),
                       bool(kv.scales[:, src].abs().sum() > 0)))

    on.prefix_cache.cow_fn = checked
    got = on.put([2], [ext])
    assert copied == [(True, True, True)]
    _near(got, off.put([2], [ext]))


def test_copy_page_is_byte_exact_and_touches_one_page():
    kv = BlockedKVCache(KVCacheConfig(num_layers=2, num_kv_heads=2, head_dim=128,
                                      block_size=64, num_blocks=5, quantized=True), "cpu")
    g = torch.Generator().manual_seed(0)
    kv.kv.copy_(torch.randint(-127, 128, kv.kv.shape, generator=g, dtype=torch.int8))
    kv.scales.copy_(torch.rand(kv.scales.shape, generator=g))
    before_kv, before_sc = kv.kv.clone(), kv.scales.clone()
    kv.copy_page(1, 3)
    assert torch.equal(kv.kv[:, 3], before_kv[:, 1])
    assert torch.equal(kv.scales[:, 3], before_sc[:, 1])
    others = [b for b in range(5) if b != 3]
    assert torch.equal(kv.kv[:, others], before_kv[:, others])
    assert torch.equal(kv.scales[:, others], before_sc[:, others])


def test_window_model_refused_in_jax_words(weights):
    _, _, port_model = weights
    conf = {"state_manager": STATE, **POOL, "prefix_cache": {"enabled": True}}
    spec = type("Spec", (), {"window": 8, "head_dim": 128, "num_kv_heads": 2,
                             "alibi": False, "moe": None})()
    with pytest.raises(NotImplementedError) as jax_err:
        JaxAttention.validate_engine_build(spec, JaxConfig.load(conf))
    windowed = LlamaForCausalLM(LlamaConfig(**LLAMA, sliding_window=8), device="cpu",
                                seed=2)
    with pytest.raises(NotImplementedError) as port_err:
        InferenceEngineV2(windowed, {**conf, "dtype": torch.float32},
                          windowed.flat_params(), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert "sliding-window" in str(port_err.value)


def test_monitor_events(weights):
    _, _, port_model = weights
    eng = _port(port_model, True)
    prompt = _prompts(6, 20, (0,))[0]
    for u in (1, 2):
        eng.put([u], [prompt])
        eng.flush([u])
    sink = type("Sink", (), {"events": [], "write_events": lambda self, ev: self.events.extend(ev)})()
    eng.write_monitor_events(sink, step=7)
    got = {n: v for n, v, s in sink.events if s == 7}
    assert got["inference/prefix_cache/tokens_saved"] == 16
    assert 0 < got["inference/prefix_cache/hit_rate"] < 1


def test_slice_modules_import_with_jax_blocked():
    """The prefix cache, the spec package and the engine import in a fresh
    interpreter where importing jax, flax or deepspeed_tpu raises."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    mods = ("deepspeed_tpu_torch.inference.v2.prefix_cache",
            "deepspeed_tpu_torch.inference.v2.spec",
            "deepspeed_tpu_torch.inference.v2.spec.pipeline",
            "deepspeed_tpu_torch.inference.v2.engine_v2")
    code = ("import importlib, sys; "
            "[sys.modules.__setitem__(m, None) for m in ('jax', 'flax', 'deepspeed_tpu')]; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2 as E; "
            "assert callable(E._verify_fn) and isinstance(E.spec_k_ladder, property)")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(root)})
