"""The port's colocated rollout (deepspeed_tpu_torch.runtime.colocated and
the swap wiring), on the CPU: its own copies of the JAX package's gates
(tests/unit/test_colocated.py) on a tiny GPT-2, plus the checks the port
adds.

- The WeightBridge reproduces the universal-checkpoint train->serve path
  byte for byte (save -> ds_to_universal -> load_universal -> a fresh
  engine), donating or not, and the JAX package's WeightBridge leaf for
  leaf on the same master (bytes: an f32 cast and column slices are
  exact). The port-only ``embed_f32`` leaf (a tied head's f32 copy) has no
  JAX counterpart and is skipped there.
- A donating sync writes every serving tensor in place (their data_ptrs
  stay) and is refused with live sequences.
- Swaps add no step-cache entry and generate byte for byte what a fresh
  engine generates; live sequences, bad trees, another device and a
  version that does not rise are refused.
- The prefix cache's weight-version flush; the frontend swap quiesces
  in-flight decode (and offload-preempted victims, a repair of the JAX
  frontend, which leaves their sequences live and is then refused); the
  LoRA pool's drain; the rollout loop.

Params come from ``jax.eval_shape`` plus numpy (no flax ``init``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import state as jax_state
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngineV2
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu_torch.checkpoint import universal
from deepspeed_tpu_torch.checkpoint.convert import params_from_flat
from deepspeed_tpu_torch.checkpoint.state import flatten_tree, unflatten_into
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.prefix_cache import RadixPrefixCache
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.monitor.trace import tracer
from deepspeed_tpu_torch.runtime.colocated import RolloutLoop, WeightBridge

from tests._torch_threads import one_torch_thread  # noqa: F401

VOCAB = 128
BS = 8
T = 16
ECONF = {"dtype": torch.float32,
         "state_manager": {"max_tracked_sequences": 8,
                           "max_ragged_sequence_count": 4,
                           "max_ragged_batch_size": 96,
                           "max_context": 176,
                           "prefill_chunk_size": 32},
         "kv_cache": {"block_size": 16, "num_blocks": 16}}
TRAIN = {"train_batch_size": 8, "gradient_accumulation_steps": 1, "steps_per_print": 0,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
         "zero_optimization": {"stage": 1}}


def _jax_shapes():
    model = JaxGPT2(JaxGPT2Config.tiny(vocab_size=VOCAB))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                 {"input_ids": jnp.zeros((1, T), jnp.int32)})["params"]


def _numpy_params(seed=0):
    """GPT-2's init in numpy: N(0, 0.02) kernels and embeddings, unit
    scales, zero biases."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in jax_state.flatten_tree(_jax_shapes()[1]).items():
        if k.endswith("scale"):
            flat[k] = np.ones(s.shape, np.float32)
        elif k.endswith("bias"):
            flat[k] = np.zeros(s.shape, np.float32)
        else:
            flat[k] = (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
    return flat


def _model():
    return GPT2LMHead(GPT2Config.tiny(vocab_size=VOCAB), device="cpu")


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, VOCAB, (8, T)).astype(np.int32)}


def _train_engine(steps=2, params=None):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_model(), model_parameters=params or _numpy_params(), config=TRAIN,
        device="cpu")
    for i in range(steps):
        engine.train_batch(_batch(100 + i))
    return engine


def _serve_engine(params=None, prefix_cache=False, serving=None, quant=None):
    econf = dict(ECONF)
    if prefix_cache:
        econf["prefix_cache"] = {"enabled": True}
    if serving is not None:
        econf["serving"] = serving
    if quant is not None:
        econf["quantization"] = {"weight_bits": quant}
    params = params if params is not None else params_from_flat(_numpy_params(), device="cpu")
    return InferenceEngineV2(_model(), econf, params, device="cpu")


def _fresh_from(train_engine, **kw):
    """A fresh serving engine over a COPY of the trainer's master."""
    return _serve_engine({k: v.detach().clone()
                          for k, v in train_engine.rollout_source_params().items()}, **kw)


def _same_tree(weights):
    """A new tree of the same structure holding the same tensors."""
    return unflatten_into(weights, flatten_tree(weights))


def _bytes(t):
    return t.detach().contiguous().view(torch.uint8).numpy().tobytes()


def _leaves_byte_equal(a, b):
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert list(fa) == list(fb)
    return all(_bytes(fa[k]) == _bytes(fb[k]) for k in fa)


# --------------------------------------------------------------------------- #
# the bridge against the universal-checkpoint disk path and the JAX bridge
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("donate", [True, False], ids=["donate", "fresh"])
def test_reshard_matches_universal(tmp_path, donate):
    """The one-device case of the JAX package's
    ``test_reshard_matches_universal_sharded``."""
    eng = _train_engine(steps=2)
    serve = _serve_engine()
    bridge = serve.weight_bridge(eng, donate=donate)
    new_w = bridge.sync()
    eng.save_checkpoint(str(tmp_path / "ck"), tag="t")
    universal.ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "uni"), tag="t")
    master, _, _ = universal.load_universal(str(tmp_path / "uni"))
    ref = _serve_engine(params_from_flat(master, device="cpu"))
    assert _leaves_byte_equal(new_w, ref.weights)
    assert bridge.compiles == 1
    bridge.sync()
    assert bridge.compiles == 1                  # one layout build, any number of syncs
    names = bridge.manifest()
    assert "h_0/attn/c_attn/kernel" in names
    assert names == sorted(master)               # the universal checkpoint's names


def test_reshard_matches_universal_offload(tmp_path):
    """The JAX package's ``test_reshard_matches_universal_offload``: a
    cpu-offload trainer syncs from its merged params (the post-update
    view), byte-equal to a serving engine loaded from the universal
    checkpoint of the same state."""
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_model(), model_parameters=_numpy_params(),
        config={**TRAIN, "zero_optimization": {"stage": 1,
                                               "offload_optimizer": {"device": "cpu"}}},
        device="cpu")
    for i in range(2):
        eng.train_batch(_batch(100 + i))
    assert eng.rollout_source_params() is eng.state["params"]
    serve = _serve_engine()
    new_w = serve.weight_bridge(eng, donate=False).sync()
    eng.save_checkpoint(str(tmp_path / "ck"), tag="t")
    universal.ds_to_universal(str(tmp_path / "ck"), str(tmp_path / "uni"), tag="t")
    master, _, _ = universal.load_universal(str(tmp_path / "uni"))
    ref = _serve_engine(params_from_flat(master, device="cpu"))
    assert _leaves_byte_equal(new_w, ref.weights)
    eng.destroy()


def _jax_key_to_port(key, layer):
    """A JAX serving-tree path (stacked layers) -> the port's path of
    layer ``layer`` (a list of per-layer dicts): ``ln1/scale`` -> ``ln1``,
    ``ln1/bias`` -> ``ln1_bias``, ``mlp/w_up`` -> ``w_up``."""
    key = key.replace("/scale", "").replace("/bias", "_bias").replace("mlp/", "")
    if key.startswith("layers/"):
        return f"layers/{layer}/{key[len('layers/'):]}"
    return key


def test_bridge_matches_jax_weight_bridge():
    """The JAX package's WeightBridge and the port's on the same master
    (the JAX trainer's after 2 steps, converted): leaf for leaf, byte for
    byte, at fp32."""
    from deepspeed_tpu.runtime.colocated import WeightBridge as JaxWeightBridge
    model, shapes = _jax_shapes()
    params = jax_state.unflatten_into(shapes, _numpy_params())
    jeng, *_ = deepspeed_tpu.initialize(model=model, model_parameters=params, config=TRAIN)
    for i in range(2):
        jeng.train_batch(_batch(100 + i))
    jserve = JaxEngineV2(model=model, model_parameters=params,
                         config=dict(ECONF, dtype=jnp.float32))
    jw = JaxWeightBridge(jeng, jserve, donate=False).sync()
    master = {k: np.asarray(v) for k, v in
              jax_state.flatten_tree(jeng.rollout_source_params()).items()}
    eng = _train_engine(steps=0, params=master)
    got = flatten_tree(WeightBridge(eng, _serve_engine(), donate=False).sync())
    compared = set()
    for key, leaf in jax_state.flatten_tree(jw).items():
        leaf = np.asarray(leaf)
        stacked = key.startswith("layers/")
        for i in range(leaf.shape[0] if stacked else 1):
            pk = _jax_key_to_port(key, i)
            want = leaf[i] if stacked else leaf
            assert got[pk].shape == want.shape, pk
            assert _bytes(got[pk]) == np.ascontiguousarray(want).tobytes(), pk
            compared.add(pk)
    assert set(got) - compared == {"embed_f32"}  # the port-only tied-head leaf


def test_donating_sync_writes_in_place_and_refuses_live_sequences():
    eng = _train_engine(steps=2)
    serve = _serve_engine()
    ptrs = {k: t.data_ptr() for k, t in flatten_tree(serve.weights).items()}
    bridge = WeightBridge(eng, serve)               # donate=True is the default
    out = bridge.sync()
    assert out is serve.weights
    assert {k: t.data_ptr() for k, t in flatten_tree(serve.weights).items()} == ptrs
    assert _leaves_byte_equal(serve.weights, _fresh_from(eng).weights)
    serve.scheduler.add_tokens(7, np.arange(1, 20, dtype=np.int32))
    with pytest.raises(RuntimeError, match="live sequences"):
        bridge.sync()
    serve.flush([7])


def test_bridge_refuses_quantized_serve_engine():
    eng = _train_engine(steps=0)
    for bits in (8, 4):
        serve = _serve_engine(quant=bits)
        with pytest.raises(NotImplementedError, match="quantized"):
            WeightBridge(eng, serve)


def test_rollout_source_refuses_quantized_train_weights():
    eng = _train_engine(steps=0)
    eng.quantized_weights = True
    with pytest.raises(NotImplementedError, match="quantized"):
        eng.rollout_source_params()


def test_bridge_refuses_another_architecture():
    eng = _train_engine(steps=0)
    other = GPT2LMHead(GPT2Config.tiny(vocab_size=VOCAB, n_embd=32), device="cpu")
    serve = InferenceEngineV2(other, ECONF, other.flat_params(), device="cpu")
    with pytest.raises(ValueError, match="does not reproduce the serving layout"):
        WeightBridge(eng, serve, donate=False).sync()


# --------------------------------------------------------------------------- #
# in-place swap: no new step-cache entry, byte-identical generation
# --------------------------------------------------------------------------- #

def test_swap_zero_compiles_byte_identical_generation():
    eng = _train_engine(steps=2)
    serve = _serve_engine()
    serve.warmup(burst_steps=(4,))
    bridge = serve.weight_bridge(eng, donate=False)
    prompt = list(range(1, 12))
    serve.generate([prompt], max_new_tokens=8)
    c0, b0 = serve.step_cache_entries(), bridge.compiles
    for i in range(3):                                # >= 3 consecutive swaps
        eng.train_batch(_batch(200 + i))
        serve.swap_weights(bridge.sync())
    assert serve.step_cache_entries() == c0           # no new step
    assert bridge.compiles - b0 <= 1                  # the first sync builds once
    assert serve.weight_version == 3
    out = serve.generate([prompt], max_new_tokens=8)
    fresh = _fresh_from(eng)
    assert out == fresh.generate([prompt], max_new_tokens=8)
    assert _leaves_byte_equal(serve.weights, fresh.weights)


def test_swap_refused_with_live_sequences_and_bad_trees():
    serve = _serve_engine()
    same = _same_tree(serve.weights)
    serve.scheduler.add_tokens(7, np.arange(1, 20, dtype=np.int32))
    with pytest.raises(RuntimeError, match="live sequence"):
        serve.swap_weights(same)
    serve.scheduler.flush(7)
    assert serve.weight_version == 0                  # the refusal changed nothing
    bad = _same_tree(serve.weights)
    bad["embed"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="embed"):
        serve.swap_weights(bad)
    bad["embed"] = serve.weights["embed"].to("meta")  # the device check
    with pytest.raises(ValueError, match="on meta"):
        serve.swap_weights(bad)
    del bad["embed"]
    with pytest.raises(ValueError, match="structure"):
        serve.swap_weights(bad)
    with pytest.raises(ValueError, match="version"):
        serve.swap_weights(same, version=0)           # must be monotone
    assert serve.weight_version == 0
    assert serve.swap_weights(same) == 1              # a clean swap still works


# --------------------------------------------------------------------------- #
# prefix cache: the weight-version flush and the stale-stamp refusal
# --------------------------------------------------------------------------- #

class TestPrefixCacheWeightVersion:

    def _cache(self, nb=32):
        alloc = BlockedAllocator(nb)
        return RadixPrefixCache(alloc, BS), alloc

    def test_flush_on_version_bump(self):
        cache, alloc = self._cache()
        toks = np.arange(24)
        blocks = alloc.allocate(3).tolist()
        cache.release(toks, blocks)
        m = cache.match(toks)
        assert m.n_cached == 16
        alloc.free(m.blocks)                          # drop the match refs
        freed = cache.set_weight_version(1)
        assert freed == 3 and cache.cached_blocks == 0
        assert cache.match(toks).n_cached == 0        # stale KV is gone
        assert cache.set_weight_version(1) == 0       # idempotent

    def test_stale_stamped_nodes_refused_and_not_extended(self):
        cache, alloc = self._cache()
        toks = np.arange(24)
        blocks = alloc.allocate(3).tolist()
        cache.release(toks, blocks)
        cache.weight_version = 1                      # a pinned node survived a flush
        assert cache.match_len(toks) == 0
        assert cache.match(toks).n_cached == 0
        blocks2 = alloc.allocate(3).tolist()
        freed = cache.release(toks, blocks2)          # insert under a stale root
        assert sorted(freed) == sorted(blocks2)       # refused, pages freed

    def test_flush_with_pinned_pages_raises(self):
        cache, alloc = self._cache()
        toks = np.arange(16)
        blocks = alloc.allocate(2).tolist()
        cache.release(toks, blocks)
        m = cache.match(toks)                         # a live match ref pins
        with pytest.raises(RuntimeError, match="quiesce"):
            cache.set_weight_version(1)
        alloc.free(m.blocks)
        cache.set_weight_version(1)

    def test_post_swap_hit_refused_and_reprefilled(self):
        """A prompt cached before the swap MISSES after it, re-prefills
        under the new weights and then hits again, with byte-identical
        output throughout (the same weight values swapped in)."""
        serve = _serve_engine(prefix_cache=True)
        prompt = list(range(1, 40))
        ref = serve.generate([prompt], max_new_tokens=6)
        hits0 = serve.prefix_cache.stats.hits
        assert serve.generate([prompt], max_new_tokens=6) == ref
        assert serve.prefix_cache.stats.hits > hits0  # the second run hit
        serve.swap_weights(_same_tree(serve.weights))
        assert serve.prefix_cache.weight_version == serve.weight_version
        assert serve.prefix_cache.cached_blocks == 0  # flushed
        hits1 = serve.prefix_cache.stats.hits
        assert serve.generate([prompt], max_new_tokens=6) == ref
        assert serve.prefix_cache.stats.hits == hits1  # re-prefill, no hit
        assert serve.generate([prompt], max_new_tokens=6) == ref
        assert serve.prefix_cache.stats.hits > hits1  # primed again


# --------------------------------------------------------------------------- #
# frontend swap: run-boundary quiesce, recompute-preempt resume
# --------------------------------------------------------------------------- #

def _mid_decode(fe, h):
    for _ in range(8):
        fe.step()
        if h.status == "decoding" and len(h.tokens) >= 2:
            break
    assert h.status == "decoding" and not h.finished


def _finish(fe, h):
    for _ in range(64):
        fe.step()
        if h.finished:
            break
    assert h.status == "finished"


def test_frontend_swap_quiesces_inflight_decode():
    serve = _serve_engine(serving={"decode_slice": 2, "idle_wait_s": 0.005})
    ref = serve.generate([list(range(1, 12))], max_new_tokens=10)[0]
    fe = serve.serving_frontend()                     # synchronous (no thread)
    h = fe.submit(list(range(1, 12)), max_new_tokens=10)
    _mid_decode(fe, h)
    fe.swap_weights(_same_tree(serve.weights))        # inline: no loop thread
    assert serve.weight_version == 1
    assert h.status == "preempted"                    # quiesced, not killed
    assert fe.stats.recompute_preemptions == 1
    _finish(fe, h)
    assert h.tokens == ref[11:]                       # the stream byte-identical
    fe.close()


def test_frontend_swap_converts_offloaded_victims():
    """An offload-preempted request parks old-weight KV on the host and
    keeps its sequence (with its shared-prefix pages) in the engine: the
    swap drops the parked pages, flushes the sequence and restores it by
    recompute. The JAX frontend leaves the sequence live, so its engine
    refuses that swap."""
    serve = _serve_engine(prefix_cache=True,
                          serving={"decode_slice": 2, "idle_wait_s": 0.005,
                                   "preemption": "offload"})
    prompt = list(range(1, 40))
    ref = serve.generate([prompt], max_new_tokens=10)[0]
    fe = serve.serving_frontend()
    h = fe.submit(prompt, max_new_tokens=10)
    _mid_decode(fe, h)
    fe._preempt(h)                                    # the admission plan's preemption
    assert h.uid in fe.offload._recs and h.uid in serve.scheduler.seqs
    fe.swap_weights(_same_tree(serve.weights))
    assert serve.weight_version == 1 and not serve.scheduler.seqs
    assert h.uid not in fe.offload._recs and fe.offload.bytes_held == 0
    assert fe.stats.recompute_preemptions == 1
    _finish(fe, h)
    assert h.tokens == ref[len(prompt):]
    fe.close()


# --------------------------------------------------------------------------- #
# the LoRA swap pool's drain
# --------------------------------------------------------------------------- #

def test_lora_drain_swap_settles_pool_byte_safely():
    from deepspeed_tpu_torch.inference.v2.lora import LoraAdapterRegistry, LoraPagePool
    from deepspeed_tpu_torch.inference.v2.ragged_model import RaggedModelSpec
    spec = RaggedModelSpec(family="llama", num_layers=2, hidden_size=8, num_heads=2,
                           num_kv_heads=2, head_dim=4, vocab_size=64, dtype=torch.float32)
    pool = LoraPagePool(spec, ("q", "v"), 4, "cpu")
    reg = LoraAdapterRegistry(pool, swap_buffers=8, max_rank=4)
    for i in range(3):
        g = np.random.RandomState(i)
        reg.register(f"a{i}", g.standard_normal((2, pool.elements)).astype(np.float32))
    master0 = _bytes(reg._adapters["a0"].master)
    reg.acquire(1, "a0"); reg.release(1)
    reg.acquire(2, "a1"); reg.release(2)
    reg.acquire(3, "a2"); reg.release(3)              # evicts the LRU a0
    assert reg._adapters["a0"].state == "evicted"
    assert reg.swap.outstanding > 0                   # pinned behind the eviction
    drained = reg.drain_swap()
    assert drained > 0 and reg.swap.outstanding == 0
    assert reg._adapters["a0"].state == "registered"
    assert reg.drain_swap() == 0                      # idempotent
    reg.acquire(4, "a0")                              # faults back in from the master
    assert _bytes(pool.fetch_pages(reg._adapters["a0"].page_ids)) == master0
    reg.release(4)


# --------------------------------------------------------------------------- #
# the full loop
# --------------------------------------------------------------------------- #

def test_rollout_loop_interleaves_train_and_generate():
    eng = _train_engine(steps=0)
    serve = _serve_engine(prefix_cache=True,
                          serving={"decode_slice": 4, "idle_wait_s": 0.005})
    fe = serve.serving_frontend()

    def prompt_fn(rnd):
        r = np.random.default_rng(rnd)
        return [r.integers(1, VOCAB, size=8).tolist() for _ in range(3)]

    def collate(rollouts):
        rows = [(p + t + [0] * T)[:T] for p, t in rollouts]
        return {"input_ids": np.asarray(rows, np.int32).repeat(3, axis=0)[:8]}

    tracer.reset()
    tracer.configure(enabled=True)
    loop = RolloutLoop(eng, fe, prompt_fn=prompt_fn, collate_fn=collate,
                       steps_per_round=1, max_new_tokens=4, request_timeout=60.0)
    try:
        losses = loop.run(3)
        spans = tracer.summary()
    finally:
        loop.close()
        fe.close()
        tracer.reset()
    assert len(losses) == 3 and all(np.isfinite(l).all() for l in losses)
    assert eng.global_steps == 3
    assert serve.weight_version == 4                 # align + 3 rounds
    st = loop.stats
    assert st.rounds == 4 and st.requests == 9 and st.tokens == 36
    assert st.weight_version == 4
    names = [n for n, _, _ in st.events(0)]
    assert "train/rollout/sync_ms_per_round" in names
    # the stats are the spans' sums
    for phase, ms in (("sync", st.sync_ms), ("swap", st.swap_ms),
                      ("generate", st.generate_ms)):
        count, seconds = spans[f"train/rollout/{phase}"]
        assert count == (3 if phase == "generate" else 4)
        assert abs(seconds * 1e3 - ms) < 1e-6
