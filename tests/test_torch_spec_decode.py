"""The port's speculative decoding (``inference/v2/spec/``,
``ragged_model.build_verify_step``, ``scheduler.rollback_reserved``)
against the JAX package's and against the port's own plain pipeline.

Mirrors ``tests/unit/test_spec_decode.py``: the verify step against JAX's
``build_verify_step`` on the same converted weights and pool (logits within
1e-4 absolute in f32, the engines' tolerance in
``test_torch_window_serving.py``; accept rows equal wherever the dense
model's top-2 gap exceeds the near-tie limit), spec-on streams against the
plain pipeline's (equal, or parting only at a near-tie: the verify step
runs the chunk kernel's plain version, the decode step the decode
kernel's, so their f32 logits agree to association noise), an oracle
proposer accepting every draft, the n-gram proposer byte-equal to JAX's,
rollback across a block edge and the allocator back at its baseline after
a reject-heavy run, ``do_sample`` bypassing spec with exactly one warning,
``generate``'s tail at ``max_context`` degrading to the plain pipeline,
and the sliding-window refusal in the JAX package's words.

The near-tie limit is 1e-4 on f32 logits: the largest plain-version
difference between the verify and decode paths seen here is ~1e-6.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.attention import AttentionKernelSpec as JaxAttention
from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2.config_v2 import SpecDecodeConfig as JaxSpecConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.spec.proposer import NGramProposer as JaxNGram
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import DecodePipeline, InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.config_v2 import (DSStateManagerConfig,
                                                        RaggedInferenceEngineConfig,
                                                        SpecDecodeConfig)
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache, KVCacheConfig
from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
from deepspeed_tpu_torch.inference.v2.scheduler import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.inference.v2.spec import (DraftProposer, NGramProposer,
                                                   SpecDecodePipeline)
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

from tests._torch_threads import one_torch_thread  # noqa: F401

K = 3
BS = 16
LOGITS_ATOL = 1e-4
TIE = 1e-4
LLAMA = dict(vocab_size=128, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=256)
STATE = {"max_tracked_sequences": 6, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 40, "prefill_chunk_size": 16, "max_context": 256}
POOL = {"kv_cache": {"block_size": BS, "num_blocks": 64}}
INT8_POOL = {"kv_cache": {"block_size": 64, "num_blocks": 24}, "kv_quant": {"enabled": True}}
PROMPTS = [np.array([3, 14, 15, 92, 6], np.int32),
           np.array([27, 18, 28, 18], np.int32),
           np.array([31, 41, 59, 26, 53, 58], np.int32)]
# a prompt repeating one span: n-gram drafts match from the first step
LOOP = np.tile(np.array([7, 1, 88, 3, 41, 9], np.int32), 5)


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


def _port(port_model, spec=True, pool=POOL, state=STATE, **spec_kw):
    conf = {"state_manager": state, **pool, "dtype": torch.float32}
    if spec:
        conf["spec_decode"] = {"enabled": True, "k": K, **spec_kw}
    return InferenceEngineV2(port_model, conf, port_model.flat_params(), device="cpu")


@pytest.fixture(scope="module")
def engines(weights):
    """(spec engine, plain engine, port model) over the same weights."""
    _, _, port_model = weights
    return _port(port_model), _port(port_model, spec=False), port_model


class OracleProposer(DraftProposer):
    """Replays known greedy streams: every draft is right."""

    def __init__(self, prompts, streams):
        self.fulls = [list(map(int, p)) + list(map(int, s)) for p, s in zip(prompts, streams)]

    def propose(self, history, k):
        h = [int(t) for t in history]
        for full in self.fulls:
            if full[:len(h)] == h:
                return np.asarray(full[len(h):len(h) + k], np.int32)
        return np.zeros((0,), np.int32)


class GarbageProposer(DraftProposer):
    """Full-k drafts of tokens the model never picks: rejects everywhere."""

    def propose(self, history, k):
        return np.full((k,), 1, np.int32) + np.arange(k, dtype=np.int32)


def _gap(model, seq):
    """Top-2 gap of the dense f32 model's logits after ``seq``."""
    lg = model.forward_logits(torch.as_tensor(np.asarray(seq, np.int64))[None])[0, -1]
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def _same_or_near_tie(model, prompt, got, ref):
    """``got`` equals ``ref`` over their common length, or the first token
    where they differ follows a near-tie of the dense model's logits."""
    n = min(len(got), len(ref))
    diff = [i for i in range(n) if got[i] != ref[i]]
    if diff:
        i = diff[0]
        gap = _gap(model, np.concatenate([prompt, np.asarray(ref[:i], np.int32)]))
        assert gap < TIE, f"streams part at {i} where the top-2 gap is {gap}"


# --------------------------------------------------------------------- #
# config, ladder, proposer
# --------------------------------------------------------------------- #

def test_spec_config_validation_in_jax_words():
    assert SpecDecodeConfig().enabled is False
    for kw in ({"k": 0}, {"min_match": 0}, {"min_match": 3, "max_ngram": 2}):
        with pytest.raises(ValueError) as port_err:
            SpecDecodeConfig(**kw)
        with pytest.raises(ValueError) as jax_err:
            JaxSpecConfig(**kw)
        assert str(port_err.value) == str(jax_err.value)
    cfg = RaggedInferenceEngineConfig.load({"spec_decode": {"enabled": True, "k": 6}})
    assert cfg.spec_decode.enabled and cfg.spec_decode.k == 6


@pytest.mark.parametrize("k", [1, 3, 6, 7, 15])
def test_spec_k_ladder_matches_jax(k):
    conf = type("C", (), {"config": RaggedInferenceEngineConfig.load(
        {"spec_decode": {"enabled": True, "k": k}})})()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jconf = type("C", (), {"config": JaxConfig.load(
            {"spec_decode": {"enabled": True, "k": k}})})()
    assert InferenceEngineV2.spec_k_ladder.fget(conf) == JaxEngine.spec_k_ladder.fget(jconf)


def test_ngram_proposer_byte_equal_to_jax():
    rng = np.random.RandomState(0)
    histories = [np.asarray(list(np.tile([1, 2, 3, 4], 3)) + [1, 2], np.int32),
                 np.asarray([9, 1, 2, 7, 7, 5, 9, 1, 2], np.int32),
                 np.asarray([8, 3, 8], np.int32), np.zeros((0,), np.int32), LOOP]
    for _ in range(40):
        span = rng.randint(0, 6, rng.randint(2, 9))
        noise = rng.randint(0, 6, rng.randint(0, 30))
        histories.append(np.concatenate([noise, np.tile(span, rng.randint(1, 4)),
                                         noise[:rng.randint(0, 5)]]).astype(np.int32))
    for mm, mx in ((1, 1), (2, 4), (3, 3), (1, 5)):
        port, ref = NGramProposer(mm, mx), JaxNGram(mm, mx)
        for h in histories:
            for k in (0, 1, 3, 7):
                a, b = port.propose(h, k), ref.propose(h, k)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError):
        NGramProposer(min_match=0)
    with pytest.raises(NotImplementedError):
        DraftProposer().propose(histories[0], 1)


# --------------------------------------------------------------------- #
# the verify step against JAX's build_verify_step
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_verify_step_matches_jax(weights, pool):
    """Three live rows in a bucket of 4 (one pad row): the same prompts in
    both engines (so the same pages), the same current tokens and drafts.
    Row 0 drafts the dense model's greedy continuation (accepts fully), row
    1 a draft right at its first token and wrong at its second, row 2
    none. Logits within 1e-4,
    accept rows equal where the top-2 gap is above the near-tie limit, and
    the written KV rows within 1e-4 (f32), or one int8 step with scales
    within 1e-5 relative (int8: the two packages' K/V rows agree to f32
    rounding, which moves a row's amax by a few ulps and may cross an int8
    rounding edge)."""
    jax_model, flat, port_model = weights
    extra = POOL if pool == "f32" else INT8_POOL
    port = _port(port_model, spec=False, pool=extra)
    jax_engine = JaxEngine(model=jax_model, model_parameters=_tree(flat),
                           config={"state_manager": STATE, **extra, "dtype": jnp.float32})
    prompts = [np.concatenate([p, p]) for p in PROMPTS]
    uids = [0, 1, 2]
    lg = port.put(uids, prompts)
    np.testing.assert_allclose(lg, jax_engine.put(uids, prompts), rtol=0, atol=LOGITS_ATOL)
    cur = np.argmax(lg, axis=-1).astype(np.int32)

    def greedy(i, n):
        seq = np.concatenate([prompts[i], cur[i:i + 1]])
        for _ in range(n):
            seq = np.append(seq, int(torch.argmax(port_model.forward_logits(
                torch.as_tensor(seq.astype(np.int64))[None])[0, -1])))
        return seq[len(prompts[i]) + 1:]

    draft = np.zeros((4, K), np.int32)
    draft[0] = greedy(0, K)
    row1 = greedy(1, 2)
    draft[1, :2] = [row1[0], row1[1] ^ 1]
    n_draft = np.array([K, 2, 0, 0], np.int32)
    ids = np.zeros((4,), np.int32)
    ids[:3], ids[3] = cur, cur[0]
    db = port.scheduler.decode_batch(uids, K + 2, port.scratch_block)
    jdb = jax_engine.scheduler.decode_batch(uids, K + 2, jax_engine.scratch_block)
    assert (db.block_tables == np.asarray(jdb.block_tables)).all()
    pos = to_device(db.positions, "cpu")
    accept_row, next_ids, final = port._verify_fn(K)(
        port.weights, port.kv.kv, torch.from_numpy(ids), torch.from_numpy(draft),
        torch.from_numpy(n_draft), pos, to_device(db.block_tables, "cpu"), pos + 1,
        kv_scales=port.kv.scales)
    j_accept, j_next, j_final, new_kv = jax_engine._verify_prog(jdb.bucket, K)(
        jax_engine.weights, jax_engine.kv.kv, jnp.asarray(ids), jnp.asarray(draft),
        jnp.asarray(n_draft), jdb.positions, jnp.asarray(jdb.block_tables), jdb.ctx_lens)
    jax_engine.kv.update(new_kv)
    accept_row, j_accept = accept_row.numpy(), np.asarray(j_accept)
    assert accept_row[0, :3].tolist() == [K, 1, 0]
    for i in range(4):
        if accept_row[0, i] != j_accept[0, i]:
            a = int(min(accept_row[0, i], j_accept[0, i]))
            row_seq = np.concatenate([prompts[min(i, 2)], ids[i:i + 1], draft[i, :a]])
            assert _gap(port_model, row_seq) < TIE
            continue
        assert accept_row[1, i] == j_accept[1, i] or \
            _gap(port_model, np.concatenate([prompts[min(i, 2)], ids[i:i + 1],
                                             draft[i, :accept_row[0, i]]])) < TIE
        np.testing.assert_allclose(final[i].numpy(), np.asarray(j_final)[i], rtol=0,
                                   atol=LOGITS_ATOL)
    assert next_ids.tolist() == accept_row[1].tolist()
    # the K + 1 rows' KV in the live rows' pages, layer by layer
    pages = port.fetch_pages([b for u in uids for b in port.scheduler.seqs[u].blocks])
    jpages = jax_engine.fetch_pages([b for u in uids for b in jax_engine.scheduler.seqs[u].blocks])
    if pool == "f32":
        np.testing.assert_allclose(pages, np.asarray(jpages), rtol=0, atol=LOGITS_ATOL)
    else:
        (vals, scales), (jvals, jscales) = (port._unpack_pages(np.asarray(x))
                                            for x in (pages, jpages))
        assert np.abs(vals.astype(np.int16) - jvals).max() <= 1
        np.testing.assert_allclose(scales, jscales, rtol=1e-5, atol=0)


# --------------------------------------------------------------------- #
# streams within the port
# --------------------------------------------------------------------- #

def test_spec_stream_matches_plain_pipeline(engines):
    spec, plain, model = engines
    N = 18
    prompts = PROMPTS + [LOOP]
    plain.put([0, 1, 2, 3], prompts)
    ref = DecodePipeline(plain, [0, 1, 2, 3]).run(N)
    plain.flush([0, 1, 2, 3])
    spec.put([0, 1, 2, 3], prompts)
    pipe = spec.decode_pipeline([0, 1, 2, 3])
    assert isinstance(pipe, SpecDecodePipeline) and pipe.spec
    spec.spec_stats.reset()
    got = pipe.run(N)
    assert spec.spec_stats.accepted > 0            # the looping prompt drafts
    for i in range(4):
        assert len(got[i]) >= N
        _same_or_near_tie(model, prompts[i], got[i][:N], list(map(int, ref[i])))
    spec.flush([0, 1, 2, 3])
    assert spec.free_blocks == spec.allocator.total_blocks


def test_oracle_drafts_accept_fully(engines):
    spec, plain, model = engines
    N = 20
    plain.put([0, 1, 2], PROMPTS)
    ref = DecodePipeline(plain, [0, 1, 2]).run(N)
    plain.flush([0, 1, 2])
    spec.put([0, 1, 2], PROMPTS)
    spec.spec_stats.reset()
    steps = -(-N // (K + 1))
    got = SpecDecodePipeline(spec, [0, 1, 2], proposer=OracleProposer(PROMPTS, ref)).run(steps)
    st = spec.spec_stats
    assert st.steps == steps and st.acceptance_rate == 1.0
    assert st.tokens_per_step == 3 * (K + 1)
    for i in range(3):
        assert got[i] == list(map(int, ref[i]))[:len(got[i])]
        assert len(got[i]) == steps * (K + 1)
    spec.flush([0, 1, 2])
    assert spec.free_blocks == spec.allocator.total_blocks


def test_reject_heavy_run_returns_allocator_to_baseline(engines):
    spec, _, _ = engines
    total = spec.allocator.total_blocks
    spec.put([0, 1], PROMPTS[:2])
    spec.spec_stats.reset()
    got = SpecDecodePipeline(spec, [0, 1], proposer=GarbageProposer()).run(10)
    assert spec.spec_stats.proposed > 0 and spec.spec_stats.acceptance_rate < 0.3
    for u in (0, 1):
        seq = spec.scheduler.seqs[u]
        assert len(seq.blocks) == -(-seq.seen_tokens // BS)
        assert seq.seen_tokens == len(PROMPTS[u]) + len(got[u])
    spec.flush([0, 1])
    assert spec.free_blocks == total and len(spec.allocator._refs) == 0


def test_spec_generate_matches_plain_engine_with_eos(engines):
    spec, plain, model = engines
    prompts = PROMPTS + [LOOP]
    ref = plain.generate(prompts, max_new_tokens=9)
    got = spec.generate(prompts, max_new_tokens=9)
    for p, g, r in zip(prompts, got, ref):
        assert len(g) == len(r) == len(p) + 9
        _same_or_near_tie(model, p, g[len(p):], r[len(p):])
    eos = ref[0][len(PROMPTS[0]) + 3]
    ref_eos = plain.generate(prompts, max_new_tokens=9, eos_token_id=eos)
    got_eos = spec.generate(prompts, max_new_tokens=9, eos_token_id=eos)
    assert [len(g) for g in got_eos] == [len(r) for r in ref_eos]
    assert spec.free_blocks == spec.allocator.total_blocks


def test_int8_pool_spec_matches_plain(weights):
    """Over int8 pages the verify step quantizes on write: streams equal
    the int8 spec-off engine's, or part at a near-tie."""
    _, _, model = weights
    spec, plain = _port(model, pool=INT8_POOL), _port(model, spec=False, pool=INT8_POOL)
    prompts = [PROMPTS[0], LOOP]
    ref = plain.generate(prompts, max_new_tokens=16)
    got = spec.generate(prompts, max_new_tokens=16)
    assert spec.spec_stats.accepted > 0
    for p, g, r in zip(prompts, got, ref):
        _same_or_near_tie(model, p, g[len(p):], r[len(p):])
    assert spec.free_blocks == spec.allocator.total_blocks


# --------------------------------------------------------------------- #
# rollback, the allocator, sampling, the context tail, retirement
# --------------------------------------------------------------------- #

def _sched(num_blocks=16):
    cfg = DSStateManagerConfig(max_tracked_sequences=4, max_ragged_sequence_count=4,
                               max_ragged_batch_size=32, max_context=16 * 8,
                               prefill_chunk_size=8)
    kv = BlockedKVCache(KVCacheConfig(num_layers=1, num_kv_heads=1, head_dim=8, block_size=8,
                                      num_blocks=num_blocks, dtype=torch.float32), "cpu")
    alloc = BlockedAllocator(num_blocks)
    return DynamicSplitFuseScheduler(cfg, kv, alloc), alloc


def _drain(sched):
    while sched.has_pending():
        sched.complete_pass(sched.schedule_pass())


def test_rollback_across_block_edge():
    sched, alloc = _sched()
    sched.add_tokens(1, np.arange(11, dtype=np.int32))     # 2 blocks
    _drain(sched)
    free0 = alloc.free_blocks
    sched.reserve(1, 24)                                  # 3 more blocks
    assert alloc.free_blocks == free0 - 3
    assert len(sched.rollback_reserved(1)) == 3 and alloc.free_blocks == free0
    sched.add_tokens(2, np.arange(16, dtype=np.int32))     # exactly 2 blocks
    _drain(sched)
    sched.reserve(2, 16)
    assert len(sched.rollback_reserved(2)) == 2 and len(sched.seqs[2].blocks) == 2
    assert sched.rollback_reserved(2) == []
    sched.reserve(2, 8)
    tail = sched.seqs[2].blocks[-1]
    alloc.share([tail])
    with pytest.raises(RuntimeError, match="shared block"):
        sched.rollback_reserved(2)
    assert alloc.ref_count(tail) == 2
    alloc.free([tail])
    sched.flush(1)
    sched.flush(2)
    assert alloc.free_blocks == alloc.total_blocks


def test_do_sample_bypasses_spec_with_one_warning(engines):
    spec, _, _ = engines
    spec._spec_warned_sampling = False
    spec.put([0], [PROMPTS[0]])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pipe = spec.decode_pipeline([0], do_sample=True, temperature=0.9)
        assert isinstance(pipe, DecodePipeline)
        assert len(w) == 1 and "greedy-only" in str(w[0].message)
    assert pipe.run(4).shape == (1, 4)
    spec.flush([0])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        outs = spec.generate(PROMPTS[:2], max_new_tokens=5, do_sample=True, top_k=8)
        assert len(w) == 0
    assert [len(o) for o in outs] == [len(p) + 5 for p in PROMPTS[:2]]
    spec.put([0], [PROMPTS[0]])
    assert isinstance(spec.decode_pipeline([0]), SpecDecodePipeline)
    spec.flush([0])
    assert spec.free_blocks == spec.allocator.total_blocks


def test_generate_tail_at_max_context_degrades(engines):
    """max_context = prompt + max_new + 2: the plain path fits, a verify
    step (k + 1 positions ahead) stops fitting near the end, and the tail
    runs on the plain pipeline instead of raising."""
    _, plain, model = engines
    ctx = len(LOOP) + 24 + 2
    state = {**STATE, "max_context": ctx}
    ref = _port(model, spec=False, state=state).generate([LOOP], max_new_tokens=24)
    e = _port(model, state=state)
    got = e.generate([LOOP], max_new_tokens=24)
    assert len(got[0]) == len(ref[0])
    _same_or_near_tie(model, LOOP, got[0][len(LOOP):], ref[0][len(LOOP):])
    assert e.spec_stats.steps > 0 and e.free_blocks == e.allocator.total_blocks


def test_on_tokens_retirement_and_exception_settle(engines):
    spec, _, _ = engines
    spec.put([0, 1], PROMPTS[:2])
    pipe = spec.decode_pipeline([0, 1])
    seen = {0: [], 1: []}

    def on_tokens(step, uids, toks):
        for i, u in enumerate(uids):
            seen[u].extend(int(t) for t in toks[i])
        return [1] if len(seen[1]) >= 4 else None

    got = pipe.run(8, on_tokens=on_tokens)
    assert pipe.uids == [0]
    assert spec.scheduler.seqs[1].seen_tokens == len(PROMPTS[1]) + len(got[1])
    assert 1 not in spec._last_ref

    def boom(step, uids, toks):
        if step == 1:
            raise RuntimeError("client hung up")

    with pytest.raises(RuntimeError, match="client hung up"):
        pipe.run(6, on_tokens=boom)
    assert pipe.uids == []
    seq = spec.scheduler.seqs[0]
    assert len(seq.blocks) == -(-seq.seen_tokens // BS)
    spec.flush([0, 1])
    assert spec.free_blocks == spec.allocator.total_blocks


def test_stats_and_monitor_events(engines):
    spec, _, _ = engines
    spec.put([0, 1], [PROMPTS[0], LOOP])
    spec.spec_stats.reset()
    spec.decode_pipeline([0, 1]).run(5)
    st = spec.spec_stats
    assert st.steps == 5 and st.tokens >= 10 and st.fetch_bytes > 0
    sink = type("Sink", (), {"events": [], "write_events": lambda self, ev: self.events.extend(ev)})()
    spec.write_monitor_events(sink, step=2)
    names = {n for n, _, _ in sink.events}
    for f in ("steps", "proposed", "accepted", "tokens", "acceptance_rate", "tokens_per_step",
              "draft_ms_per_step", "verify_ms_per_step", "fetch_bytes_per_step"):
        assert f"serve/spec/{f}" in names
    spec.flush([0, 1])


def test_window_model_refused_in_jax_words(weights):
    conf = {"state_manager": STATE, **POOL, "spec_decode": {"enabled": True, "k": K}}
    spec = type("Spec", (), {"window": 32, "head_dim": 128, "num_kv_heads": 2,
                             "alibi": False, "moe": None})()
    with pytest.raises(NotImplementedError) as jax_err:
        JaxAttention.validate_engine_build(spec, JaxConfig.load(conf))
    windowed = LlamaForCausalLM(LlamaConfig(**LLAMA, sliding_window=32), device="cpu", seed=2)
    with pytest.raises(NotImplementedError) as port_err:
        InferenceEngineV2(windowed, {**conf, "dtype": torch.float32}, windowed.flat_params(),
                          device="cpu")
    assert str(port_err.value) == str(jax_err.value)
    assert "sliding-window" in str(port_err.value)
