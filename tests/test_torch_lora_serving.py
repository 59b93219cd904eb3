"""The port's multi-tenant LoRA serving (the grouped delta in
``ragged_model``'s decode and verify steps, the engine's registry, rank
bucket and step caches, ``DecodePipeline`` and ``SpecDecodePipeline`` with
adapters) against the JAX engine on the same converted weights, pool, page
table and adapters (the JAX test's ``_adapter_state`` recipe), and against
the port's own runs.

- ``build_decode_step`` and ``build_verify_step`` with ``lora_targets``
  (and the per-step-write burst) against the JAX package's: f32 logits
  within 1e-4, over a mixed binding (ranks 2 and 3, a base row, a pad
  row), the default ("q", "v"), all four targets, and an int8 pool.
- Mixed-batch streams bit-equal to the same rows' runs at the same bucket
  with every other row unbound; per-adapter sequential runs (bucket 1) and
  the JAX engine's streams equal, or parting only at a near-tie (the top-2
  gap of the reference run's own logits under 1e-4: f32 sums in another
  order at another M agree to ~1e-6).
- An adapter's stream differs from the base stream; a rank-0 adapter is
  inert and owns no pages; adapter churn adds no entry to the step caches
  (the port's analogue of the JAX engine's zero compiles); refcounts, pool
  pages and pinned buffers return to baseline; spec decode with adapters
  against plain LoRA streams; the ``lora`` config refusals in the JAX
  package's words; ``decode_steps`` refusing adapter-bound rows; and the
  prefix cache never filing a tenant's decode-written KV.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.config_v2 import LoraConfig as JaxLoraConfig
from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JaxConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.pipeline import DecodePipeline as JaxPipeline
from deepspeed_tpu.inference.v2.ragged_model import \
    build_multistep_decode as jax_multistep
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.module_inject.lora import load_lora_adapter as jax_load
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import DecodePipeline, InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.config_v2 import (LoraConfig,
                                                        RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
from deepspeed_tpu_torch.inference.v2.ragged_model import (LORA_TARGETS,
                                                           build_multistep_decode)
from deepspeed_tpu_torch.inference.v2.spec import SpecDecodePipeline
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.module_inject import load_lora_adapter

from tests._torch_threads import one_torch_thread  # noqa: F401

K = 3
LOGITS_ATOL = 1e-4
TIE = 1e-4
LLAMA = dict(vocab_size=128, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=256)
STATE = {"max_tracked_sequences": 8, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 40, "prefill_chunk_size": 16, "max_context": 128}
POOL = {"kv_cache": {"block_size": 16, "num_blocks": 40}}
INT8_POOL = {"kv_cache": {"block_size": 64, "num_blocks": 12}, "kv_quant": {"enabled": True}}
LORA = {"enabled": True, "pool_pages": 8, "max_rank": 4, "swap_buffers": 8}
PROMPTS = [np.array([3, 14, 15, 92, 6, 53, 58, 97, 93, 23, 84, 62], np.int32),
           np.array([27, 18, 28, 18, 28, 45, 90, 45, 23], np.int32),
           np.array([31, 41, 59, 26, 53, 58, 97, 93, 23, 84, 62, 64, 33, 83, 27, 95, 2], np.int32),
           np.array([1, 61, 80, 33, 98, 87, 4], np.int32)]
BINDS = ["t-a", None, "t-b", "t-a"]
# a prompt repeating one span: n-gram drafts match from the first step
LOOP = np.tile(np.array([7, 1, 88, 3, 41, 9], np.int32), 4)


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


def _conf(lora=LORA, targets=("q", "v"), pool=POOL, **extra):
    conf = {"state_manager": STATE, **pool, **extra}
    if lora:
        conf["lora"] = {**lora, "targets": targets}
    return conf


def _port(model, **kw):
    return InferenceEngineV2(model, {**_conf(**kw), "dtype": torch.float32},
                             model.flat_params(), device="cpu")


def _jax(jax_model, flat, **kw):
    return JaxEngine(model=jax_model, model_parameters=_tree(flat),
                     config={**_conf(**kw), "dtype": jnp.float32})


def _adapter_state(spec, targets, rank, seed, scale=0.2):
    """The JAX test's recipe: a seeded random adapter whose 0.2 scale is
    large against the random base weights, so adapter streams diverge from
    base streams."""
    douts = {"q": spec.num_heads * spec.head_dim, "k": spec.num_kv_heads * spec.head_dim,
             "v": spec.num_kv_heads * spec.head_dim, "o": spec.hidden_size}
    dins = {"q": spec.hidden_size, "k": spec.hidden_size, "v": spec.hidden_size,
            "o": spec.num_heads * spec.head_dim}
    g = np.random.RandomState(seed)
    state = {"alpha": float(rank)}
    for t in targets:
        state[t] = {"A": (g.standard_normal((dins[t], rank)) * scale).astype(np.float32),
                    "B": (g.standard_normal((rank, douts[t])) * scale).astype(np.float32)}
    return state


def _load(engine, load=load_lora_adapter, adapters=(("t-a", 2, 7), ("t-b", 3, 8))):
    targets = engine.config.lora.targets
    for name, rank, seed in adapters:
        load(engine, name, _adapter_state(engine.spec, targets, rank, seed))


@pytest.fixture(scope="module")
def lora_engine(weights):
    """One ("q", "v") LoRA engine shared by the stream tests, adapters t-a
    (rank 2) and t-b (rank 3): rank bucket 4."""
    e = _port(weights[2])
    _load(e)
    return e


def _bind(engine, uids, binds):
    for u, a in zip(uids, binds):
        if a is not None:
            engine.lora.acquire(u, a)


def _unbind(engine, uids, binds):
    for u, a in zip(uids, binds):
        if a is not None:
            engine.lora.release(u)


def _run(engine, prompts, binds, n, uids=None, steps=None):
    """One pipeline run of ``prompts`` under ``binds`` (prefill, ``n``
    decode steps, flush, release). Returns (streams [S, n], each step's
    logits [n, S, V] of the live rows, when ``steps`` is a list: the
    stream's step logits are appended there)."""
    uids = list(range(10, 10 + len(prompts))) if uids is None else uids
    logged = []
    fn = engine._decode_step_fn

    def logging_fn(rb=0):
        step = fn(rb)

        def call(*a, **kw):
            nxt, logits = step(*a, **kw)
            logged.append(logits[:len(prompts)].clone())
            return nxt, logits
        return call

    _bind(engine, uids, binds)
    engine._decode_step_fn = logging_fn
    try:
        engine._put_nofetch(uids, prompts)
        out = DecodePipeline(engine, uids).run(n)
        engine.flush(uids)
    finally:
        del engine._decode_step_fn
        _unbind(engine, uids, binds)
    return out, torch.stack(logged)


def _same_or_near_tie(got, ref, ref_logits):
    """Streams equal, or each row's first difference where the reference
    run's own logits at that step have a top-2 gap under the limit."""
    for i in range(len(ref)):
        diff = np.flatnonzero(np.asarray(got[i]) != np.asarray(ref[i]))
        if diff.size:
            top = torch.topk(ref_logits[diff[0], i], 2).values
            gap = float(top[0] - top[1])
            assert gap < TIE, f"row {i} parts at step {diff[0]} where the top-2 gap is {gap}"


# --------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kw", [{"targets": ("q", "w_up")}, {"targets": ()},
                                {"max_rank": 0}, {"pool_pages": 4, "max_rank": 8},
                                {"swap_buffers": 0}])
def test_lora_config_refusals_in_jax_words(kw):
    with pytest.raises(ValueError) as port_err:
        LoraConfig(**kw)
    with pytest.raises(ValueError) as jax_err:
        JaxLoraConfig(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_check_slice_no_longer_refuses_lora():
    cfg = RaggedInferenceEngineConfig.load({"lora": {"enabled": True, "targets": ["q", "k"]}})
    assert cfg.lora.enabled and cfg.lora.targets == ("q", "k")
    assert (RaggedInferenceEngineConfig.load({"lora": {"enabled": True}}).lora.targets
            == JaxConfig.load({"lora": {"enabled": True}}).lora.targets == ("q", "v"))
    with pytest.raises(NotImplementedError) as port_err:
        RaggedInferenceEngineConfig.load({"lora": {"enabled": True}, "tensor_parallel": 2})
    assert "multi-tenant LoRA with tensor_parallel > 1 is not wired" in str(port_err.value)


# --------------------------------------------------------------------- #
# the steps against the JAX package's
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("targets, pool", [(("q", "v"), "f32"), (LORA_TARGETS, "f32"),
                                           (LORA_TARGETS, "int8")])
def test_lora_steps_match_jax(weights, targets, pool):
    """Three live rows in a bucket of 4 (t-a rank 2, a base row, t-b rank
    3; one pad row) at rank bucket 4: the decode step, then the verify step
    (row 0 drafting its greedy continuation, row 1 one token, row 2 none),
    both within 1e-4 of the JAX engine's, and the written KV too (int8: one
    step, scales within 1e-5 relative). The pool and page tables are the
    same bytes in both."""
    jax_model, flat, port_model = weights
    extra = {"pool": POOL if pool == "f32" else INT8_POOL, "targets": targets}
    port, jeng = _port(port_model, **extra), _jax(jax_model, flat, **extra)
    _load(port)
    _load(jeng, load=jax_load)
    assert port.lora_rank_bucket == jeng.lora_rank_bucket == 4
    uids, binds = [0, 1, 2], BINDS[:3]
    _bind(port, uids, binds)
    _bind(jeng, uids, binds)
    prompts = PROMPTS[:3]
    lg = port.put(uids, prompts)
    np.testing.assert_allclose(lg, jeng.put(uids, prompts), rtol=0, atol=LOGITS_ATOL)
    db = port.scheduler.decode_batch(uids, K + 3, port.scratch_block)
    jdb = jeng.scheduler.decode_batch(uids, K + 3, jeng.scratch_block)
    assert (db.block_tables == np.asarray(jdb.block_tables)).all()
    lora = port._lora_operands(uids, db.bucket)
    jlora = jeng._lora_operands(uids, jdb.bucket)
    assert np.array_equal(lora["adapter_pt"].numpy(), np.asarray(jlora[1]))
    assert np.array_equal(lora["lora_pool"].numpy(), np.asarray(jlora[0]))
    ids = np.zeros((4,), np.int32)
    ids[:3] = np.argmax(lg, axis=-1)
    ids[3] = ids[0]
    pos, bt = to_device(db.positions, "cpu"), to_device(db.block_tables, "cpu")
    # the verify step runs from this state too (over int8 pages a decode
    # step's K/V may land one int8 step apart in the two packages)
    saved = (port.kv.kv.clone(), None if port.kv.scales is None else port.kv.scales.clone())
    jsaved = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), jeng.kv.kv)
    nxt, logits = port._decode_step_fn(4)(
        port.weights, port.kv.kv, torch.from_numpy(ids), pos, bt, pos + 1, None, False, 0,
        1.0, kv_scales=port.kv.scales, **lora)
    jnxt, jlogits, new_kv = jeng._decode_step_prog(jdb.bucket, False, 0, 4)(
        jeng.weights, jeng.kv.kv, jnp.asarray(ids), jdb.positions, jnp.asarray(jdb.block_tables),
        jdb.ctx_lens, jax.random.PRNGKey(0), jnp.float32(1.0), *jlora)
    jeng.kv.update(new_kv)
    np.testing.assert_allclose(logits[:3].numpy(), np.asarray(jlogits)[:3], rtol=0,
                               atol=LOGITS_ATOL)
    # the deltas are real: the base step's logits are far off on bound rows
    _, base = port._decode_step_fn(0)(
        port.weights, port.kv.kv.clone(), torch.from_numpy(ids), pos, bt, pos + 1,
        kv_scales=None if port.kv.scales is None else port.kv.scales.clone())
    far = (base - logits).abs().amax(-1)
    assert far[0] > 100 * LOGITS_ATOL and far[2] > 100 * LOGITS_ATOL
    assert torch.equal(base[1], logits[1])          # the zero page adds +0
    # the verify step over the same current tokens: row 0 drafts the decode
    # step's token (accepted), row 1 a token, row 2 none
    port.kv.kv.copy_(saved[0])
    if saved[1] is not None:
        port.kv.scales.copy_(saved[1])
    jeng.kv.update(jsaved)
    draft = np.zeros((4, K), np.int32)
    draft[0] = [int(nxt[0])] * K
    draft[1, 0] = 5
    n_draft = np.array([K, 1, 0, 0], np.int32)
    accept, vnext, final = port._verify_fn(K, 4)(
        port.weights, port.kv.kv, torch.from_numpy(ids), torch.from_numpy(draft),
        torch.from_numpy(n_draft), pos, bt, pos + 1, kv_scales=port.kv.scales, **lora)
    jaccept, jvnext, jfinal, new_kv = jeng._verify_prog(jdb.bucket, K, 4)(
        jeng.weights, jeng.kv.kv, jnp.asarray(ids), jnp.asarray(draft), jnp.asarray(n_draft),
        jdb.positions, jnp.asarray(jdb.block_tables), jdb.ctx_lens, *jlora)
    jeng.kv.update(new_kv)
    accept, jaccept = accept.numpy(), np.asarray(jaccept)
    assert accept[0, 0] >= 1                  # the decode step's own token
    for i in range(3):
        if accept[0, i] == jaccept[0, i]:
            np.testing.assert_allclose(final[i].numpy(), np.asarray(jfinal)[i], rtol=0,
                                       atol=LOGITS_ATOL)
        else:
            # an accept decision at a near-tie of the port's own logits
            assert abs(accept[0, i] - jaccept[0, i]) == 1
    pages = port.fetch_pages([b for u in uids for b in port.scheduler.seqs[u].blocks])
    jpages = jeng.fetch_pages([b for u in uids for b in jeng.scheduler.seqs[u].blocks])
    if pool == "f32":
        np.testing.assert_allclose(pages, np.asarray(jpages), rtol=0, atol=LOGITS_ATOL)
    else:
        (vals, scales), (jvals, jscales) = (port._unpack_pages(np.asarray(x))
                                            for x in (pages, jpages))
        assert np.abs(vals.astype(np.int16) - jvals).max() <= 1
        np.testing.assert_allclose(scales, jscales, rtol=1e-5, atol=0)
    _unbind(port, uids, binds)


def test_lora_burst_builder_matches_jax(weights):
    """The per-step-write burst with ``lora_targets`` (the builders' LoRA
    loop, which the engine's bursts do not take) against the JAX
    package's: 3 steps, all four targets, the same ids and logits."""
    jax_model, flat, port_model = weights
    port = _port(port_model, targets=LORA_TARGETS)
    jeng = _jax(jax_model, flat, targets=LORA_TARGETS)
    _load(port)
    _load(jeng, load=jax_load)
    uids, binds = [0, 1, 2], BINDS[:3]
    _bind(port, uids, binds)
    _bind(jeng, uids, binds)
    lg = port.put(uids, PROMPTS[:3])
    jeng.put(uids, PROMPTS[:3])
    db = port.scheduler.decode_batch(uids, 4, port.scratch_block)
    jdb = jeng.scheduler.decode_batch(uids, 4, jeng.scratch_block)
    ids = np.zeros((4,), np.int32)
    ids[:3] = np.argmax(lg, axis=-1)
    pos = to_device(db.positions, "cpu")
    fn = build_multistep_decode(port.spec, 3, lora_targets=LORA_TARGETS)
    out, final = fn(port.weights, port.kv.kv, torch.from_numpy(ids), pos,
                    to_device(db.block_tables, "cpu"), pos + 1,
                    **port._lora_operands(uids, db.bucket))
    jfn = jax.jit(jax_multistep(jeng.spec, 3, lora_targets=LORA_TARGETS))
    jout, jfinal, _ = jfn(jeng.weights, jeng.kv.kv, jnp.asarray(ids), jdb.positions,
                          jnp.asarray(jdb.block_tables), jdb.ctx_lens, jax.random.PRNGKey(0),
                          jnp.float32(1.0), *jeng._lora_operands(uids, jdb.bucket))
    assert out[:, :3].tolist() == np.asarray(jout)[:, :3].tolist()
    np.testing.assert_allclose(final[:3].numpy(), np.asarray(jfinal)[:3], rtol=0,
                               atol=LOGITS_ATOL)
    with pytest.raises(ValueError, match="needs both"):
        fn(port.weights, port.kv.kv, torch.from_numpy(ids), pos,
           to_device(db.block_tables, "cpu"), pos + 1)
    with pytest.raises(ValueError, match="non-LoRA step"):
        port._decode_step_fn(0)(port.weights, port.kv.kv, torch.from_numpy(ids), pos,
                                to_device(db.block_tables, "cpu"), pos + 1,
                                **port._lora_operands(uids, db.bucket))
    _unbind(port, uids, binds)


# --------------------------------------------------------------------- #
# streams
# --------------------------------------------------------------------- #

N = 6


@pytest.fixture(scope="module")
def mixed(lora_engine):
    """The mixed run: 4 rows [t-a, base, t-b, t-a] at bucket 4."""
    return _run(lora_engine, PROMPTS, BINDS, N)


def test_mixed_rows_bit_equal_to_single_binding_runs(lora_engine, mixed):
    """Each bound row of the mixed batch equals, bit for bit (stream and
    every step's logits), the same batch with every other row unbound."""
    out, logits = mixed
    for i, a in enumerate(BINDS):
        if a is None:
            continue
        only = [a if j == i else None for j in range(len(BINDS))]
        got, got_logits = _run(lora_engine, PROMPTS, only, N)
        assert got[i].tolist() == out[i].tolist()
        assert torch.equal(got_logits[:, i], logits[:, i])
    # the unbound row equals the all-unbound batch's, bit for bit
    base, base_logits = _run(lora_engine, PROMPTS, [None] * 4, N)
    assert base[1].tolist() == out[1].tolist()
    assert torch.equal(base_logits[:, 1], logits[:, 1])
    # and an adapter's stream differs from the base stream
    assert base[0].tolist() != out[0].tolist() and base[2].tolist() != out[2].tolist()


def test_mixed_rows_against_sequential_runs(lora_engine, mixed):
    """Per-adapter sequential runs (one row, bucket 1) as the JAX test's
    oracle: equal, or parting only at a near-tie."""
    out, logits = mixed
    for i, (p, a) in enumerate(zip(PROMPTS, BINDS)):
        ref, ref_logits = _run(lora_engine, [p], [a], N, uids=[90 + i])
        _same_or_near_tie(out[i:i + 1], ref, ref_logits)
        torch.testing.assert_close(logits[:, i], ref_logits[:, 0], rtol=0, atol=LOGITS_ATOL)


def test_mixed_streams_match_jax_engine(weights, mixed):
    jax_model, flat, _ = weights
    jeng = _jax(jax_model, flat)
    _load(jeng, load=jax_load)
    uids = [10, 11, 12, 13]
    _bind(jeng, uids, BINDS)
    jeng._put_nofetch(uids, PROMPTS)
    ref = JaxPipeline(jeng, uids).run(N)
    out, logits = mixed
    for i in range(4):
        diff = np.flatnonzero(np.asarray(out[i]) != np.asarray(ref[i]))
        if diff.size:
            top = torch.topk(logits[diff[0], i], 2).values
            assert float(top[0] - top[1]) < TIE


def test_rank0_adapter_is_inert_and_pageless(lora_engine):
    e = lora_engine
    load_lora_adapter(e, "t-zero", {})
    assert e.lora.rank("t-zero") == 0 and e.lora.is_resident("t-zero")
    free0 = e.lora.pool.free_pages
    base, base_logits = _run(e, PROMPTS[:2], [None, None], N)
    got, got_logits = _run(e, PROMPTS[:2], ["t-zero", None], N)
    assert got.tolist() == base.tolist() and torch.equal(got_logits, base_logits)
    assert e.lora.pool.free_pages == free0
    e.lora.unregister("t-zero")


def test_churn_adds_no_step_and_restores_byte_exact(lora_engine):
    """Register, fault in, serve, evict, restore and unregister adapters
    inside the rank bucket: the step caches gain no entry, an evicted
    adapter's pages and stream come back bit for bit, and refcounts, pool
    pages and pinned buffers return to baseline after a drain."""
    e = lora_engine
    p = PROMPTS[2]
    ref, ref_logits = _run(e, [p], ["t-a"], N, uids=[40])
    steps, verifies = len(e._lora_steps), len(e._verify_fns)
    pages = e.lora.pool.fetch_pages(e.lora._adapters["t-a"].page_ids)
    e.lora.evict("t-a")
    assert not e.lora.is_resident("t-a") and e.lora.swap.outstanding == 2
    load_lora_adapter(e, "t-c", _adapter_state(e.spec, ("q", "v"), 4, seed=9))
    assert e.lora.rank_bucket == 4
    _run(e, [p, p], ["t-c", "t-b"], 3, uids=[41, 42])
    got, got_logits = _run(e, [p], ["t-a"], N, uids=[43])      # faults back in
    assert got.tolist() == ref.tolist() and torch.equal(got_logits, ref_logits)
    back = e.lora.pool.fetch_pages(e.lora._adapters["t-a"].page_ids)
    assert torch.equal(back, pages)
    e.lora.unregister("t-c")
    assert (len(e._lora_steps), len(e._verify_fns)) == (steps, verifies)
    e.lora.drain_swap()
    resident = sum(e.lora.rank(n) for n in e.lora.names if e.lora.is_resident(n))
    assert e.lora.pool.free_pages + resident == e.lora.pool.num_pages
    assert all(e.lora.refcount(n) == 0 for n in e.lora.names)
    assert e.lora.swap.outstanding == 0
    assert e.free_blocks == e.allocator.total_blocks
    sink = type("Sink", (), {"events": [],
                             "write_events": lambda self, ev: self.events.extend(ev)})()
    e.write_monitor_events(sink, step=3)
    names = {n for n, _, _ in sink.events}
    assert {"serve/lora/faults", "serve/lora/evictions", "serve/lora/t-a/swap_bytes",
            "serve/lora/hit_fraction"} <= names
    assert e.lora.stats.adapters["t-a"].evictions >= 1


def test_spec_decode_with_adapters_matches_plain_lora(weights, lora_engine):
    """Spec decode (k = 3) with adapters against the plain LoRA pipeline:
    equal, or parting at a near-tie of the plain run's logits; drafts are
    accepted on the looping prompt."""
    _, _, model = weights
    spec = _port(model, spec_decode={"enabled": True, "k": K})
    _load(spec)
    prompts = [PROMPTS[0], LOOP, PROMPTS[2]]
    binds = ["t-a", "t-b", None]
    n = 12
    ref, ref_logits = _run(lora_engine, prompts, binds, n)
    uids = [20, 21, 22]
    _bind(spec, uids, binds)
    spec._put_nofetch(uids, prompts)
    pipe = spec.decode_pipeline(uids)
    assert isinstance(pipe, SpecDecodePipeline)
    got = pipe.run(n)
    spec.flush(uids)
    _unbind(spec, uids, binds)
    assert spec.spec_stats.accepted > 0
    _same_or_near_tie([g[:n] for g in got], ref, ref_logits)
    assert spec.free_blocks == spec.allocator.total_blocks


# --------------------------------------------------------------------- #
# bursts and the prefix cache
# --------------------------------------------------------------------- #

def test_decode_steps_refuses_adapter_bound_rows(lora_engine):
    """The JAX package's bursts take no LoRA operands and decode a bound
    row as the base model; the port refuses the row by name. A rank-0
    binding has no delta to lose and bursts."""
    e = lora_engine
    load_lora_adapter(e, "t-zero", {})
    uids = [60, 61, 62]
    _bind(e, uids, ["t-b", None, "t-zero"])
    e._put_nofetch(uids, PROMPTS[:3])
    with pytest.raises(NotImplementedError, match=r"uids \[60\].*\['t-b'\]"):
        e.decode_steps(uids, 2)
    assert e.decode_steps(uids[1:], 2).shape == (2, 2)
    e.flush(uids)
    _unbind(e, uids, ["t-b", None, "t-zero"])
    e.lora.unregister("t-zero")


def test_prefix_cache_never_files_a_tenants_decode_kv(weights):
    """Tenant t-a decodes after prompt P and is flushed with the prefix
    cache on; then P + t-a's tokens is served unbound, cache on and cache
    off. The tree holds no more of it than P (the scheduler seals a
    sequence's history where decoding begins), so both give the base
    model's logits; t-a's own logits there are far from them. The port
    keeps ``lora`` with ``prefix_cache`` for that reason."""
    _, _, model = weights
    on = _port(model, prefix_cache={"enabled": True})
    off = _port(model)
    _load(on)
    p = np.concatenate([PROMPTS[0], PROMPTS[2]])           # 29 tokens: a partial page
    toks, tenant_logits = _run(on, [p], ["t-a"], 8, uids=[70])
    follow = np.concatenate([p, toks[0]]).astype(np.int32)
    m = on.prefix_cache.match(follow)
    assert 0 < m.n_cached <= len(p)
    got = on.put([71], [follow])
    ref = off.put([71], [follow])
    assert on.prefix_cache.stats.tokens_saved > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGITS_ATOL)
    # the leak this guards against would be visible: t-a's own last logits
    # (its decode KV, its delta) are far from the base model's
    assert np.abs(tenant_logits[-1, 0].numpy() - ref[0]).max() > 100 * LOGITS_ATOL
    on.flush([71])
    off.flush([71])
