"""The port's multi-replica serving (deepspeed_tpu_torch.inference.v2.serving
router.py + cluster.py): its own copies of the JAX package's router gates
(tests/unit/test_serving_router.py), by name, on tiny port engines on the
CPU — cache-aware routing over the shared radix-prefix chain index,
federated SLO admission, the disaggregated prefill->decode handoff over the
KV page fabric, replica-labelled observability, and named replica-failure
surfacing."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.config_v2 import RouterConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2, SpecDecodeStats
from deepspeed_tpu_torch.inference.v2.prefix_cache import (RadixPrefixCache,
                                                           ROOT_CHAIN, chain_hash)
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import \
    BlockedAllocator
from deepspeed_tpu_torch.inference.v2.serving import (ClusterPrefixIndex,
                                                      PoissonLoadGen,
                                                      ServingCluster, ServingRouter,
                                                      WorkloadComponent)
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.monitor.serving import FrontendStats, RouterStats

from tests._torch_threads import one_torch_thread  # noqa: F401

# relaxed SLOs: correctness tests must not shed on a slow CI box; the
# federation decision logic is tested directly against warmed cost models
_CLASSES = [{"name": "hi", "priority": 2,
             "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6},
            {"name": "lo", "priority": 0,
             "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6}]
_SERVING = {"decode_slice": 4, "idle_wait_s": 0.005, "classes": _CLASSES}


def _model_and_params(seed=0):
    cfg = LlamaConfig.tiny(vocab_size=128, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    return model, model.flat_params()


@pytest.fixture(scope="module")
def model_params():
    return _model_and_params()


def _build_engine(model_params, num_blocks=24, prefix_cache=False):
    model, params = model_params
    econf = {"dtype": torch.float32,
             "state_manager": {"max_tracked_sequences": 8,
                               "max_ragged_sequence_count": 4,
                               "max_ragged_batch_size": 96,
                               "max_context": 176,
                               "prefill_chunk_size": 32},
             "kv_cache": {"block_size": 16, "num_blocks": num_blocks},
             "serving": dict(_SERVING)}
    if prefix_cache:
        econf["prefix_cache"] = {"enabled": True}
    return InferenceEngineV2(model, econf, params, device="cpu")


def _rng():
    return np.random.RandomState(0)


def _prompt(rng, n):
    return rng.randint(0, 128, size=(n,)).astype(np.int32)


def _direct_stream(engine, prompt, n):
    """Reference: the same prompt through a bare DecodePipeline run —
    router streams must be byte-identical wherever they were placed."""
    uid = 95_000 + _direct_stream.k
    _direct_stream.k += 1
    engine._put_nofetch([uid], [np.asarray(prompt, np.int32)])
    out = engine.decode_pipeline([uid]).run(n)
    engine.flush([uid])
    return [int(t) for t in out[0]]


_direct_stream.k = 0


# --------------------------------------------------------------------------- #
# the KV page fabric, below the router (satellite: cross-engine handoff)
# --------------------------------------------------------------------------- #

def test_cross_engine_kv_handoff_byte_exact(model_params):
    """Pages fetch_pages'd out of engine A restore byte-exact into engine B
    — independent pools, different block ids — the continuation stream is
    byte-identical to a single-engine run, and refcounts/free-blocks return
    to baseline on BOTH sides after the sequence retires."""
    a = _build_engine(model_params)
    b = _build_engine(model_params)
    rng = _rng()
    p = _prompt(rng, 40)
    ref = _direct_stream(a, p, 8)
    free_a, free_b = a.free_blocks, b.free_blocks

    # occupy low block ids on B so the import cannot land on A's ids
    b.put([1], [_prompt(rng, 40)])
    a._put_nofetch([7], [p])
    a_blocks = list(a.scheduler.seqs[7].blocks)
    a_pages = [a.fetch_page(blk) for blk in a_blocks]
    pages, logits = a.export_kv(7)
    assert a.free_blocks == free_a          # A released everything at export
    assert 7 not in a.scheduler.seqs

    ids = b.import_kv(7, p, pages, logits)
    assert ids != a_blocks                  # genuinely different block ids
    for blk, page in zip(ids, a_pages):     # fabric contract: bytes exact
        assert np.array_equal(b.fetch_page(blk), page)
        assert b.allocator.ref_count(blk) == 1
    # the imported sequence decodes byte-identically to the A-native run
    out = b.decode_pipeline([7]).run(8)
    assert [int(t) for t in out[0]] == ref
    b.flush([7])
    b.flush([1])
    assert b.free_blocks == free_b
    assert a.free_blocks == free_a


def test_import_kv_rejects_mismatched_layout(model_params):
    a = _build_engine(model_params)
    rng = _rng()
    a._put_nofetch([3], [_prompt(rng, 20)])
    pages, logits = a.export_kv(3)
    with pytest.raises(ValueError, match="page layout"):
        a.import_kv(4, _prompt(rng, 20), pages[:, :, :, :, :8], logits)
    # a failed import allocated nothing
    assert a.free_blocks == a.allocator.total_blocks


# --------------------------------------------------------------------------- #
# prefix-cache delta feed + the shared chain index
# --------------------------------------------------------------------------- #

def test_prefix_cache_match_len_and_deltas():
    alloc = BlockedAllocator(16)
    cache = RadixPrefixCache(alloc, block_size=4)
    deltas = []
    cache.add_listener(lambda op, chain: deltas.append((op, chain)))
    toks = list(range(10))                   # 2 full blocks + partial tail
    blocks = [int(x) for x in alloc.allocate(3)]
    cache.insert(toks, blocks, transfer_refs=True)
    assert [op for op, _ in deltas] == ["insert", "insert"]  # partials silent
    # match_len is pure: no refcount, no stats, no LRU movement
    lookups0, refs0 = cache.stats.lookups, alloc.ref_count(blocks[0])
    assert cache.match_len(toks) == 8
    assert cache.match_len(toks[:5]) == 4
    assert cache.match_len(toks[:4]) == 0    # capped at len - 1
    assert cache.match_len([99, 98, 97, 96, 95]) == 0
    assert cache.stats.lookups == lookups0
    assert alloc.ref_count(blocks[0]) == refs0
    # chain hashes commit to the whole path
    c1 = chain_hash(ROOT_CHAIN, tuple(toks[:4]))
    c2 = chain_hash(c1, tuple(toks[4:8]))
    assert {c for _, c in deltas} == {c1, c2}
    # eviction emits the same chains back out (leaves first)
    cache.evict(4)
    evicted = [c for op, c in deltas if op == "evict"]
    assert set(evicted) == {c1, c2}
    # late listener replay sees only what is still cached (nothing)
    replayed = []
    cache.add_listener(lambda op, chain: replayed.append((op, chain)))
    assert replayed == []


def test_cluster_prefix_index_membership():
    idx = ClusterPrefixIndex(block_size=4)
    toks = list(range(12))
    c1 = chain_hash(ROOT_CHAIN, tuple(toks[:4]))
    c2 = chain_hash(c1, tuple(toks[4:8]))
    idx.apply("r0", "insert", c1)
    idx.apply("r0", "insert", c2)
    idx.apply("r1", "insert", c1)
    assert idx.match(toks) == {"r0": 8, "r1": 4}
    assert idx.match(toks[:5]) == {"r0": 4, "r1": 4}
    assert idx.match(toks[:4]) == {}         # capped at len - 1
    idx.apply("r0", "evict", c2)
    assert idx.match(toks) == {"r0": 4, "r1": 4}
    idx.apply("r0", "evict", c1)
    idx.apply("r1", "evict", c1)
    assert idx.match(toks) == {} and idx.chains == 0


# --------------------------------------------------------------------------- #
# routing: round robin, cache-aware stickiness, balance knob
# --------------------------------------------------------------------------- #

def test_round_robin_routes_evenly_streams_byte_identical(model_params):
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    rng = _rng()
    prompts = [_prompt(rng, n) for n in (24, 9, 40, 17)]
    refs = [_direct_stream(e0, p, 6) for p in prompts]
    cluster = ServingCluster([e0, e1], serving=_SERVING)
    with ServingRouter(cluster, {"policy": "round_robin"}) as rt:
        hs = [rt.submit(p, priority="hi", max_new_tokens=6) for p in prompts]
        assert rt.drain(timeout=60)
        assert rt.stats.routed == {"r0": 2, "r1": 2}
        for h, ref in zip(hs, refs):
            assert h.status == "finished" and h.tokens == ref
    assert e0.free_blocks == e0.allocator.total_blocks
    assert e1.free_blocks == e1.allocator.total_blocks


def test_cache_aware_routing_sticks_to_warm_replica(model_params):
    """After one request warms r0's radix tree with a shared prefix, later
    requests carrying the prefix route to r0 (longest cached match) while a
    cold prompt still goes to the less-loaded r1."""
    e0 = _build_engine(model_params, prefix_cache=True)
    e1 = _build_engine(model_params, prefix_cache=True)
    rng = _rng()
    shared = _prompt(rng, 48)
    cluster = ServingCluster([e0, e1], serving=_SERVING)
    with ServingRouter(cluster, {"policy": "cache_aware",
                                 "balance": 4.0}) as rt:
        h0 = rt.submit(np.concatenate([shared, [1, 2]]), priority="hi",
                       max_new_tokens=4)
        assert h0.result(timeout=30) is not None
        assert rt.index.chains >= 3          # 48 tokens = 3 full pages filed
        routed0 = dict(rt.stats.routed)
        warm = max(routed0, key=routed0.get)
        hs = [rt.submit(np.concatenate([shared, [i, i + 1]]), priority="hi",
                        max_new_tokens=4) for i in (3, 5, 7)]
        assert rt.drain(timeout=60)
        assert rt.stats.routed[warm] == routed0[warm] + 3
        assert rt.stats.cache_hit_requests == 3
        assert rt.stats.cache_hit_blocks == 9   # 3 pages x 3 requests
        for h in hs:
            assert h.status == "finished" and len(h.tokens) == 4


def test_balance_knob_spreads_hot_prefix(model_params):
    """balance high enough, load outweighs stickiness: a burst carrying the
    same warm prefix spreads across replicas instead of hammering one."""
    e0 = _build_engine(model_params, prefix_cache=True)
    e1 = _build_engine(model_params, prefix_cache=True)
    rng = _rng()
    shared = _prompt(rng, 48)
    cluster = ServingCluster([e0, e1], serving=_SERVING)
    with ServingRouter(cluster, {"policy": "cache_aware",
                                 "balance": 1e6}) as rt:
        h0 = rt.submit(np.concatenate([shared, [1, 2]]), priority="hi",
                       max_new_tokens=4)
        h0.result(timeout=30)
        hs = [rt.submit(np.concatenate([shared, [i, i + 1]]), priority="hi",
                        max_new_tokens=12) for i in (3, 5, 7, 9)]
        assert rt.drain(timeout=60)
        assert min(rt.stats.routed.values()) >= 2    # spread, not hotspot
        assert rt.stats.rebalances >= 1              # stickiness overridden
        for h in hs:
            assert h.status == "finished"


# --------------------------------------------------------------------------- #
# federated admission
# --------------------------------------------------------------------------- #

def _warm_hot(frontend, cls_name, delay_s=10.0):
    """Make a replica look SLO-hopeless for ``cls_name``: a huge measured
    queue delay + a nonzero cost model."""
    adm = frontend.admission
    adm.cost.update_prefill(100, 1.0)
    adm.cost.update_decode(0.01)
    adm._note_queue_delay(cls_name, delay_s)


def test_federation_steers_past_hot_replica(model_params):
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    serving = dict(_SERVING)
    serving["classes"] = [{"name": "tight", "priority": 1,
                           "ttft_slo_ms": 500.0, "tbt_slo_ms": 1e6}]
    cluster = ServingCluster([e0, e1], serving=serving)
    rt = ServingRouter(cluster, {"policy": "cache_aware", "balance": 4.0})
    _warm_hot(cluster.replica("r0").frontend, "tight")
    with rt:
        h = rt.submit(_prompt(_rng(), 24), priority="tight",
                      max_new_tokens=4)
        assert rt.drain(timeout=30)
        assert h.status == "finished"
        assert rt.stats.routed == {"r0": 0, "r1": 1}   # hot replica skipped


def test_federation_sheds_at_router_when_all_hot(model_params):
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    serving = dict(_SERVING)
    serving["classes"] = [{"name": "tight", "priority": 1,
                           "ttft_slo_ms": 500.0, "tbt_slo_ms": 1e6}]
    cluster = ServingCluster([e0, e1], serving=serving)
    rt = ServingRouter(cluster, {"policy": "cache_aware"})
    for r in cluster.frontends:
        _warm_hot(r.frontend, "tight")
    with rt:
        h = rt.submit(_prompt(_rng(), 24), priority="tight",
                      max_new_tokens=4)
        assert h.status == "shed"
        assert list(h) == []                 # stream closed immediately
        assert h.result(timeout=1.0) == []
        assert rt.stats.router_sheds["tight"] == 1
        assert sum(rt.stats.routed.values()) == 0
        assert rt.drain(timeout=5)


def test_admission_queue_delay_ema(model_params):
    e = _build_engine(model_params)
    fe = e.serving_frontend()
    adm = fe.admission
    assert adm.queue_delay_s("hi") == 0.0
    adm._note_queue_delay("hi", 1.0)
    assert adm.queue_delay_s("hi") == pytest.approx(1.0)
    adm._note_queue_delay("hi", 0.0)
    assert adm.queue_delay_s("hi") == pytest.approx(0.7)   # alpha = 0.3
    # a real admission feeds it
    h = fe.submit(_prompt(_rng(), 8), priority="lo", max_new_tokens=2)
    for _ in range(50):
        if h.finished:
            break
        fe.step()
    assert adm.queue_delay_s("lo") > 0.0
    fe.close()


# --------------------------------------------------------------------------- #
# disaggregated prefill/decode
# --------------------------------------------------------------------------- #

def test_disaggregated_handoff_streams_byte_identical(model_params):
    e_pre = _build_engine(model_params)
    e_dec = _build_engine(model_params)
    rng = _rng()
    prompts = [_prompt(rng, n) for n in (24, 40, 9)]
    refs = [_direct_stream(e_dec, p, 6) for p in prompts]
    cluster = ServingCluster([e_pre, e_dec], roles=["prefill", "decode"],
                             serving=_SERVING)
    with ServingRouter(cluster, {"topology": "disaggregated"}) as rt:
        hs = [rt.submit(p, priority="hi", max_new_tokens=6) for p in prompts]
        assert rt.drain(timeout=60)
        assert rt.stats.handoffs == 3
        assert rt.stats.handoff_bytes > 0
        for h, ref in zip(hs, refs):
            assert h.status == "finished" and h.tokens == ref
            assert h.ttft_ms is not None and len(h.tbt_ms) == 5
    # decode replica never ran a prefill pass beyond the direct references
    # computed above; both pools back to baseline
    assert e_dec.scheduler.prefill_tokens_completed == \
        sum(len(p) for p in prompts)
    assert e_pre.free_blocks == e_pre.allocator.total_blocks
    assert e_dec.free_blocks == e_dec.allocator.total_blocks


def test_disaggregated_prefill_cache_reused(model_params):
    """The prefill replica's radix tree survives exports: the second
    request sharing a prefix prefills only its tail."""
    e_pre = _build_engine(model_params, prefix_cache=True)
    e_dec = _build_engine(model_params)
    rng = _rng()
    shared = _prompt(rng, 48)
    cluster = ServingCluster([e_pre, e_dec], roles=["prefill", "decode"],
                             serving=_SERVING)
    with ServingRouter(cluster, {"topology": "disaggregated"}) as rt:
        h0 = rt.submit(np.concatenate([shared, [1, 2]]), priority="hi",
                       max_new_tokens=4)
        h0.result(timeout=30)
        done0 = e_pre.scheduler.prefill_tokens_completed
        h1 = rt.submit(np.concatenate([shared, [3, 4]]), priority="hi",
                       max_new_tokens=4)
        h1.result(timeout=30)
        assert rt.drain(timeout=30)
        assert e_pre.scheduler.prefill_tokens_completed - done0 == 2
        assert h0.status == "finished" and h1.status == "finished"


def test_disaggregated_cancel_while_queued(model_params):
    e_pre = _build_engine(model_params)
    e_dec = _build_engine(model_params)
    cluster = ServingCluster([e_pre, e_dec], roles=["prefill", "decode"],
                             serving=_SERVING)
    rt = ServingRouter(cluster, {"topology": "disaggregated"})
    # not started: the worker never runs, the request sits queued
    h = rt.submit(_prompt(_rng(), 24), priority="hi", max_new_tokens=6)
    h.cancel()
    rt.start()
    assert rt.drain(timeout=30)
    assert h.status == "cancelled" and list(h) == []
    rt.close()
    assert e_pre.free_blocks == e_pre.allocator.total_blocks
    assert e_dec.free_blocks == e_dec.allocator.total_blocks


def test_topology_role_validation(model_params):
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    cluster = ServingCluster([e0, e1], roles=["prefill", "decode"],
                             serving=_SERVING)
    with pytest.raises(ValueError, match="colocated"):
        ServingRouter(cluster, {"topology": "colocated"})
    cluster2 = ServingCluster([_build_engine(model_params)], serving=_SERVING)
    with pytest.raises(ValueError, match="disaggregated"):
        ServingRouter(cluster2, {"topology": "disaggregated"})
    with pytest.raises(ValueError, match="policy"):
        RouterConfig(policy="nope")


# --------------------------------------------------------------------------- #
# failure surfacing: replica named, streams isolated
# --------------------------------------------------------------------------- #

def test_replica_crash_named_and_isolated(model_params):
    """A mid-stream engine-thread crash closes ONLY that replica's streams;
    the sibling finishes, and the router's drain()/close() name the failed
    replica."""
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    rng = _rng()
    p0, p1 = _prompt(rng, 24), _prompt(rng, 24)
    ref0 = _direct_stream(e0, p0, 100)
    cluster = ServingCluster([e0, e1], serving=_SERVING)
    rt = ServingRouter(cluster, {"policy": "round_robin"}).start()
    h0 = rt.submit(p0, priority="hi", max_new_tokens=100)  # -> r0
    h1 = rt.submit(p1, priority="hi", max_new_tokens=100)  # -> r1
    # wait until both streams are flowing, then kill r1's engine thread
    for h in (h0, h1):
        for _t in h:
            break
    boom = RuntimeError("injected")

    def bad_pass(*a, **k):
        raise boom

    e1._run_pass = bad_pass
    fe1 = cluster.replica("r1").frontend
    fe1._pipe.run = bad_pass                 # next decode slice dies
    with pytest.raises(RuntimeError, match="replica 'r1'"):
        rt.drain(timeout=30)
    partial = h1.result(timeout=10.0)        # stream closed, not hung
    assert h1.status != "finished" and len(partial) < 100
    # r0 is untouched: its stream completes byte-identically
    assert h0.result(timeout=60.0) == ref0
    assert h0.status == "finished"
    with pytest.raises(RuntimeError, match="replica 'r1'"):
        rt.close()
    # close is idempotent even after the raise
    rt.close()


def test_prefill_worker_crash_named(model_params):
    e_pre = _build_engine(model_params)
    e_dec = _build_engine(model_params)
    cluster = ServingCluster([e_pre, e_dec], roles=["prefill", "decode"],
                             serving=_SERVING)
    rt = ServingRouter(cluster, {"topology": "disaggregated"}).start()
    boom = RuntimeError("injected")

    def bad_pass():
        raise boom

    e_pre._run_pass = bad_pass
    h = rt.submit(_prompt(_rng(), 24), priority="hi", max_new_tokens=4)
    with pytest.raises(RuntimeError, match="replica 'r0' prefill"):
        rt.drain(timeout=30)
    assert h.result(timeout=10.0) == []      # stream closed, not hung
    rt.close()


def test_handoff_backpressure_sheds_past_queue_bound(model_params):
    """Handoffs past the decode replica's max_queue shed instead of pinning
    unbounded KV page arrays in host memory."""
    a = _build_engine(model_params)
    model, params = model_params
    econf = {"dtype": torch.float32,
             "state_manager": {"max_tracked_sequences": 8,
                               "max_ragged_sequence_count": 4,
                               "max_ragged_batch_size": 96,
                               "max_context": 176,
                               "prefill_chunk_size": 32},
             "kv_cache": {"block_size": 16, "num_blocks": 24},
             "serving": dict(_SERVING, max_queue=1)}
    b = InferenceEngineV2(model, econf, params, device="cpu")
    fe = b.serving_frontend()
    rng = _rng()
    from deepspeed_tpu_torch.inference.v2.serving.frontend import RequestHandle
    import time as _t
    recs = []
    for i, uid in enumerate((31, 32)):
        p = _prompt(rng, 24)
        a._put_nofetch([uid], [p])
        pages, logits = a.export_kv(uid)
        req = RequestHandle(uid + (1 << 24), p, fe.config.get_class("hi"),
                            4, None, _t.perf_counter())
        fe.submit_handoff(req, pages, logits)
        recs.append(req)
    fe._drain_control()
    assert len(fe._handoffs) == 1
    assert recs[1].status == "shed" and list(recs[1]) == []
    for _ in range(60):
        if recs[0].finished:
            break
        fe.step()
    assert recs[0].status == "finished" and len(recs[0].tokens) == 4
    fe.close()
    assert b.free_blocks == b.allocator.total_blocks


def test_unfundable_handoff_sheds_not_wedges(model_params):
    """A handoff whose pages + slice growth can NEVER fit the decode pool
    sheds at the next iteration instead of being re-held forever (and the
    replica's loop survives)."""
    a = _build_engine(model_params)
    b = _build_engine(model_params, num_blocks=4)   # 64-token pool
    fe = b.serving_frontend()
    rng = _rng()
    p = _prompt(rng, 64)                            # 4 pages of KV
    a._put_nofetch([33], [p])
    pages, logits = a.export_kv(33)
    from deepspeed_tpu_torch.inference.v2.serving.frontend import RequestHandle
    import time as _t
    req = RequestHandle(33 + (1 << 24), p, fe.config.get_class("hi"),
                        4, None, _t.perf_counter())
    fe.submit_handoff(req, pages, logits)
    fe.step()
    assert req.status == "shed" and list(req) == []
    assert not fe._handoffs
    fe.close()
    assert b.free_blocks == b.allocator.total_blocks


def test_disagg_submit_validates_weakest_decode_replica(model_params):
    """Disaggregated validation runs against the WEAKEST decode replica:
    _pick_decode may land the handoff on any of them."""
    model, params = model_params
    e_pre = _build_engine(model_params)
    e_big = _build_engine(model_params, num_blocks=24)
    econf = {"dtype": torch.float32,
             "state_manager": {"max_tracked_sequences": 8,
                               "max_ragged_sequence_count": 4,
                               "max_ragged_batch_size": 96,
                               "max_context": 176,
                               "prefill_chunk_size": 32},
             "kv_cache": {"block_size": 16, "num_blocks": 6},
             "serving": dict(_SERVING)}
    e_small = InferenceEngineV2(model, econf, params, device="cpu")
    cluster = ServingCluster([e_pre, e_big, e_small],
                             roles=["prefill", "decode", "decode"],
                             serving=_SERVING)
    rt = ServingRouter(cluster, {"topology": "disaggregated"})
    # fits the 24-block replica but not the 6-block one: rejected up front
    with pytest.raises(ValueError, match="KV blocks"):
        rt.submit(_prompt(_rng(), 80), priority="hi", max_new_tokens=40)
    rt.close()


def test_prefill_backlog_counts_toward_federated_hotness(model_params):
    e_pre = _build_engine(model_params)
    e_dec = _build_engine(model_params)
    serving = dict(_SERVING)
    serving["classes"] = [{"name": "tight", "priority": 1,
                           "ttft_slo_ms": 500.0, "tbt_slo_ms": 1e6}]
    cluster = ServingCluster([e_pre, e_dec], roles=["prefill", "decode"],
                             serving=serving)
    rt = ServingRouter(cluster, {"topology": "disaggregated"})
    cls = rt._serving_cfg.get_class("tight")
    pre = cluster.replica("r0")
    # 100 tok/s model: one 24-token prompt predicts 240 ms < 500 ms SLO...
    rt._prefill_cost["r0"].update_prefill(100, 1.0)
    assert not rt._hot(pre, cls, 24)
    # ...but a 2-deep worker backlog predicts 3 x 240 ms > 500 ms: hot
    rt._workers["r0"].q.put(object())
    rt._workers["r0"].q.put(object())
    assert rt._hot(pre, cls, 24)
    # every (single) prefill candidate hot -> router-level shed
    h = rt.submit(_prompt(_rng(), 24), priority="tight", max_new_tokens=4)
    assert h.status == "shed"
    while not rt._workers["r0"].q.empty():
        rt._workers["r0"].q.get_nowait()
    rt.close()


# --------------------------------------------------------------------------- #
# cluster validation + observability
# --------------------------------------------------------------------------- #

def test_cluster_rejects_mismatched_fabric(model_params):
    model, params = model_params
    e0 = _build_engine(model_params)
    econf = {"dtype": torch.float32,
             "state_manager": {"max_tracked_sequences": 8,
                               "max_ragged_sequence_count": 4,
                               "max_ragged_batch_size": 96,
                               "max_context": 176,
                               "prefill_chunk_size": 32},
             "kv_cache": {"block_size": 32, "num_blocks": 12},
             "serving": dict(_SERVING)}
    e_bad = InferenceEngineV2(model, econf, params, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        ServingCluster([e0, e_bad], serving=_SERVING)


def test_replica_labels_keep_monitor_rows_distinct():
    """Two frontends fanning into ONE monitor backend (one CSV) must emit
    disjoint event names — the replica label provides it."""
    a = FrontendStats(["hi"], replica="r0")
    b = FrontendStats(["hi"], replica="r1")
    names_a = {n for n, _, _ in a.events()}
    names_b = {n for n, _, _ in b.events()}
    assert names_a and not (names_a & names_b)
    assert all(n.startswith(("serve/frontend/r0/", "serve/slo/r0/"))
               for n in names_a)
    # unlabelled stays on the single-frontend names
    bare = {n for n, _, _ in FrontendStats(["hi"]).events()}
    assert "serve/frontend/hi/completed" in bare
    assert "serve/slo/missed" in bare
    # spec stats carry the same label
    s = SpecDecodeStats(replica="r1")
    s.record_step(1, 2, 1, 2, 0.0, 0.0, 8)
    assert all(n.startswith("serve/spec/r1/") for n, _, _ in s.events())
    s.reset()
    assert s.replica == "r1"                 # reset never drops the label


def test_router_stats_events_aggregate(model_params):
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    cluster = ServingCluster([e0, e1], serving=_SERVING)
    with ServingRouter(cluster, {"policy": "round_robin"}) as rt:
        hs = [rt.submit(_prompt(_rng(), 16), priority="hi",
                        max_new_tokens=4) for _ in range(4)]
        assert rt.drain(timeout=60)
        ev = {name: v for name, v, _ in rt.stats.events(step=2)}
        assert ev["serve/router/routed"] == 4.0
        assert ev["serve/router/routed/r0"] == 2.0
        assert ev["serve/router/routed/r1"] == 2.0
        # the cluster rollup: completions summed over both replicas
        assert ev["serve/router/hi/completed"] == 4.0
        assert ev["serve/router/hi/tokens"] == 16.0
        assert ev["serve/router/hi/slo_met_fraction"] == 1.0

        class Sink:
            def __init__(self):
                self.rows = []

            def write_events(self, events):
                self.rows.extend(events)

        sink = Sink()
        rt.write_monitor_events(sink, step=2)
        names = {n for n, _, _ in sink.rows}
        assert ("serve/router/routed", 4.0, 2) in sink.rows
        # replica-labelled frontend rows ride the same fan-out, distinct
        assert "serve/frontend/r0/hi/completed" in names
        assert "serve/frontend/r1/hi/completed" in names
        for h in hs:
            assert h.status == "finished"


def test_router_route_spans(model_params, tmp_path):
    """Routing + handoff leave serve/router spans that pass trace_check
    with a required serve/router track."""
    from deepspeed_tpu_torch.monitor.trace import tracer
    tracer.reset()
    tracer.configure(trace_dir=str(tmp_path), enabled=True)
    try:
        e_pre = _build_engine(model_params)
        e_dec = _build_engine(model_params)
        cluster = ServingCluster([e_pre, e_dec], roles=["prefill", "decode"],
                                 serving=_SERVING)
        with ServingRouter(cluster, {"topology": "disaggregated"}) as rt:
            h = rt.submit(_prompt(_rng(), 24), priority="hi",
                          max_new_tokens=4)
            assert rt.drain(timeout=60)
            assert h.status == "finished"
        names = tracer.summary()
        assert "serve/router/route" in names
        assert "serve/router/handoff" in names
        path = tracer.export()
        import subprocess
        import sys
        r = subprocess.run(
            [sys.executable, "scripts/trace_check.py", path,
             "--require", "serve/router"],
            capture_output=True, text=True,
            cwd=str(__import__("pathlib").Path(__file__).
                    resolve().parents[1]), timeout=60)
        assert r.returncode == 0, r.stdout + r.stderr
    finally:
        tracer.reset()


# --------------------------------------------------------------------------- #
# loadgen: shared-prefix components + target-independent determinism
# --------------------------------------------------------------------------- #

def test_loadgen_shared_prefix_components_deterministic():
    mix = [WorkloadComponent("hi", 2.0, [4, 8], [4], prefix_len=12),
           WorkloadComponent("lo", 1.0, [8], [8], prefix_len=12),
           WorkloadComponent("hi", 1.0, [6], [4])]
    a1 = PoissonLoadGen(rate=50.0, mix=mix, vocab=128, seed=9).arrivals(n=30)
    a2 = PoissonLoadGen(rate=50.0, mix=mix, vocab=128, seed=9).arrivals(n=30)
    assert [x.t for x in a1] == [x.t for x in a2]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a1, a2))
    # requests within a prefix component share its prefix; components
    # differ from each other
    by_len = {}
    for x in a1:
        by_len.setdefault(len(x.prompt), []).append(x.prompt)
    with_prefix = [ps for n, ps in by_len.items() if n >= 12 + 4]
    prefixes = set()
    for ps in with_prefix:
        for p in ps:
            prefixes.add(tuple(int(t) for t in p[:12]))
    assert len(prefixes) >= 2                # two distinct component prefixes


def test_loadgen_prefix_free_mix_stream_unchanged():
    """prefix_len=0 components draw nothing extra: the stream for a given
    seed is byte-identical to the prefix-free generator (earlier seeds replay
    unchanged)."""
    mix = [WorkloadComponent("hi", 3.0, [8, 16], [4]),
           WorkloadComponent("lo", 1.0, [32], [8, 16])]
    a = PoissonLoadGen(rate=50.0, mix=mix, vocab=128, seed=7).arrivals(n=10)
    # pinned against the prefix-free generator's output for this seed
    assert [round(x.t, 6) for x in a[:3]] == \
        [round(t, 6) for t in _legacy_arrival_times(7, 50.0, mix, 128, 3)]


def _legacy_arrival_times(seed, rate, mix, vocab, n):
    """The prefix-free arrival loop, verbatim (no prefix draws)."""
    rng = np.random.RandomState(seed)
    w = np.asarray([c.weight for c in mix], np.float64)
    w = w / w.sum()
    out, t = [], 0.0
    while len(out) < n:
        t += float(rng.exponential(1.0 / rate))
        comp = mix[int(rng.choice(len(mix), p=w))]
        plen = int(comp.prompt_lens[int(rng.randint(len(comp.prompt_lens)))])
        rng.randint(len(comp.gen_lens))
        rng.randint(0, vocab, size=(plen,))
        out.append(t)
    return out


def test_loadgen_replay_target_independent():
    """The same seed drives the identical per-request (class, prompt,
    arrival, budget) stream whoever consumes it — scoring a router and a
    single frontend compares the exact same workload."""
    from deepspeed_tpu_torch.inference.v2.serving import replay

    class StubTarget:
        def __init__(self):
            self.seen = []

        def submit(self, prompt, priority, max_new_tokens):
            self.seen.append((priority, tuple(int(t) for t in prompt),
                              max_new_tokens))
            return object()

    mix = [WorkloadComponent("hi", 1.0, [4], [4], prefix_len=8)]
    t1, t2 = StubTarget(), StubTarget()
    for t in (t1, t2):
        arrivals = PoissonLoadGen(rate=200.0, mix=mix, vocab=64,
                                  seed=3).arrivals(n=12)
        replay(t, arrivals, speed=1e6)
    assert t1.seen == t2.seen
