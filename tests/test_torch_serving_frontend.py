"""The port's serving frontend (deepspeed_tpu_torch.inference.v2.serving):
its own copies of the JAX package's frontend gates
(tests/unit/test_serving_frontend.py), by name, on a tiny port engine on the
CPU — admission with priority classes, preempt-offload/restore, request
cancellation at every lifecycle stage, the KV page host round trip, the
Poisson load generator, the serve/req and serve/frontend surfaces, and no
new step-cache entry after warmup."""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.config_v2 import (PriorityClassConfig,
                                                        ServingConfig)
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.serving import (KVOffloadManager,
                                                      PoissonLoadGen,
                                                      ServingFrontend,
                                                      WorkloadComponent,
                                                      goodput_report, slo_met)
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

from tests._torch_threads import one_torch_thread  # noqa: F401

# relaxed SLOs: correctness tests must not shed on a slow CI box; the SLO
# decision logic itself is tested directly against the cost model
_CLASSES = [{"name": "hi", "priority": 2,
             "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6},
            {"name": "lo", "priority": 0,
             "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6}]


def _model_and_params(seed=0):
    cfg = LlamaConfig.tiny(vocab_size=128, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    return model, model.flat_params()


def _build_engine(model_params=None, num_blocks=10, prefix_cache=False,
                  serving=None, warmup=False, spec=False):
    model, params = model_params or _model_and_params()
    econf = {"dtype": torch.float32,
             "state_manager": {"max_tracked_sequences": 8,
                               "max_ragged_sequence_count": 4,
                               "max_ragged_batch_size": 96,
                               "max_context": 176,
                               "prefill_chunk_size": 32},
             "kv_cache": {"block_size": 16, "num_blocks": num_blocks},
             "serving": dict({"decode_slice": 4, "idle_wait_s": 0.005,
                              "classes": _CLASSES}, **(serving or {}))}
    if prefix_cache:
        econf["prefix_cache"] = {"enabled": True}
    if warmup:
        econf["compile"] = {"warmup": True}
    if spec:
        econf["spec_decode"] = {"enabled": True, "k": 3}
    return InferenceEngineV2(model, econf, params, device="cpu")


@pytest.fixture(scope="module")
def model_params():
    return _model_and_params()


def _rng():
    return np.random.RandomState(0)


def _prompt(rng, n):
    return rng.randint(0, 128, size=(n,)).astype(np.int32)


def _direct_stream(engine, prompt, n):
    """The reference: the same prompt through a bare DecodePipeline run —
    frontend streams must be byte-identical to this (row independence)."""
    uid = 90_000 + _direct_stream.k
    _direct_stream.k += 1
    engine._put_nofetch([uid], [np.asarray(prompt, np.int32)])
    out = engine.decode_pipeline([uid]).run(n)
    engine.flush([uid])
    return [int(t) for t in out[0]]


_direct_stream.k = 0


def _step_until(fe, cond, n=400):
    for _ in range(n):
        if cond():
            return True
        fe.step()
    return cond()


def _force_preempt(fe, rng, lo_gen=40, prompts=None):
    """Deterministic pressure: a low-priority request decodes until a
    high-priority arrival too big for the remaining pool preempts it.
    Returns (h_lo, h_hi)."""
    p_lo, p_hi = prompts or (_prompt(rng, 24), _prompt(rng, 112))
    h_lo = fe.submit(p_lo, priority="lo", max_new_tokens=lo_gen)
    for _ in range(5):
        fe.step()
    assert h_lo.status == "decoding"
    h_hi = fe.submit(p_hi, priority="hi", max_new_tokens=8)
    assert _step_until(fe, lambda: h_lo.status == "preempted", 30)
    return h_lo, h_hi


# --------------------------------------------------------------------------- #
# streams: correctness, ordering, byte-equality with the bare pipeline
# --------------------------------------------------------------------------- #

def test_stream_matches_direct_pipeline(model_params):
    e = _build_engine(model_params)
    rng = _rng()
    prompts = [_prompt(rng, n) for n in (24, 9, 40)]
    refs = [_direct_stream(e, p, 6) for p in prompts]
    fe = e.serving_frontend()
    hs = [fe.submit(p, priority="hi", max_new_tokens=6) for p in prompts]
    assert _step_until(fe, lambda: all(h.finished for h in hs))
    for h, ref in zip(hs, refs):
        assert h.status == "finished"
        assert h.tokens == ref          # multi-row bucket == solo run
        assert list(h) == ref           # the stream queue saw the same ids
        assert h.ttft_ms is not None and len(h.tbt_ms) == 5
    fe.close()


def test_eos_stops_stream(model_params):
    e = _build_engine(model_params)
    rng = _rng()
    p = _prompt(rng, 24)
    ref = _direct_stream(e, p, 8)
    # the first token after the first whose id is new to the stream: the
    # stream must stop right after its first occurrence
    k = next(i for i in range(1, 8) if ref[i] not in ref[:i])
    eos = ref[k]
    fe = e.serving_frontend()
    h = fe.submit(p, priority="hi", max_new_tokens=8, eos_token_id=eos)
    assert _step_until(fe, lambda: h.finished)
    assert h.tokens == ref[:k + 1]      # eos included, stream stops after
    fe.close()


def test_asyncio_stream_and_threaded_loop(model_params):
    import asyncio
    e = _build_engine(model_params)
    rng = _rng()
    p = _prompt(rng, 24)
    ref = _direct_stream(e, p, 6)
    with e.serving_frontend() as fe:
        async def client():
            h = fe.submit(p, priority="hi", max_new_tokens=6)
            return h, [t async for t in h.astream()]

        h, toks = asyncio.run(asyncio.wait_for(client(), 30.0))
        assert h.status == "finished" and toks == ref
    # close() cancelled nothing (all done) and released everything
    assert e.free_blocks == e.allocator.total_blocks


def test_submit_validates_context_budget(model_params):
    e = _build_engine(model_params)
    fe = e.serving_frontend()
    with pytest.raises(ValueError, match="max_context"):
        fe.submit(np.arange(100, dtype=np.int32), priority="hi",
                  max_new_tokens=100)
    with pytest.raises(KeyError, match="unknown priority class"):
        fe.submit(np.arange(4, dtype=np.int32), priority="nope")
    fe.close()


# --------------------------------------------------------------------------- #
# preempt-offload: byte-identical restore, shared pages stay, fallbacks
# --------------------------------------------------------------------------- #

def test_preempt_offload_restore_byte_identical(model_params):
    e = _build_engine(model_params)
    rng = _rng()
    p_lo, p_hi = _prompt(rng, 24), _prompt(rng, 112)
    ref_lo = _direct_stream(e, p_lo, 40)
    ref_hi = _direct_stream(e, p_hi, 8)
    free0 = e.free_blocks
    fe = e.serving_frontend()
    h_lo, h_hi = _force_preempt(fe, rng, prompts=(p_lo, p_hi))
    assert h_lo.uid in fe.offload._recs
    assert fe.stats.offload_bytes > 0
    assert _step_until(fe, lambda: h_lo.finished and h_hi.finished)
    assert fe.stats.preemptions >= 1 and fe.stats.restores >= 1
    assert h_lo.preemptions >= 1
    # the tentpole gate: preempt-offload-restored stream == direct pipeline
    assert h_lo.tokens == ref_lo
    assert h_hi.tokens == ref_hi
    fe.close()
    assert e.free_blocks == free0
    assert fe.offload.pool.outstanding == 0


def test_prefix_shared_pages_never_offloaded(model_params):
    """With the radix cache holding a 3-page shared prefix, preemption
    offloads ONLY the private tail; the shared pages stay resident under
    their refcounts and the restored stream still completes."""
    e = _build_engine(model_params, prefix_cache=True)
    rng = _rng()
    shared = _prompt(rng, 48)
    fe = e.serving_frontend()
    h0 = fe.submit(np.concatenate([shared, [1, 2]]), priority="lo",
                   max_new_tokens=4)
    assert _step_until(fe, lambda: h0.finished, 20)
    h1 = fe.submit(np.concatenate([shared, [3, 4]]), priority="lo",
                   max_new_tokens=40)
    for _ in range(6):
        fe.step()
    kept, tail = e.scheduler.private_tail(h1.uid)
    assert kept >= 3 and tail            # shared prefix split out
    h2 = fe.submit(_prompt(rng, 112), priority="hi", max_new_tokens=8)
    assert _step_until(fe, lambda: h1.status == "preempted", 40)
    # only the private tail moved; the kept shared pages are still allocated
    assert fe.offload.pages_held(h1.uid) == len(tail)
    for b in e.scheduler.seqs[h1.uid].blocks:
        assert e.allocator.ref_count(b) >= 1
    assert _step_until(fe, lambda: h1.finished and h2.finished)
    assert h1.status == "finished" and len(h1.tokens) == 40
    fe.close()


def test_offload_capacity_falls_back_to_recompute(model_params):
    """max_offload_bytes=0: every preemption takes the recompute fallback;
    the victim still completes (possibly with kernel-path numerics — the
    documented recompute trade), and the allocator stays clean."""
    e = _build_engine(model_params,
                      serving={"max_offload_bytes": 0})
    free0 = e.free_blocks
    fe = e.serving_frontend()
    h_lo, h_hi = _force_preempt(fe, _rng())
    assert fe.stats.recompute_preemptions >= 1
    assert fe.offload is not None and not fe.offload._recs
    assert _step_until(fe, lambda: h_lo.finished and h_hi.finished)
    assert h_lo.status == "finished" and len(h_lo.tokens) == 40
    fe.close()
    assert e.free_blocks == free0


def test_recompute_mode(model_params):
    e = _build_engine(model_params, serving={"preemption": "recompute"})
    free0 = e.free_blocks
    fe = e.serving_frontend()
    assert fe.offload is None
    h_lo, h_hi = _force_preempt(fe, _rng())
    assert fe.stats.recompute_preemptions >= 1
    assert _step_until(fe, lambda: h_lo.finished and h_hi.finished)
    assert len(h_lo.tokens) == 40 and len(h_hi.tokens) == 8
    fe.close()
    assert e.free_blocks == free0


def test_reject_only_mode_holds_then_serves(model_params):
    """preemption='none': conservative full-lifetime admission — the big
    high-priority request HOLDS (no victim is preempted) until the
    low-priority one finishes and frees the pool."""
    e = _build_engine(model_params, serving={"preemption": "none"})
    fe = e.serving_frontend()
    rng = _rng()
    h_lo = fe.submit(_prompt(rng, 24), priority="lo", max_new_tokens=24)
    for _ in range(3):
        fe.step()
    h_hi = fe.submit(_prompt(rng, 112), priority="hi", max_new_tokens=8)
    for _ in range(3):
        fe.step()
    assert h_hi.status == "queued"       # held, not admitted, not preempting
    assert fe.stats.preemptions == 0
    assert _step_until(fe, lambda: h_lo.finished and h_hi.finished)
    assert h_lo.status == "finished" and h_hi.status == "finished"
    fe.close()


# --------------------------------------------------------------------------- #
# KV page host round-trip (satellite): bytes + refcounts + free_blocks
# --------------------------------------------------------------------------- #

def test_kv_page_roundtrip_bytes_exact(model_params):
    e = _build_engine(model_params)
    rng = _rng()
    e.put([5], [_prompt(rng, 40)])       # 3 pages of real KV
    blocks = list(e.scheduler.seqs[5].blocks)
    pages = [e.fetch_page(b) for b in blocks]
    zero = np.zeros_like(pages[0])
    for b in blocks:
        e.put_page(zero, b)
    for b in blocks:
        assert np.array_equal(e.fetch_page(b), zero)
    for b, pg in zip(blocks, pages):
        e.put_page(pg, b)
    for b, pg in zip(blocks, pages):     # restore is byte-exact
        assert np.array_equal(e.fetch_page(b), pg)
    e.flush([5])


def test_offload_manager_roundtrip_refcounts(model_params):
    """offload -> restore through the manager: page bytes exact, block table
    rebuilt in order, refcounts and free_blocks at baseline after restore
    AND after cancel-while-offloaded."""
    e = _build_engine(model_params)
    rng = _rng()
    free0 = e.free_blocks

    def offloaded_seq(uid):
        e._put_nofetch([uid], [_prompt(rng, 40)])
        kept, tail = e.scheduler.private_tail(uid)
        assert kept == 0 and len(tail) == 3      # cache off: all private
        pages = [e.fetch_page(b) for b in tail]
        mgr = KVOffloadManager(e)
        mgr.offload(uid, kept, tail)
        assert e.free_blocks == free0            # victim fully released
        assert e.scheduler.seqs[uid].blocks == []
        return mgr, pages

    mgr, pages = offloaded_seq(7)
    mgr.restore(7)
    new_blocks = e.scheduler.seqs[7].blocks
    assert len(new_blocks) == 3
    for b, pg in zip(new_blocks, pages):         # logical order preserved
        assert np.array_equal(e.fetch_page(b), pg)
        assert e.allocator.ref_count(b) == 1
    assert mgr.pool.outstanding == 0
    assert 7 in e._last_logits                   # bootstrap row re-seeded
    e.flush([7])
    assert e.free_blocks == free0

    mgr, _ = offloaded_seq(8)                    # cancel-while-offloaded
    mgr.drop(8)
    e.flush([8])
    assert mgr.pool.outstanding == 0 and e.free_blocks == free0


# --------------------------------------------------------------------------- #
# cancellation at every lifecycle stage (satellite): allocator-leak gate
# --------------------------------------------------------------------------- #

def test_cancel_every_stage_leak_free(model_params):
    e = _build_engine(model_params)
    rng = _rng()
    free0 = e.free_blocks
    fe = e.serving_frontend()

    # (1) queued
    hq = fe.submit(_prompt(rng, 24), priority="lo", max_new_tokens=8)
    hq.cancel()
    fe.step()
    assert hq.status == "cancelled" and e.free_blocks == free0

    # (2) prefilling: cancel lands between SplitFuse passes (the product
    # polls at pass boundaries); partial KV released through scheduler.flush
    hp = fe.submit(_prompt(rng, 90), priority="lo", max_new_tokens=4)
    orig, calls = e._run_pass, []

    def patched():
        orig()
        if not calls:
            hp.cancel()
        calls.append(1)

    e._run_pass = patched
    try:
        fe.step()
    finally:
        e._run_pass = orig
    assert len(calls) >= 1
    assert hp.status == "cancelled" and e.free_blocks == free0

    # (3) decoding: retired by the on_tokens callback at the next boundary
    hd = fe.submit(_prompt(rng, 24), priority="lo", max_new_tokens=30)
    assert _step_until(fe, lambda: len(hd.tokens) > 0, 10)
    hd.cancel()
    fe.step()
    assert hd.status == "cancelled" and e.free_blocks == free0
    assert len(hd.tokens) < 30           # partial stream, then closed

    # (4) preempted-offloaded
    h_lo, h_hi = _force_preempt(fe, rng)
    h_lo.cancel()
    assert _step_until(fe, lambda: h_lo.finished and h_hi.finished)
    assert h_lo.status == "cancelled"
    assert fe.offload.pool.outstanding == 0
    fe.close()
    assert e.free_blocks == free0


# --------------------------------------------------------------------------- #
# admission model: SLO shedding, priority order, queue bound
# --------------------------------------------------------------------------- #

def test_shed_when_slo_hopeless(model_params):
    e = _build_engine(model_params,
                      serving={"classes": [
                          {"name": "tight", "priority": 1,
                           "ttft_slo_ms": 0.001, "tbt_slo_ms": 1e6}]})
    fe = e.serving_frontend()
    # warm the cost model so predictions are nonzero
    fe.admission.cost.update_prefill(100, 1.0)
    fe.admission.cost.update_decode(0.01)
    h = fe.submit(_prompt(_rng(), 24), priority="tight", max_new_tokens=4)
    fe.step()
    assert h.status == "shed"
    assert fe.stats.classes["tight"].shed == 1
    # the stream closes immediately with zero tokens
    assert list(h) == []
    fe.close()


def test_queue_bound_sheds(model_params):
    e = _build_engine(model_params, serving={"max_queue": 1})
    fe = e.serving_frontend()
    rng = _rng()
    a = fe.submit(_prompt(rng, 8), max_new_tokens=4, priority="lo")
    b = fe.submit(_prompt(rng, 8), max_new_tokens=4, priority="lo")
    fe._drain_control()
    assert b.status == "shed" and a.status == "queued"
    fe.close()


def test_strict_priority_admission_order(model_params):
    """With one decode row, the high-priority later arrival is admitted
    before the earlier low-priority one (strict priority between classes,
    FIFO within)."""
    model, params = model_params
    econf = {"dtype": torch.float32,
             "state_manager": {"max_tracked_sequences": 8,
                               "max_ragged_sequence_count": 1,
                               "max_ragged_batch_size": 96,
                               "max_context": 176,
                               "prefill_chunk_size": 32},
             "kv_cache": {"block_size": 16, "num_blocks": 10},
             "serving": {"decode_slice": 4, "classes": _CLASSES}}
    e = InferenceEngineV2(model, econf, params, device="cpu")
    fe = e.serving_frontend()
    rng = _rng()
    h_lo = fe.submit(_prompt(rng, 8), priority="lo", max_new_tokens=4)
    h_hi = fe.submit(_prompt(rng, 8), priority="hi", max_new_tokens=4)
    fe._drain_control()
    acts = fe.admission.plan(None, fe._live, fe._preempted, fe.offload)
    admits = [r.uid for k, r in acts if k == "admit"]
    assert admits == [h_hi.uid]          # hi admitted; lo holds (1 row)
    fe.close()


def test_cost_model_ema():
    from deepspeed_tpu_torch.inference.v2.serving import CostModel
    cm = CostModel(alpha=0.5)
    assert cm.predicted_ttft_s(1000) == 0.0      # unwarmed: never sheds
    cm.update_prefill(1000, 1.0)                 # 1000 tok/s
    cm.update_decode(0.5)
    assert cm.predicted_ttft_s(1000) == pytest.approx(1.5)
    cm.update_prefill(1000, 0.5)                 # EMA moves toward 2000
    assert cm.prefill_tok_s == pytest.approx(1500.0)


# --------------------------------------------------------------------------- #
# observability: serve/frontend events + serve/req spans
# --------------------------------------------------------------------------- #

def test_frontend_stats_events(model_params):
    e = _build_engine(model_params)
    fe = e.serving_frontend()
    h = fe.submit(_prompt(_rng(), 24), priority="hi", max_new_tokens=4)
    assert _step_until(fe, lambda: h.finished)
    ev = {name: v for name, v, _ in fe.stats.events(step=3)}
    assert ev["serve/frontend/hi/completed"] == 1.0
    assert ev["serve/frontend/hi/tokens"] == 4.0
    assert ev["serve/frontend/hi/slo_met_fraction"] == 1.0
    assert ev["serve/frontend/hi/ttft_p50_ms"] > 0
    assert ev["serve/frontend/queue_depth"] == 0.0
    # monitor fan-out shape: (name, value, step) triples
    class Sink:
        def __init__(self):
            self.rows = []

        def write_events(self, events):
            self.rows.extend(events)

    sink = Sink()
    fe.write_monitor_events(sink, step=3)
    assert ("serve/frontend/hi/completed", 1.0, 3) in sink.rows
    fe.close()


def test_serve_req_spans(model_params, tmp_path):
    """A preempt-offload-restore lifecycle leaves queued/prefill/decode/
    preempted/restore spans on the request's own serve/req lane, and the
    emitted file passes trace_check."""
    from deepspeed_tpu_torch.monitor.trace import tracer
    tracer.reset()
    tracer.configure(trace_dir=str(tmp_path), enabled=True)
    try:
        e = _build_engine()
        fe = e.serving_frontend()
        h_lo, h_hi = _force_preempt(fe, _rng())
        assert _step_until(fe, lambda: h_lo.finished and h_hi.finished)
        fe.close()
        names = tracer.summary()
        for phase in ("queued", "prefill", "decode", "preempted", "restore"):
            assert f"serve/req/{phase}" in names, phase
        # decode spans: one per stint — the preempted request has >= 2
        path = tracer.export()
        import subprocess, sys
        r = subprocess.run(
            [sys.executable, "scripts/trace_check.py", path,
             "--require", "serve/req"],
            capture_output=True, text=True,
            cwd=str(__import__("pathlib").Path(__file__).
                    resolve().parents[1]), timeout=60)
        assert r.returncode == 0, r.stdout + r.stderr
    finally:
        tracer.reset()


# --------------------------------------------------------------------------- #
# load generator + goodput scoring
# --------------------------------------------------------------------------- #

def test_loadgen_deterministic_and_mixed():
    mix = [WorkloadComponent("hi", 3.0, [8, 16], [4]),
           WorkloadComponent("lo", 1.0, [32], [8, 16])]
    g1 = PoissonLoadGen(rate=50.0, mix=mix, vocab=128, seed=7)
    g2 = PoissonLoadGen(rate=50.0, mix=mix, vocab=128, seed=7)
    a1, a2 = g1.arrivals(n=40), g2.arrivals(n=40)
    assert len(a1) == 40
    assert [a.t for a in a1] == [a.t for a in a2]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a1, a2))
    assert {a.cls for a in a1} == {"hi", "lo"}
    hi = sum(a.cls == "hi" for a in a1)
    assert hi > len(a1) // 2             # 3:1 weighting shows
    gaps = np.diff([a.t for a in g1.arrivals(n=200)])
    assert 1.0 / 50 * 0.5 < gaps.mean() < 1.0 / 50 * 2.0


def test_goodput_report_counts_only_slo_met():
    cls = PriorityClassConfig("c", 1, ttft_slo_ms=100.0, tbt_slo_ms=50.0)

    class H:
        def __init__(self, status, ttft, tbts, n):
            self.cls = cls
            self.status = status
            self.ttft_ms = ttft
            self.tbt_ms = tbts
            self.tokens = [0] * n

    good = H("finished", 50.0, [10.0] * 9, 10)
    late = H("finished", 500.0, [10.0] * 9, 10)       # TTFT blown
    jittery = H("finished", 50.0, [10.0] * 5 + [500.0] * 5, 10)  # TBT blown
    shed = H("shed", None, [], 0)
    assert slo_met(good) and not slo_met(late) and not slo_met(jittery)
    rep = goodput_report([good, late, jittery, shed], wall_s=10.0)
    assert rep["good_tokens"] == 10
    assert rep["goodput_tokens_per_sec"] == 1.0
    assert rep["classes"]["c"]["finished"] == 3
    assert rep["classes"]["c"]["shed"] == 1
    assert rep["classes"]["c"]["slo_met"] == 1


# --------------------------------------------------------------------------- #
# zero-compile steady state (the bench gate, pinned as a unit test)
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_zero_step_cache_entries_warm_serving_with_preemption(model_params, spec):
    """The port's form of the JAX package's zero-compiles gate: after
    ``warmup`` (here through ``compile.warmup``), traffic with preemption
    adds no entry to the engine's step caches (with spec decode on, the
    verify steps of every draft length were built by the warmup)."""
    e = _build_engine(model_params, warmup=True, spec=spec)
    assert e.step_cache_entries() == (len(e.spec_k_ladder) if spec else 0)
    rng = _rng()
    fe = e.serving_frontend()
    c0 = e.step_cache_entries()
    hs = [fe.submit(_prompt(rng, 24), "lo", max_new_tokens=40)]
    for _ in range(5):
        fe.step()
    hs.append(fe.submit(_prompt(rng, 112), "hi", max_new_tokens=8))
    for i in range(6):
        hs.append(fe.submit(_prompt(rng, int(rng.randint(8, 40))),
                            "hi" if i % 2 else "lo",
                            max_new_tokens=int(rng.randint(4, 12))))
    assert _step_until(fe, lambda: all(h.finished for h in hs))
    assert all(h.status == "finished" for h in hs)
    assert fe.stats.preemptions >= 1     # pressure actually happened
    assert e.step_cache_entries() == c0  # ... and built nothing
    assert e.warmup() == 0               # a second warmup builds nothing
    fe.close()


def test_loop_crash_surfaces_and_unblocks_streams(model_params):
    """If the engine thread dies, stream readers unblock and the error
    surfaces at drain()/close() instead of hanging the client."""
    e = _build_engine(model_params)
    fe = e.serving_frontend()
    boom = RuntimeError("injected")

    def bad_pass():
        raise boom

    e._run_pass = bad_pass
    fe.start()
    h = fe.submit(_prompt(_rng(), 24), priority="hi", max_new_tokens=4)
    assert h.result(timeout=10.0) == []      # stream closed, not hung
    with pytest.raises(RuntimeError, match="serving loop died"):
        fe.drain(timeout=5.0)
    with pytest.raises(RuntimeError, match="serving loop died"):
        fe.close()


def test_close_idempotent_every_order(model_params):
    """Double-close and close-before-first-submit are no-ops; submit after
    close fails loudly instead of queueing into a dead loop."""
    # close before start, twice
    fe = _build_engine(model_params).serving_frontend()
    fe.close()
    fe.close()
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(np.arange(4, dtype=np.int32), priority="hi")
    # start -> close -> close, before any submit
    e = _build_engine(model_params)
    fe = e.serving_frontend().start()
    fe.close()
    fe.close()
    # normal traffic, then double close: second is a no-op
    fe = e.serving_frontend().start()
    h = fe.submit(_prompt(_rng(), 8), priority="hi", max_new_tokens=2)
    assert h.result(timeout=30.0) is not None
    fe.close()
    fe.close()
    assert e.free_blocks == e.allocator.total_blocks


def test_close_after_loop_death_raises_once(model_params):
    """A died engine thread raises at the FIRST close; the second close is
    an idempotent no-op (the error was already surfaced)."""
    e = _build_engine(model_params)
    fe = e.serving_frontend()
    boom = RuntimeError("injected")

    def bad_pass():
        raise boom

    e._run_pass = bad_pass
    fe.start()
    h = fe.submit(_prompt(_rng(), 8), priority="hi", max_new_tokens=2)
    assert h.result(timeout=10.0) == []      # loop died, stream closed
    with pytest.raises(RuntimeError, match="serving loop died"):
        fe.close()
    fe.close()                               # no re-raise, no re-teardown


def test_submit_rejects_pool_impossible_request(model_params):
    """A request whose full KV lifetime cannot fit the pool is rejected at
    submit — admitted optimistically it would wedge un-restorable after its
    first preemption."""
    e = _build_engine(model_params, num_blocks=4)   # 64-token pool
    fe = e.serving_frontend()
    with pytest.raises(ValueError, match="KV blocks"):
        fe.submit(np.arange(80, dtype=np.int32), priority="hi",
                  max_new_tokens=40)
    fe.close()


def test_preemption_victim_is_newest_lowest_priority(model_params):
    """Within the lowest class the planner preempts the NEWEST admission
    (LIFO) — the 2-token victim, not the 90-token one — preserving older
    requests' progress."""
    e = _build_engine(model_params, num_blocks=14)
    fe = e.serving_frontend()
    rng = _rng()
    h_old = fe.submit(_prompt(rng, 24), priority="lo", max_new_tokens=40)
    for _ in range(6):
        fe.step()                       # old victim accumulates progress
    h_new = fe.submit(_prompt(rng, 24), priority="lo", max_new_tokens=40)
    for _ in range(2):
        fe.step()
    assert h_new.status == "decoding" and h_old.status == "decoding"
    assert len(h_old.tokens) > len(h_new.tokens)
    fe.submit(_prompt(rng, 112), priority="hi", max_new_tokens=8)
    assert _step_until(
        fe, lambda: "preempted" in (h_old.status, h_new.status), 40)
    assert h_new.status == "preempted"   # LIFO: newest low-pri goes first
    assert h_old.status != "preempted"
    fe.close()


# --------------------------------------------------------------------------- #
# phase ledger + SLO-miss attribution 
# --------------------------------------------------------------------------- #

def test_request_handle_ledger_and_attribution_summary():
    from deepspeed_tpu_torch.inference.v2.serving.frontend import RequestHandle
    cls = PriorityClassConfig(name="hi", priority=2)
    h = RequestHandle(7, np.zeros(4, np.int32), cls, 8, None, 100.0)
    # flow ids are process-unique mints, NOT uids (uid bases restart per
    # cluster lifetime): two handles never share one, even with equal uids
    h2 = RequestHandle(7, np.zeros(4, np.int32), cls, 8, None, 100.0)
    assert h.trace_id != h2.trace_id
    h._ledger_add("queued", 100.0, 100.25)
    h._ledger_add("prefill", 100.25, 100.5)
    h._ledger_add("decode", 100.5, 102.0)
    h._last_emit_t = 102.0
    assert h.timeline() == [("queued", 100.0, 100.25),
                            ("prefill", 100.25, 100.5),
                            ("decode", 100.5, 102.0)]
    attr = h.attribution()
    assert attr["dominant"] == "decode"
    assert attr["phases"]["queued"] == pytest.approx(0.25)
    assert attr["total_s"] == pytest.approx(2.0)
    assert attr["client_s"] == pytest.approx(2.0)
    assert attr["residual_s"] == pytest.approx(0.0)
    # timeline() is a copy: mutating it cannot corrupt the ledger
    h.timeline().append(("bogus", 0.0, 1.0))
    assert len(h.timeline()) == 3


def test_finished_request_ledger_tiles_client_latency(model_params):
    """The acceptance-bar invariant, at unit scope: a finished request's
    stints are GAPLESS from arrival to last emission, so their durations
    sum to the client-measured latency (TTFT + sum TBT)."""
    e = _build_engine(model_params)
    fe = e.serving_frontend()
    rng = _rng()
    hs = [fe.submit(_prompt(rng, n), priority="hi", max_new_tokens=6)
          for n in (24, 9)]
    assert _step_until(fe, lambda: all(h.finished for h in hs))
    for h in hs:
        assert h.status == "finished"
        tl = h.timeline()
        assert tl[0][0] == "queued" and tl[0][1] == h.arrival_t
        for (_, _, t1a), (_, t0b, _) in zip(tl, tl[1:]):
            assert t0b == pytest.approx(t1a, abs=1e-9)   # gapless
        attr = h.attribution()
        assert {"queued", "admission", "prefill", "decode"} <= \
            set(attr["phases"])
        assert attr["client_s"] is not None
        assert abs(attr["residual_s"]) <= max(0.005, 0.01 * attr["client_s"])
    fe.close()


def test_slo_miss_buckets_by_dominant_phase(model_params):
    """An impossible TBT SLO (sheds gate only on TTFT) forces every
    finished request into the miss buckets: serve/slo/* rows carry the
    dominant phase and the ledger-consistency count."""
    tight = [{"name": "hi", "priority": 2,
              "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e-6},
             {"name": "lo", "priority": 0,
              "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6}]
    e = _build_engine(model_params, serving={"classes": tight})
    fe = e.serving_frontend()
    h = fe.submit(_prompt(_rng(), 24), priority="hi", max_new_tokens=6)
    assert _step_until(fe, lambda: h.finished)
    assert h.status == "finished"
    dom = h.attribution()["dominant"]
    assert fe.stats.slo_missed == 1
    assert fe.stats.slo_missed_by_phase == {dom: 1}
    assert fe.stats.slo_missed_by_class == {"hi": 1}
    assert fe.stats.slo_attr_consistent == 1   # ledger summed to client
    names = {n for n, _, _ in fe.stats.events()}
    assert {"serve/slo/missed", "serve/slo/attr_consistent",
            f"serve/slo/dominant/{dom}", "serve/slo/by_class/hi"} <= names
    fe.close()


def test_attribution_off_is_inert(model_params):
    """The A/B lever: ``attribution: false`` records no ledger (misses
    bucket as unattributed)."""
    tight = [{"name": "hi", "priority": 2,
              "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e-6},
             {"name": "lo", "priority": 0,
              "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6}]
    e = _build_engine(model_params,
                      serving={"classes": tight, "attribution": False})
    fe = e.serving_frontend()
    h = fe.submit(_prompt(_rng(), 24), priority="hi", max_new_tokens=6)
    assert _step_until(fe, lambda: h.finished)
    assert h._ledger is None and h.timeline() == []
    attr = h.attribution()
    assert attr["phases"] == {} and attr["dominant"] is None
    assert fe.stats.slo_missed == 1
    assert fe.stats.slo_missed_by_phase == {"unattributed": 1}
    assert fe.stats.slo_attr_consistent == 0
    fe.close()
