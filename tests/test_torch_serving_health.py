"""The port's fault-tolerant serving (deepspeed_tpu_torch.inference.v2.serving
health.py): its own copies of the JAX package's health gates
(tests/unit/test_serving_health.py), by name, on tiny port engines on the
CPU — replica failure detection (liveness + progress-stall deadlines),
request failover with KV salvage, self-healing rejoin, the prefix-index
listener lifecycle, and the bounded-retry disaggregated handoff. The stall
test drives ``HealthMonitor(clock=...)`` by hand: no wall-clock deadline
decides it."""

import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.serving import (ServingCluster, ServingRouter)
from deepspeed_tpu_torch.inference.v2.serving.health import (DOWN, DRAINING,
                                                             HEALTHY, SUSPECT,
                                                             HealthMonitor)
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.monitor.serving import HealthStats
from deepspeed_tpu_torch.utils import fault_injection as fi
from deepspeed_tpu_torch.utils.resilience import IOTimeout

from tests._torch_threads import one_torch_thread  # noqa: F401

_CLASSES = [{"name": "hi", "priority": 2,
             "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6},
            {"name": "lo", "priority": 0,
             "ttft_slo_ms": 1e6, "tbt_slo_ms": 1e6}]
_SERVING = {"decode_slice": 4, "idle_wait_s": 0.005, "classes": _CLASSES}
#: fast deadlines so stall detection fits a unit test (still generous
#: enough that a GIL-contended warm step on a 2-core box stays under them)
_HEALTH = {"enabled": True, "interval_s": 0.01,
           "suspect_after_s": 0.25, "down_after_s": 0.6,
           "fence_join_s": 0.5}


def _model_and_params(seed=0):
    cfg = LlamaConfig.tiny(vocab_size=128, max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    return model, model.flat_params()


@pytest.fixture(scope="module")
def model_params():
    return _model_and_params()


def _build_engine(model_params, num_blocks=24, prefix_cache=False,
                  preemption=None, warmup=False):
    model, params = model_params
    serving = dict(_SERVING)
    if preemption is not None:
        serving["preemption"] = preemption
    econf = {"dtype": torch.float32,
             "state_manager": {"max_tracked_sequences": 8,
                               "max_ragged_sequence_count": 4,
                               "max_ragged_batch_size": 96,
                               "max_context": 176,
                               "prefill_chunk_size": 32},
             "kv_cache": {"block_size": 16, "num_blocks": num_blocks},
             "serving": serving}
    if prefix_cache:
        econf["prefix_cache"] = {"enabled": True}
    if warmup:
        econf["compile"] = {"warmup": True}
    return InferenceEngineV2(model, econf, params, device="cpu")


def _force_paged(engine):
    """Hold the kernel path constant: a migration re-prefill is a from-zero
    prefill, which would take the PACKED prefill pass while the
    uninterrupted reference decoded through the paged path; forced paged,
    the gate tests exactly what failover changes: WHERE the stream runs."""
    orig = engine.scheduler.schedule_pass

    def no_fast_path():
        b = orig()
        if b is not None:
            b.pure_prefill = False
        return b

    engine.scheduler.schedule_pass = no_fast_path


def _warm(rt, rng, n=1):
    """Serve one tiny request on EVERY replica frontend BEFORE the router
    (and its health monitor) starts, so the first passes' one-time costs
    cannot be misread by the aggressive unit-test stall deadlines as a
    wedged replica. Call before ``rt.start()``."""
    rt.cluster.start()
    for r in rt.cluster.frontends:
        for _ in range(n):
            h = r.frontend.submit(_prompt(rng, 8), priority="lo",
                                  max_new_tokens=2)
            assert r.frontend.drain(timeout=120)
            assert h.status == "finished"


def _rng():
    return np.random.RandomState(0)


def _prompt(rng, n):
    return rng.randint(0, 128, size=(n,)).astype(np.int32)


def _direct_stream(engine, prompt, n):
    uid = 97_000 + _direct_stream.k
    _direct_stream.k += 1
    engine._put_nofetch([uid], [np.asarray(prompt, np.int32)])
    out = engine.decode_pipeline([uid]).run(n)
    engine.flush([uid])
    return [int(t) for t in out[0]]


_direct_stream.k = 0


def _router(engines, health=None, router_cfg=None, roles=None):
    cluster = ServingCluster(engines, serving=_SERVING, roles=roles)
    cfg = dict(router_cfg or {"policy": "round_robin"})
    cfg["health"] = dict(_HEALTH if health is None else health)
    return ServingCluster, ServingRouter(cluster, cfg)


def _crash(replica):
    """Kill a replica's serving loop the way the router's crash test does."""
    boom = RuntimeError("injected crash")

    def bad(*a, **k):
        raise boom

    replica.engine._run_pass = bad
    replica.frontend._pipe.run = bad


def _uncrash(replica):
    try:
        del replica.engine._run_pass
    except AttributeError:
        pass


# --------------------------------------------------------------------------- #
# crash failover: detection, migration, byte-identical resumption
# --------------------------------------------------------------------------- #

def test_crash_failover_stream_byte_identical(model_params):
    """An engine-thread crash mid-stream: the health monitor detects it,
    fences the corpse, migrates the request, and the SAME handle's stream
    completes byte-identical to an uninterrupted run — no raise at drain,
    a one-time ``migrated`` marker, and the dead replica out of rotation."""
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    _force_paged(e0)
    _force_paged(e1)
    rng = _rng()
    p = _prompt(rng, 24)
    ref = _direct_stream(e0, p, 60)
    _, rt = _router([e0, e1],
                    health=dict(_HEALTH, auto_rejoin=False))
    _warm(rt, rng)
    rt.start()
    h = rt.submit(p, priority="hi", max_new_tokens=60)      # rr -> r0
    for _t in h:                     # stream flowing on r0
        break
    _crash(rt.cluster.replica("r0"))
    assert rt.drain(timeout=60)      # handled: drain does NOT raise
    assert h.result(timeout=10) == ref
    assert h.status == "finished"
    assert h.migrated == 1
    st = rt.health.stats
    assert st.liveness_downs == 1
    assert st.migrations == 1 and st.reprefilled == 1
    assert rt.health.state("r0") == DRAINING     # out of rotation, no rejoin
    assert rt.health.state("r1") == HEALTHY
    # new traffic lands on the survivor only
    h2 = rt.submit(p, priority="hi", max_new_tokens=4)
    assert rt.drain(timeout=60)
    assert h2.status == "finished"
    _uncrash(rt.cluster.replica("r0"))
    rt.close()                       # handled failure: close does not raise
    rt.close()


def test_stall_detection_and_migration(model_params):
    """A WEDGED replica (loop thread alive but frozen) walks
    healthy -> suspect -> down on the progress heartbeat's stall deadline;
    its stream migrates and completes byte-identically, and the woken
    thread's late emissions are dropped by the fence/seal (no duplicate or
    divergent tokens). The monitor's stall clock is advanced by hand (the
    ``clock`` seam), so no wall-clock deadline decides the walk."""
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    _force_paged(e0)
    _force_paged(e1)
    rng = _rng()
    p = _prompt(rng, 24)
    ref = _direct_stream(e0, p, 48)
    # the background poller sleeps through the test: only the polls below
    # (and drain's inline one) run
    health = dict(_HEALTH, auto_rejoin=False, interval_s=3600.0)
    _, rt = _router([e0, e1], health=health)
    now = [0.0]
    rt.health = HealthMonitor(rt, rt.config.health, clock=lambda: now[0])
    _warm(rt, rng)
    rt.start()
    h = rt.submit(p, priority="hi", max_new_tokens=48)      # rr -> r0
    for _t in h:
        break
    # wedge r0's loop: its next step() blocks until released — liveness
    # stays OK, progress freezes
    gate, entered = threading.Event(), threading.Event()
    fe0 = rt.cluster.replica("r0").frontend
    orig_step = fe0.step

    def wedged_step():
        entered.set()
        gate.wait(30.0)
        return orig_step()

    fe0.step = wedged_step
    try:
        assert entered.wait(10.0), "r0's loop never reached the wedge"
        rt.health.poll()                  # the frozen counters, at t = 0
        rt.health.poll()                  # ... unchanged: the stall starts
        assert rt.health.state("r0") == HEALTHY
        now[0] = _HEALTH["suspect_after_s"]
        rt.health.poll()
        assert rt.health.state("r0") == SUSPECT
        now[0] = _HEALTH["down_after_s"]
        rt.health.poll()                  # down: fenced and migrated
        assert rt.health.state("r0") == DRAINING
        assert rt.health.stats.stall_downs == 1
        assert rt.health.stats.detect_ms   # latency recorded
    finally:
        gate.set()                        # the wedged thread wakes fenced
    assert rt.drain(timeout=30)
    assert h.result(timeout=10) == ref   # exact: no duplicates, no gaps
    assert h.migrated == 1
    rt.close()


def test_fenced_frontend_emits_nothing(model_params):
    """Unit contract behind the stall case: a fenced frontend's
    ``_on_tokens`` drops the row and stops every uid; a sealed handle's
    row is dropped for that request alone."""
    e = _build_engine(model_params)
    fe = e.serving_frontend()
    req = fe.submit(np.arange(4, dtype=np.int32), priority="hi",
                    max_new_tokens=8)
    fe._drain_control()
    req.status = "decoding"
    fe._live[req.uid] = req
    # sealed: row dropped for this request
    req._seal()
    assert fe._on_tokens(0, [req.uid], np.asarray([[7]])) is None
    assert req.tokens == [] and req._q.qsize() == 0
    with req._emit_lock:
        req._sealed = False
    # fenced: everything stops, nothing lands
    fe.fence()
    assert fe._on_tokens(0, [req.uid], np.asarray([[7]])) == [req.uid]
    assert req.tokens == [] and req._q.qsize() == 0


# --------------------------------------------------------------------------- #
# KV salvage: preempt-offloaded pages become a survivor's import
# --------------------------------------------------------------------------- #

def test_offloaded_kv_salvaged_through_import(model_params):
    """A victim preempted-by-offload whose WHOLE KV sits in pinned host
    buffers when its replica dies is salvaged: the buffers ride
    ``submit_handoff`` -> ``import_kv`` on a survivor (zero recompute) and
    the stream completes byte-identically."""
    e0 = _build_engine(model_params, num_blocks=14)
    e1 = _build_engine(model_params, num_blocks=24)
    rng = _rng()
    p_lo = [_prompt(rng, 24), _prompt(rng, 24)]
    refs = [_direct_stream(e1, p, 48) for p in p_lo]
    _, rt = _router([e0, e1], health=dict(_HEALTH, auto_rejoin=False))
    # drive r0's loop synchronously (no thread): deterministic preemption
    fe0 = rt.cluster.replica("r0").frontend
    lows = [fe0.submit(p, priority="lo", max_new_tokens=48) for p in p_lo]
    for _ in range(60):                    # decode until pool pressure
        fe0.step()
        if e0.scheduler.available_blocks < 8:
            break
    h_hi = fe0.submit(_prompt(rng, 96), priority="hi", max_new_tokens=4)
    for _ in range(200):
        fe0.step()
        if fe0.offload._recs:
            break
    assert fe0.offload._recs               # a victim parked in host buffers
    victim_uid = next(iter(fe0.offload._recs))
    victim = next(h for h in lows if h.uid == victim_uid)
    ref = refs[lows.index(victim)]
    assert fe0.offload.salvageable(victim_uid)
    n_before = len(victim.tokens)
    assert 0 < n_before < 48
    # r0 dies with the victim still offloaded
    fe0._loop_exc = RuntimeError("injected death")
    rt.cluster.replica("r1").frontend.start()
    rt.health.poll()                       # detect + failover synchronously
    st = rt.health.stats
    assert st.salvaged == 1 and st.salvaged_bytes > 0
    assert st.salvaged_tokens == len(victim.prompt) + n_before
    assert rt.cluster.replica("r1").frontend.drain(timeout=120)
    assert victim.result(timeout=10) == ref  # byte-identical across salvage
    assert victim.migrated == 1
    # the other requests were decoding (not offloaded): re-prefilled on the
    # survivor (or already finished at the crash)
    assert h_hi.status == "finished" and len(h_hi.tokens) == 4
    assert all(h.status == "finished" for h in lows)
    assert st.reprefilled >= 1
    rt.close()


# --------------------------------------------------------------------------- #
# cancel-during-migration + double failure
# --------------------------------------------------------------------------- #

def test_cancel_during_migration_releases_everything(model_params):
    """``h.cancel()`` landing while a request is mid-failover: the handle
    terminal-states (no hang), and after the failed replica rejoins, every
    replica the request touched is back at allocator baseline."""
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    _force_paged(e0)
    _force_paged(e1)
    free0, free1 = e0.free_blocks, e1.free_blocks
    rng = _rng()
    _, rt = _router([e0, e1], health=dict(_HEALTH, auto_rejoin=False))
    _warm(rt, rng)
    rt.start()
    h = rt.submit(_prompt(rng, 24), priority="hi", max_new_tokens=48)
    for _t in h:
        break
    _crash(rt.cluster.replica("r0"))
    h.cancel()                       # lands in the failover window
    assert rt.drain(timeout=60)
    assert h.result(timeout=10) is not None
    assert h.status in ("cancelled", "finished")
    _uncrash(rt.cluster.replica("r0"))
    assert rt.rejoin("r0")           # reset reclaims the dead state
    assert rt.health.state("r0") == HEALTHY
    rt.close()
    assert e0.free_blocks == free0
    assert e1.free_blocks == free1


def test_double_failure_completes_on_third_or_sheds(model_params):
    """A second replica dying during migration: with a third survivor the
    stream completes there (byte-identical); with none left it sheds
    cleanly — closed stream, no hang, no leaked pages."""
    engines = [_build_engine(model_params) for _ in range(3)]
    for e in engines:
        _force_paged(e)
    frees = [e.free_blocks for e in engines]
    rng = _rng()
    p = _prompt(rng, 24)
    ref = _direct_stream(engines[0], p, 40)
    _, rt = _router(engines, health=dict(_HEALTH, auto_rejoin=False))
    _warm(rt, rng)
    rt.start()
    h = rt.submit(p, priority="hi", max_new_tokens=40)      # rr -> r0
    for _t in h:
        break
    # r1 dies FIRST (so migration off r0 must skip it), then r0 dies
    _crash(rt.cluster.replica("r1"))
    _crash(rt.cluster.replica("r0"))
    assert rt.drain(timeout=60)
    assert h.result(timeout=10) == ref   # completed on r2
    # one hop if failover skipped the already-dead r1, two if the request
    # landed on r1 before ITS death was detected — either way it completed
    assert h.status == "finished" and h.migrated in (1, 2)
    for r in ("r0", "r1"):
        _uncrash(rt.cluster.replica(r))
        assert rt.rejoin(r)
    rt.close()
    for e, f in zip(engines, frees):
        assert e.free_blocks == f

    # --- no survivor at all: clean shed ------------------------------- #
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    _, rt = _router([e0, e1], health=dict(_HEALTH, auto_rejoin=False))
    _warm(rt, rng)
    rt.start()
    h = rt.submit(_prompt(rng, 24), priority="hi", max_new_tokens=40)
    for _t in h:
        break
    _crash(rt.cluster.replica("r1"))
    _crash(rt.cluster.replica("r0"))
    assert rt.drain(timeout=60)
    assert h.result(timeout=10) is not None     # stream closed, not hung
    assert h.status == "shed"
    assert rt.health.stats.migration_sheds >= 1
    # the whole cluster is down: a new submit sheds at the router
    h2 = rt.submit(_prompt(rng, 8), priority="hi", max_new_tokens=4)
    assert h2.status == "shed"
    rt.close()


# --------------------------------------------------------------------------- #
# satellite: prefix-index listener lifecycle (evict on close AND on failure)
# --------------------------------------------------------------------------- #

def test_closed_replica_index_evicted_and_unroutable(model_params):
    """Regression: a replica frontend closed out of band used
    to keep its chain->holders entries forever and keep attracting
    cache-affine routes. Now close evicts its index entries and routing
    skips it — a same-prefix request lands on the survivor and completes."""
    e0 = _build_engine(model_params, prefix_cache=True)
    e1 = _build_engine(model_params, prefix_cache=True)
    rng = _rng()
    prefix = _prompt(rng, 32)

    def with_prefix(tail):
        return np.concatenate([prefix, _prompt(rng, tail)])

    # health DISABLED: the close-listener path must work on its own
    cluster = ServingCluster([e0, e1], serving=_SERVING)
    rt = ServingRouter(cluster, {"policy": "cache_aware", "balance": 1e-9})
    rt.start()
    p0 = with_prefix(8)
    h = rt.submit(p0, priority="hi", max_new_tokens=4)
    assert rt.drain(timeout=60)
    warm = max(rt.stats.routed, key=lambda k: rt.stats.routed[k])
    assert rt.index.holders(warm) > 0
    # close the warm replica's frontend OUT OF BAND
    rt.cluster.replica(warm).frontend.close()
    assert rt.index.holders(warm) == 0          # entries evicted at close
    h2 = rt.submit(with_prefix(8), priority="hi", max_new_tokens=4)
    assert rt.drain(timeout=60)
    assert h2.status == "finished"              # routed to the survivor
    other = "r1" if warm == "r0" else "r0"
    assert rt.stats.routed[other] >= 1
    rt.close()
    assert h.status == "finished"


def test_failed_replica_index_evicted(model_params):
    """Detected failure evicts the dead replica's chain entries too."""
    e0 = _build_engine(model_params, prefix_cache=True)
    e1 = _build_engine(model_params, prefix_cache=True)
    rng = _rng()
    _, rt = _router([e0, e1], health=dict(_HEALTH, auto_rejoin=False),
                    router_cfg={"policy": "cache_aware"})
    _warm(rt, rng)
    rt.start()
    p = _prompt(rng, 32)
    h = rt.submit(p, priority="hi", max_new_tokens=4)
    assert rt.drain(timeout=60)
    warm = max(rt.stats.routed, key=lambda k: rt.stats.routed[k])
    assert rt.index.holders(warm) > 0
    _crash(rt.cluster.replica(warm))
    # an idle crashed loop only dies when it next works: send traffic (the
    # warm prefix steers it onto the corpse) and let detection migrate it
    h2 = rt.submit(p, priority="hi", max_new_tokens=4)
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline and rt.index.holders(warm):
        rt.health.poll()
        time.sleep(0.01)
    assert rt.index.holders(warm) == 0
    assert rt.drain(timeout=60)
    _uncrash(rt.cluster.replica(warm))
    rt.close()
    assert h.status == "finished"
    assert h2.status == "finished"


# --------------------------------------------------------------------------- #
# self-healing: rejoin resets, re-warms, re-registers
# --------------------------------------------------------------------------- #

def test_rejoin_fresh_uid_space_zero_new_programs(model_params):
    """Rejoin rebuilds the frontend in a FRESH uid space, re-warms with
    ZERO new step-cache entries on an already-warm engine, replays the surviving
    radix tree into the index, and the replica serves again."""
    e0 = _build_engine(model_params, prefix_cache=True, warmup=True)
    e1 = _build_engine(model_params, prefix_cache=True, warmup=True)
    rng = _rng()
    p = _prompt(rng, 32)
    _, rt = _router([e0, e1], health=dict(_HEALTH, auto_rejoin=False),
                    router_cfg={"policy": "cache_aware"})
    # warm BOTH replicas' caches through real traffic BEFORE the monitor
    # starts (a first-use cost would be misread by the aggressive test
    # deadlines as a stall)
    rt.cluster.start()
    for _ in range(2):
        for repl in ("r0", "r1"):
            fe = rt.cluster.replica(repl).frontend
            hh = fe.submit(p, priority="hi", max_new_tokens=4)
            assert fe.drain(timeout=120)
            assert hh.status == "finished"
    rt.start()
    fe0_old = rt.cluster.replica("r0").frontend
    old_base = next(fe0_old._uid_iter)
    # an idle loop never trips over a poisoned pass — declare the death
    # directly (the loop-exc liveness signal) and let one poll handle it
    fe0_old._loop_exc = RuntimeError("injected death")
    rt.health.poll()
    assert rt.health.state("r0") == DRAINING
    c0 = e0.step_cache_entries()
    assert rt.rejoin("r0")
    assert e0.step_cache_entries() - c0 == 0   # re-warm built nothing new
    assert rt.health.stats.rejoins == 1
    fe0 = rt.cluster.replica("r0").frontend
    assert fe0 is not fe0_old
    new_base = next(fe0._uid_iter)
    assert new_base > old_base          # fresh, disjoint uid space
    assert (new_base >> 24) != (old_base >> 24)
    # the surviving radix tree replayed into the index
    assert rt.index.holders("r0") > 0
    h = rt.submit(p, priority="hi", max_new_tokens=4)
    assert rt.drain(timeout=60)
    assert h.status == "finished"
    rt.close()


# --------------------------------------------------------------------------- #
# satellite: disaggregated handoff under retry_call/IOTimeout
# --------------------------------------------------------------------------- #

def test_handoff_retry_then_success(model_params):
    """A transient handoff failure (one injected raise) retries within the
    budget and the stream completes normally."""
    e_pre, e_dec = _build_engine(model_params), _build_engine(model_params)
    fi.install(fi.parse_plan("serve.handoff:at=1:action=raise"))
    try:
        cluster = ServingCluster([e_pre, e_dec],
                                 roles=["prefill", "decode"],
                                 serving=_SERVING)
        rt = ServingRouter(cluster, {"topology": "disaggregated",
                                     "handoff_retries": 3,
                                     "handoff_backoff_s": 0.01}).start()
        h = rt.submit(_prompt(_rng(), 24), priority="hi", max_new_tokens=4)
        assert rt.drain(timeout=60)
        assert h.status == "finished" and len(h.tokens) == 4
        assert rt.stats.handoffs == 1
        assert rt.stats.handoff_failures == 0
        rt.close()
    finally:
        fi.clear()


def test_handoff_budget_exhausted_surfaces_named(model_params):
    """Every attempt failing (injected) exhausts the bounded budget: the
    request sheds with the error NAMED on the handle — ``result()``
    re-raises it, naming the prefill replica — never a silent hang."""
    e_pre, e_dec = _build_engine(model_params), _build_engine(model_params)
    fi.install(fi.parse_plan("serve.handoff:every=1:action=raise"))
    try:
        cluster = ServingCluster([e_pre, e_dec],
                                 roles=["prefill", "decode"],
                                 serving=_SERVING)
        rt = ServingRouter(cluster, {"topology": "disaggregated",
                                     "handoff_retries": 2,
                                     "handoff_backoff_s": 0.01}).start()
        h = rt.submit(_prompt(_rng(), 24), priority="hi", max_new_tokens=4)
        assert rt.drain(timeout=60)
        assert h.status == "shed"
        with pytest.raises(RuntimeError, match="prefill replica 'r0'"):
            h.result(timeout=5)
        assert rt.stats.handoff_failures == 1
        rt.close()
    finally:
        fi.clear()


def test_handoff_stall_times_out(model_params):
    """A STALLED handoff attempt (injected sleep past handoff_timeout_s)
    surfaces IOTimeout inside the retry loop instead of wedging the prefill
    worker; with only one decode replica the budget exhausts and the error
    chain names the timeout."""
    e_pre, e_dec = _build_engine(model_params), _build_engine(model_params)
    fi.install(fi.parse_plan(
        "serve.handoff:every=1:action=stall:delay_s=0.5"))
    try:
        cluster = ServingCluster([e_pre, e_dec],
                                 roles=["prefill", "decode"],
                                 serving=_SERVING)
        rt = ServingRouter(cluster, {"topology": "disaggregated",
                                     "handoff_retries": 2,
                                     "handoff_timeout_s": 0.05,
                                     "handoff_backoff_s": 0.01}).start()
        h = rt.submit(_prompt(_rng(), 24), priority="hi", max_new_tokens=4)
        assert rt.drain(timeout=60)
        assert h.status == "shed"
        assert h.error is not None
        assert isinstance(h.error.__cause__, IOTimeout)
        rt.close()
    finally:
        fi.clear()


# --------------------------------------------------------------------------- #
# fault-injection sites exist where the chaos bench aims
# --------------------------------------------------------------------------- #

def test_serving_fault_sites_fire(model_params):
    """The serving chaos sites are actually threaded through the code:
    serve.engine_step.<replica> crashes exactly the targeted loop;
    serve.kv_fetch raises out of the page gather."""
    e0 = _build_engine(model_params)
    fi.install(fi.parse_plan("serve.kv_fetch:at=1:action=raise"))
    try:
        e0._put_nofetch([5], [_prompt(_rng(), 20)])
        with pytest.raises(fi.InjectedFault):
            e0.fetch_pages(list(e0.scheduler.seqs[5].blocks))
        e0.flush([5])
    finally:
        fi.clear()

    e1 = _build_engine(model_params)
    fi.install(fi.parse_plan("serve.engine_step.r0:at=2:action=raise"))
    try:
        # huge stall deadlines: these engines run COLD (warming would
        # advance r0's step counter past the at=2 trigger) — only the
        # liveness path is under test here
        _, rt = _router([e0, e1],
                        health=dict(_HEALTH, auto_rejoin=False,
                                    suspect_after_s=10.0,
                                    down_after_s=30.0))
        rt.start()
        h = rt.submit(_prompt(_rng(), 16), priority="hi", max_new_tokens=8)
        assert rt.drain(timeout=60)
        # r0's loop died on its 2nd step; the stream still finished
        assert h.status == "finished" and len(h.tokens) == 8
        assert rt.health.stats.liveness_downs == 1
        assert rt.health.state("r0") == DRAINING
        rt.close()
    finally:
        fi.clear()


# --------------------------------------------------------------------------- #
# observability: HealthStats events + serve/health spans through trace_check
# --------------------------------------------------------------------------- #

def test_health_stats_events_shape():
    st = HealthStats(["r0", "r1"])
    st.record_transition("r0", "healthy", "suspect")
    st.record_transition("r0", "suspect", "down")
    st.record_detection("stall", 0.4)
    st.record_migration("salvage", 48, 4096)
    st.record_migration("reprefill", 30)
    st.record_rejoin(0.25)
    ev = {name: v for name, v, _ in st.events(step=3)}
    assert ev["serve/health/transitions"] == 2.0
    assert ev["serve/health/stall_downs"] == 1.0
    assert ev["serve/health/migrations"] == 2.0
    assert ev["serve/health/salvaged"] == 1.0
    assert ev["serve/health/salvaged_tokens"] == 48.0
    assert ev["serve/health/salvaged_bytes"] == 4096.0
    assert ev["serve/health/reprefilled_tokens"] == 30.0
    assert ev["serve/health/rejoins"] == 1.0
    assert ev["serve/health/rejoin_warmup_ms"] == pytest.approx(250.0)
    assert ev["serve/health/detect_p50_ms"] == pytest.approx(400.0)
    assert ev["serve/health/state/r0"] == 2.0       # down
    assert ev["serve/health/state/r1"] == 0.0       # healthy


def test_health_spans_pass_trace_check(model_params, tmp_path):
    """Detection, migration and rejoin leave serve/health spans — from the
    same perf stamps the stats aggregate — that pass the real trace_check
    with a required serve/health track."""
    from deepspeed_tpu_torch.monitor.trace import tracer
    tracer.reset()
    tracer.configure(trace_dir=str(tmp_path), enabled=True)
    try:
        e0, e1 = _build_engine(model_params), _build_engine(model_params)
        rng = _rng()
        _, rt = _router([e0, e1], health=dict(_HEALTH, auto_rejoin=False))
        _warm(rt, rng)
        rt.start()
        h = rt.submit(_prompt(rng, 24), priority="hi", max_new_tokens=24)
        for _t in h:
            break
        _crash(rt.cluster.replica("r0"))
        assert rt.drain(timeout=60)
        _uncrash(rt.cluster.replica("r0"))
        assert rt.rejoin("r0")
        rt.close()
        assert h.status == "finished"
        names = tracer.summary()
        assert "serve/health/detect" in names
        assert "serve/health/migrate" in names
        assert "serve/health/rejoin" in names
        # stats-equals-spans: one detect per down, one migrate per
        # migration, one rejoin per rejoin
        st = rt.health.stats
        assert names["serve/health/detect"][0] == \
            st.liveness_downs + st.stall_downs
        assert names["serve/health/migrate"][0] == st.migrations
        assert names["serve/health/rejoin"][0] == st.rejoins
        path = tracer.export()
        import subprocess
        import sys
        r = subprocess.run(
            [sys.executable, "scripts/trace_check.py", path,
             "--require", "serve/health"],
            capture_output=True, text=True,
            cwd=str(__import__("pathlib").Path(__file__).
                    resolve().parents[1]), timeout=60)
        assert r.returncode == 0, r.stdout + r.stderr
    finally:
        tracer.reset()


def test_cluster_uid_spaces_disjoint(model_params):
    """Cluster frontends mint uids from disjoint spaces — migration can
    move any handle anywhere without collision."""
    e0, e1 = _build_engine(model_params), _build_engine(model_params)
    cluster = ServingCluster([e0, e1], serving=_SERVING)
    b0 = next(cluster.replicas[0].frontend._uid_iter)
    b1 = next(cluster.replicas[1].frontend._uid_iter)
    assert (b0 >> 24) != (b1 >> 24)
    assert cluster.alloc_uid_base() > max(b0, b1)


def test_monitor_reads_never_wait_out_a_blocking_failover():
    """Regression: ``poll()`` used to hold the monitor
    lock through the whole failover — including ``fe.join(fence_join_s)``
    on the dead replica's thread — so ``all_healthy()`` /
    ``handled_replicas()`` from the router or a bench waited out the full
    fence-join timeout behind it. The restructure CLAIMS the record under
    the lock and runs the blocking legs with the lock released; this test
    parks a fake frontend inside the fence join and asserts the read
    surface still answers immediately."""
    entered, release = threading.Event(), threading.Event()

    class _FE:
        _loop_exc = RuntimeError("engine loop died")   # liveness -> down
        _reqs: dict = {}
        _inflight_lock = threading.Lock()

        def fence(self):
            pass

        def join(self, timeout):
            entered.set()
            release.wait(timeout)   # honors fence_join_s: pre-fix the
            # monitor lock stayed held for this whole wait

        def _scrape_control(self):
            return []

    class _Replica:
        name, role = "r0", "decode"
        frontend, engine = _FE(), None

    class _Cluster:
        replicas = [_Replica()]

    class _Router:
        cluster = _Cluster()
        dropped: list = []

        def _drop_replica_routing(self, name):
            self.dropped.append(name)

    mon = HealthMonitor(_Router(), {
        "enabled": True, "interval_s": 0.01, "suspect_after_s": 0.25,
        "down_after_s": 0.6, "fence_join_s": 2.0, "auto_rejoin": False})
    t = threading.Thread(target=mon.poll, daemon=True)
    t.start()
    assert entered.wait(2.0), "failover never reached the fence join"
    try:
        # the blocking leg is in flight RIGHT NOW; reads must not queue
        # behind it (pre-fix: these blocked ~fence_join_s = 2 s)
        t0 = time.perf_counter()
        assert mon.all_healthy() is False
        assert mon.state("r0") == DOWN
        assert mon.handled_replicas() == []   # claimed, not yet handled
        assert time.perf_counter() - t0 < 0.5
    finally:
        release.set()
        t.join(5.0)
    assert not t.is_alive()
    assert mon.state("r0") == DRAINING
    assert mon.handled_replicas() == ["r0"]
