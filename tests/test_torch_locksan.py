"""The port's lock-order sanitizer (``deepspeed_tpu_torch.utils.locksan``,
wired through ``utils/threads``) on the JAX package's sanitizer tests, the
same observed caching edge as the JAX package's ``LRUCache`` under the JAX
sanitizer, and the sanitizer armed over a tiny GPT-2 engine's rolling and
async checkpoint paths (no lock-order cycle)."""

import threading

import numpy as np
import pytest

import deepspeed_tpu_torch
from deepspeed_tpu.utils import locksan as jax_locksan
from deepspeed_tpu.utils.caching import LRUCache as JaxLRUCache
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.utils import locksan
from deepspeed_tpu_torch.utils.caching import LRUCache
from deepspeed_tpu_torch.utils.threads import (make_condition, make_lock, make_rlock,
                                               make_semaphore)

from tests._torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def armed():
    locksan.arm()
    yield
    locksan.disarm()


def test_factories_return_plain_primitives_when_disarmed():
    locksan.disarm()
    try:
        assert not isinstance(make_lock("t.plain"), locksan.SanLock)
        assert not isinstance(make_semaphore("t.sem", 1), locksan.SanSemaphore)
    finally:
        locksan.disarm()


def test_factories_return_proxies_when_armed(armed):
    assert isinstance(make_lock("t.lock"), locksan.SanLock)
    assert isinstance(make_rlock("t.rlock"), locksan.SanLock)
    assert isinstance(make_semaphore("t.sem", 1), locksan.SanSemaphore)


def test_nested_acquisition_records_an_edge(armed):
    a, b = make_lock("t.a"), make_lock("t.b")
    with a:
        with b:
            assert locksan.held_locks() == ("t.a", "t.b")
    assert locksan.held_locks() == ()
    assert ("t.a", "t.b") in locksan.edges()
    assert ("t.b", "t.a") not in locksan.edges()


def test_rlock_reentry_records_no_self_edge(armed):
    r = make_rlock("t.r")
    with r:
        with r:
            pass
    assert ("t.r", "t.r") not in locksan.edges()


def test_cycle_detection_across_threads(armed):
    """A deliberate A -> B / B -> A pair on two threads (run one after the
    other, so this run cannot deadlock) is found as a cycle."""
    a, b = make_lock("t.a"), make_lock("t.b")
    with a:
        with b:
            pass

    def inverted():
        with b:
            with a:
                pass
    t = threading.Thread(target=inverted)
    t.start()
    t.join()
    cycles = locksan.find_cycles()
    assert cycles and set(cycles[0][:-1]) == {"t.a", "t.b"}
    assert locksan.report()["cycles"]


def test_consistent_order_has_no_cycles(armed):
    a, b = make_lock("t.a"), make_lock("t.b")
    for _ in range(3):
        with a:
            with b:
                pass
    assert locksan.find_cycles() == []


def test_note_blocking_only_records_under_held_locks(armed):
    locksan.note_blocking("fetch_to_host")
    assert locksan.blocking_events() == []
    lock = make_lock("t.hold")
    with lock:
        locksan.note_blocking("fetch_to_host")
    events = locksan.blocking_events()
    assert len(events) == 1
    held, what, _thread = events[0]
    assert held == ("t.hold",) and what == "fetch_to_host"


def test_semaphore_wait_is_a_blocking_event_not_a_held_lock(armed):
    lock = make_lock("t.outer")
    sem = make_semaphore("t.sem", 1)
    with lock:
        sem.acquire()
    sem.release()
    assert all("t.sem" not in e for e in locksan.edges())
    assert any(w == "semaphore:t.sem" for _, w, _ in locksan.blocking_events())


def test_check_static_flags_unpredicted_edges(armed):
    a, b = make_lock("t.a"), make_lock("t.b")
    with a:
        with b:
            pass
    assert locksan.check_static({("t.a", "t.b")}) == set()
    assert locksan.check_static(set()) == {("t.a", "t.b")}


def test_reset_clears_tables(armed):
    a, b = make_lock("t.a"), make_lock("t.b")
    with a:
        with b:
            locksan.note_blocking("x")
    locksan.reset()
    assert locksan.edges() == set()
    assert locksan.blocking_events() == []


def test_report_shape(armed):
    a, b = make_lock("t.a"), make_lock("t.b")
    with a:
        with b:
            pass
    rep = locksan.report()
    assert rep["armed"] is True
    assert {"from": "t.a", "to": "t.b",
            "thread": threading.current_thread().name} in rep["edges"]
    assert rep["cycles"] == [] and rep["blocking"] == []


def test_condition_factory_keeps_condition_semantics(armed):
    cv = make_condition("t.cv")
    hits = []

    def waiter():
        with cv:
            while not hits:
                cv.wait(timeout=5.0)
            hits.append("woke")
    t = threading.Thread(target=waiter)
    t.start()
    with cv:
        hits.append("go")
        cv.notify()
    t.join(timeout=5.0)
    assert not t.is_alive() and hits == ["go", "woke"]


def test_caching_edge_matches_jax_lru_cache(armed):
    """The port's LRUCache nests its per-key lock over its LRU lock under
    the names the JAX package gives them, and the sanitizer observes the
    same edge set as the JAX package's sanitizer over the JAX LRUCache
    (threadlint's static graph covers the JAX package only)."""
    LRUCache(maxsize=4).get_or_create("k", lambda: 1)
    jax_locksan.arm()
    try:
        JaxLRUCache(maxsize=4).get_or_create("k", lambda: 1)
        jax_edges = jax_locksan.edges()
    finally:
        jax_locksan.disarm()
    assert locksan.edges() == jax_edges == {("utils.caching.key", "utils.caching.lru")}


def test_named_locks_of_the_port_become_proxies(armed):
    """The locks the JAX package builds through the factory are built so in
    the port too: the fault injector's, the caches' and the LoRA
    registry's."""
    from deepspeed_tpu_torch.utils import fault_injection
    inj = fault_injection.parse_plan("x.site:at=99")
    assert isinstance(inj._lock, locksan.SanLock) and inj._lock.name == "utils.fault.hits"
    assert LRUCache(maxsize=2)._lock.name == "utils.caching.lru"
    from deepspeed_tpu_torch.inference.v2.lora import registry
    src = open(registry.__file__).read()
    assert 'make_lock("serving.lora.registry")' in src and "threading.Lock()" not in src


def _ckpt_engine(tmp_path):
    model = GPT2LMHead(GPT2Config.tiny(), device="cpu", seed=0)
    cfg = {"train_batch_size": 8, "steps_per_print": 0,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "checkpoint": {"engine": "async", "writers": 2,
                          "rolling": {"every_n_steps": 2, "keep_last": 2,
                                      "save_dir": str(tmp_path / "rolling")}}}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    return engine


def test_checkpoint_paths_have_no_lock_cycle(armed, tmp_path):
    """Armed before the engine is built: rolling saves (committer thread,
    async writers, backpressure semaphore), a user async save and a resume
    load, then teardown. No lock-order cycle; the engine's checkpoint locks
    are proxies."""
    engine = _ckpt_engine(tmp_path)
    rng = np.random.default_rng(0)
    for _ in range(4):
        engine.train_batch({"input_ids": rng.integers(0, 256, (8, 16)).astype(np.int32)})
    engine.save_checkpoint(str(tmp_path / "user"))
    cke = engine._checkpoint_engine()
    assert isinstance(cke._lock, locksan.SanLock)
    assert isinstance(engine._rolling._pending, locksan.SanSemaphore)
    engine.destroy()
    other = _ckpt_engine(tmp_path / "b")
    other.load_checkpoint(str(tmp_path / "rolling"))
    assert other.global_steps == 4
    other.destroy()
    assert engine.ckpt_stats.saves >= 2
    assert locksan.find_cycles() == []
    rep = locksan.report()
    assert rep["armed"] and rep["cycles"] == []
