"""The port's data pipeline (CPU): mirrors of
``tests/unit/test_data_pipeline.py``'s loader, sampler, curriculum, indexed
dataset, staging and PrefetchLoader tests (the same cases and expected
values), the JAX package's classes as references where they are numpy,
datasets written by either package read by the other, and the engine's
pipeline: prefetch 0 against 2, the curriculum seqlen, PLD, and the
prefetch iterator's reset on a checkpoint load.

Everything here is exact: the copied modules compute the same integers, and
within the port the same batches give the same bits.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.data import CurriculumScheduler as JaxCurriculum
from deepspeed_tpu.data import DeepSpeedDataSampler as JaxSampler
from deepspeed_tpu.data import make_builder as jax_make_builder
from deepspeed_tpu.data import make_dataset as jax_make_dataset
from deepspeed_tpu.runtime.dataloader import DeepSpeedTPUDataLoader as JaxLoader
from deepspeed_tpu_torch.data import (CurriculumScheduler, DeepSpeedDataSampler,
                                      MMapIndexedDataset, make_builder, make_dataset)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.monitor.training import TrainPipelineStats
from deepspeed_tpu_torch.runtime.data_pipeline import (HOST_KEYS, PrefetchLoader, StagedBatch,
                                                       inject_pld, needs_truncation,
                                                       stage_tree, truncate_to_seqlen)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedTPUDataLoader, RepeatingLoader

from tests._torch_threads import one_torch_thread  # noqa: F401


# ---------------------------- curriculum ---------------------------------- #

def _sched_cfg(**over):
    cfg = {"min_difficulty": 8, "max_difficulty": 64, "schedule_type": "fixed_linear",
           "schedule_config": {"total_curriculum_step": 100, "difficulty_step": 8}}
    cfg.update(over)
    return cfg


SCHEDULES = {
    "linear": _sched_cfg(),
    "root": _sched_cfg(schedule_type="fixed_root",
                       schedule_config={"total_curriculum_step": 100, "difficulty_step": 8,
                                        "root_degree": 2}),
    "discrete": _sched_cfg(schedule_type="fixed_discrete",
                           schedule_config={"difficulty": [8, 16, 64], "max_step": [10, 20]}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_curriculum_schedule_matches_jax(name):
    s, j = CurriculumScheduler(SCHEDULES[name]), JaxCurriculum(SCHEDULES[name])
    assert [s.get_difficulty(t) for t in range(0, 130)] == \
        [j.get_difficulty(t) for t in range(0, 130)]


def test_fixed_linear_schedule():
    s = CurriculumScheduler(_sched_cfg())
    assert s.get_difficulty(0) == 8
    assert s.get_difficulty(100) == 64
    assert s.get_difficulty(1000) == 64
    mid = s.get_difficulty(50)
    assert 8 <= mid <= 64 and mid % 8 == 0
    vals = [s.get_difficulty(t) for t in range(0, 101, 10)]
    assert vals == sorted(vals)


def test_fixed_root_and_discrete_schedules():
    root = CurriculumScheduler(SCHEDULES["root"])
    assert root.get_difficulty(25) >= CurriculumScheduler(_sched_cfg()).get_difficulty(25)
    assert root.get_difficulty(100) == 64
    d = CurriculumScheduler(SCHEDULES["discrete"])
    assert (d.get_difficulty(5), d.get_difficulty(15), d.get_difficulty(25)) == (8, 16, 64)


def test_curriculum_state_roundtrip():
    s = CurriculumScheduler(_sched_cfg())
    s.update_difficulty(50)
    s2 = CurriculumScheduler(_sched_cfg())
    s2.set_state(s.get_state())
    assert s2.current_difficulty == s.current_difficulty


# ---------------------------- indexed dataset ----------------------------- #

SEQS = [np.arange(5), np.arange(100, 103), np.arange(7)]


def _write(builder_fn, prefix, dtype):
    b = builder_fn(prefix, dtype=dtype)
    for s in SEQS[:2]:
        b.add_item(s)
    b.end_document()
    b.add_item(SEQS[2])
    b.end_document()
    b.finalize()


def test_indexed_dataset_roundtrip(tmp_path):
    prefix = str(tmp_path / "corpus")
    _write(make_builder, prefix, np.int32)
    ds = make_dataset(prefix)
    assert len(ds) == 3
    for i, s in enumerate(SEQS):
        np.testing.assert_array_equal(ds[i], s.astype(np.int32))
    np.testing.assert_array_equal(ds.get(1, offset=1, length=2), [101, 102])
    with pytest.raises(IndexError):
        ds.get(0, offset=3, length=5)


def test_indexed_dataset_bad_magic(tmp_path):
    prefix = str(tmp_path / "bad")
    with open(prefix + ".idx", "wb") as f:
        f.write(b"WRONGMAG" + b"\0" * 32)
    with open(prefix + ".bin", "wb") as f:
        f.write(b"")
    with pytest.raises(ValueError, match="magic"):
        MMapIndexedDataset(prefix)


@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.int64])
def test_indexed_dataset_moves_both_ways_between_the_packages(tmp_path, dtype):
    """The same bytes on disk: a dataset written by either package reads
    in the other, item for item."""
    for writer, reader, name in ((jax_make_builder, make_dataset, "jax"),
                                 (make_builder, jax_make_dataset, "port")):
        prefix = str(tmp_path / name)
        _write(writer, prefix, dtype)
        ds = reader(prefix)
        assert len(ds) == 3 and list(ds.doc_idx) == [0, 2, 3]
        for i, s in enumerate(SEQS):
            assert ds[i].dtype == np.dtype(dtype)
            np.testing.assert_array_equal(ds[i], s.astype(dtype))
    for ext in (".bin", ".idx"):
        with open(tmp_path / f"jax{ext}", "rb") as a, open(tmp_path / f"port{ext}", "rb") as b:
            assert a.read() == b.read(), ext


# ---------------------------- data sampler -------------------------------- #

def test_sampler_partitions_ranks():
    n, mbs, dp = 64, 4, 2
    seen = [set(), set()]
    for r in range(dp):
        for mb in DeepSpeedDataSampler(n, mbs, data_parallel_rank=r, data_parallel_size=dp,
                                       seed=7):
            assert len(mb) == mbs
            seen[r].update(mb)
    assert not (seen[0] & seen[1])
    assert len(seen[0] | seen[1]) == n


def test_sampler_resume_and_stream_match_jax():
    s = DeepSpeedDataSampler(32, 2, gradient_accumulation_steps=2, seed=3)
    it = iter(s)
    _ = [next(it), next(it)]   # one global batch consumed
    s2 = DeepSpeedDataSampler(32, 2, gradient_accumulation_steps=2, seed=3)
    s2.load_state_dict(s.state_dict())
    full = list(DeepSpeedDataSampler(32, 2, gradient_accumulation_steps=2, seed=3))
    assert list(s2) == full[2:]
    assert full == list(JaxSampler(32, 2, gradient_accumulation_steps=2, seed=3))


def test_sampler_curriculum_defers_hard_samples():
    n = 32
    difficulties = np.arange(n)
    cfg = {"min_difficulty": 8, "max_difficulty": 32, "schedule_type": "fixed_linear",
           "schedule_config": {"total_curriculum_step": 100, "difficulty_step": 8}}
    s = DeepSpeedDataSampler(n, 4, difficulties=difficulties,
                             curriculum=CurriculumScheduler(cfg), seed=0)
    first_batch = next(iter(s))
    assert all(difficulties[i] <= 8 for i in first_batch)
    j = JaxSampler(n, 4, difficulties=difficulties, curriculum=JaxCurriculum(cfg), seed=0)
    assert list(DeepSpeedDataSampler(n, 4, difficulties=difficulties,
                                     curriculum=CurriculumScheduler(cfg), seed=0)) == list(j)


# ---------------------------- dataloader ---------------------------------- #

def test_loader_drop_last_length_math():
    data = list(range(10))
    assert len(DeepSpeedTPUDataLoader(data, batch_size=4)) == 2
    assert len(DeepSpeedTPUDataLoader(data, batch_size=4, drop_last=False)) == 3
    batches = list(DeepSpeedTPUDataLoader(data, batch_size=4, shuffle=False, drop_last=False))
    assert [len(b) for b in batches] == [4, 4, 2]
    assert [len(b) for b in DeepSpeedTPUDataLoader(data, batch_size=4, shuffle=False)] == [4, 4]


def test_loader_collates_dicts_and_tuples():
    dict_data = [{"a": np.full((3,), i), "b": np.int32(i)} for i in range(4)]
    (batch,) = list(DeepSpeedTPUDataLoader(dict_data, batch_size=4, shuffle=False))
    assert set(batch) == {"a", "b"}
    assert batch["a"].shape == (4, 3) and batch["b"].shape == (4,)
    np.testing.assert_array_equal(batch["b"], [0, 1, 2, 3])
    tup_data = [(np.full((2,), i), np.full((1,), -i)) for i in range(4)]
    (batch,) = list(DeepSpeedTPUDataLoader(tup_data, batch_size=4, shuffle=False))
    assert isinstance(batch, tuple) and len(batch) == 2
    assert batch[0].shape == (4, 2) and batch[1].shape == (4, 1)


def test_loader_epoch_reshuffle_deterministic_and_matches_jax():
    data = [np.int32(i) for i in range(16)]

    def order(cls, seed, epoch):
        ld = cls(data, batch_size=4, seed=seed)
        ld.set_epoch(epoch)
        return [b.tolist() for b in ld]

    assert order(DeepSpeedTPUDataLoader, 7, 0) == order(DeepSpeedTPUDataLoader, 7, 0)
    assert order(DeepSpeedTPUDataLoader, 7, 0) != order(DeepSpeedTPUDataLoader, 7, 1)
    assert order(DeepSpeedTPUDataLoader, 7, 0) != order(DeepSpeedTPUDataLoader, 8, 0)
    for seed, epoch in ((7, 0), (7, 1), (42, 3)):
        assert order(DeepSpeedTPUDataLoader, seed, epoch) == order(JaxLoader, seed, epoch)


def test_repeating_loader_epoch_autobump_reshuffles():
    data = [np.int32(i) for i in range(16)]
    ld = DeepSpeedTPUDataLoader(data, batch_size=4, seed=3)
    rep = iter(RepeatingLoader(ld))
    first = [next(rep).tolist() for _ in range(4)]
    second = [next(rep).tolist() for _ in range(4)]
    assert ld.epoch == 1 and first != second
    assert sorted(sum(first, [])) == sorted(sum(second, [])) == list(range(16))
    rep2 = iter(RepeatingLoader(DeepSpeedTPUDataLoader(data, batch_size=4, seed=3)))
    assert [next(rep2).tolist() for _ in range(4)] == first
    assert [next(rep2).tolist() for _ in range(4)] == second


# ---------------------------- staging helpers ------------------------------ #

def test_truncate_to_seqlen_views_not_copies():
    batch = {"ids": np.arange(32).reshape(4, 8), "meta": np.arange(4)}
    out = truncate_to_seqlen(batch, 4)
    assert out["ids"].shape == (4, 4) and out["meta"].shape == (4,)
    assert out["ids"].base is not None and np.shares_memory(out["ids"], batch["ids"])
    out2 = truncate_to_seqlen(batch, 8)
    assert out2["ids"] is batch["ids"]
    assert not needs_truncation(batch, 8) and needs_truncation(batch, 7)


def test_inject_pld_step_keyed_determinism():
    b = {"input_ids": np.zeros((4, 2), np.int32)}
    one = inject_pld(dict(b), 4, 0.9, 5)
    two = inject_pld(dict(b), 4, 0.9, 5)
    other = inject_pld(dict(b), 4, 0.9, 6)
    np.testing.assert_array_equal(one["pld_rng"], two["pld_rng"])
    assert not np.array_equal(one["pld_rng"], other["pld_rng"])
    assert one["pld_theta"].shape == (4,) and one["pld_theta"].dtype == np.float32
    assert one["pld_rng"].shape == (4,) and one["pld_rng"].dtype == np.int64
    assert inject_pld([1, 2], 2, 0.5, 0) == [1, 2]       # not a dict: unchanged


def test_stage_tree_keeps_host_keys_on_the_host():
    host = inject_pld({"input_ids": np.arange(6, dtype=np.int32).reshape(2, 3)}, 2, 0.5, 1)
    tree, ready = stage_tree(host, torch.device("cpu"))
    assert ready is None and set(tree) == {"input_ids", *HOST_KEYS}
    assert all(t.device.type == "cpu" for t in tree.values())
    assert tree["input_ids"].tolist() == [[0, 1, 2], [3, 4, 5]]
    staged = StagedBatch(tree, 3, raw=host, ready=None)
    assert staged.wait() is tree


# ---------------------------- PrefetchLoader ------------------------------- #

def test_prefetch_loader_preserves_order_and_steps():
    items = [{"x": np.full((2,), i)} for i in range(8)]
    seen_steps = []

    def prepare(batch, step):
        seen_steps.append(step)
        return StagedBatch(batch, step)

    pl = PrefetchLoader(items, prepare=prepare, prefetch=2, start_step=10)
    out = list(pl)
    assert [int(s.tree["x"][0]) for s in out] == list(range(8))
    assert [s.step for s in out] == list(range(10, 18))
    assert seen_steps == list(range(10, 18))
    pl.close()


def test_prefetch_loader_sync_fallback_matches():
    items = [np.int32(i) for i in range(6)]
    prep = lambda b, s: (int(b), s)
    assert list(PrefetchLoader(items, prepare=prep, prefetch=0)) == \
        list(PrefetchLoader(items, prepare=prep, prefetch=3)) == [(i, i) for i in range(6)]


def test_prefetch_loader_bounded_queue():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    pl = PrefetchLoader(gen(), prefetch=2)
    assert next(pl) == 0
    time.sleep(0.3)
    # 1 consumed + 2 queued + at most 1 in prepare
    assert len(produced) <= 4 and pl.depth <= 2
    pl.close()


def test_prefetch_loader_propagates_loader_exception():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("corrupt shard")

    pl = PrefetchLoader(gen(), prefetch=2)
    assert next(pl) == 1 and next(pl) == 2
    with pytest.raises(RuntimeError, match="corrupt shard"):
        next(pl)
    with pytest.raises(StopIteration):
        next(pl)


def test_prefetch_loader_propagates_prepare_exception():
    def prepare(batch, step):
        if step == 1:
            raise ValueError("bad stage")
        return batch

    pl = PrefetchLoader([1, 2, 3], prepare=prepare, prefetch=1)
    assert next(pl) == 1
    with pytest.raises(ValueError, match="bad stage"):
        next(pl)


def test_prefetch_loader_close_joins_producer():
    def slow_gen():
        for i in range(1000):
            time.sleep(0.005)
            yield i

    pl = PrefetchLoader(slow_gen(), prefetch=2)
    next(pl)
    producer = pl._thread
    assert producer is not None and producer.is_alive()
    pl.close()
    assert not producer.is_alive()
    with pytest.raises(StopIteration):
        next(pl)
    pl.close()   # idempotent


def test_prefetch_loader_finite_loader_stops():
    pl = PrefetchLoader([1, 2], prefetch=2)
    assert list(pl) == [1, 2]
    with pytest.raises(StopIteration):
        next(pl)


def test_prefetch_loaders_keep_order_under_thread_switching():
    """More producer and consumer threads than cores, switching every
    microsecond: every loader still hands out its own items in order, each
    staged for its own step, and nothing is lost or repeated."""
    n_loaders, n_items = 2 * (os.cpu_count() or 4), 200
    results = {}

    def consume(i):
        pl = PrefetchLoader(range(n_items), prepare=lambda b, s: (b, s), prefetch=1 + i % 3,
                            start_step=i)
        results[i] = list(pl)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(i,)) for i in range(n_loaders)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for i in range(n_loaders):
        assert results[i] == [(b, b + i) for b in range(n_items)], i


def test_train_stats_count_steps_and_waits():
    st = TrainPipelineStats()
    for i in range(5):
        st.record_step(0.002, prefetched=i % 2 == 0)
    assert (st.steps, st.prefetched_steps) == (5, 3)
    assert st.enqueue_wait_ms == pytest.approx(10.0)
    st.reset()
    assert (st.steps, st.enqueue_wait_ms, st.prefetched_steps) == (0, 0.0, 0)


# ---------------------- engine: the data pipeline -------------------------- #

def _tiny_engine(data=None, prefetch=2, extra=None):
    model = GPT2LMHead(GPT2Config.tiny(vocab_size=64), device="cpu", seed=0)
    cfg = {"train_batch_size": 8, "steps_per_print": 0,
           "train_pipeline": {"prefetch": prefetch},
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    cfg.update(extra or {})
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(model=model, training_data=data,
                                                          config=cfg, device="cpu")
    assert (loader is None) == (data is None) and loader is engine.training_dataloader
    return engine


def _lm_data(n=32, seqlen=8, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, size=(seqlen,)).astype(np.int32)}
            for _ in range(n)]


PLD = {"progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.1}}


@pytest.mark.parametrize("extra", [None, PLD], ids=["plain", "pld"])
def test_train_steps_prefetch_matches_sync_loop(extra):
    """Prefetch staging must not change the loss stream by a bit, with
    progressive layer drop's per-step draws too."""
    data = _lm_data()
    e_sync = _tiny_engine(data, prefetch=0, extra=extra)
    e_pipe = _tiny_engine(data, prefetch=2, extra=extra)
    losses_sync, losses_pipe = e_sync.train_steps(6), e_pipe.train_steps(6)
    assert losses_sync.tobytes() == losses_pipe.tobytes()
    assert e_pipe.global_steps == 6 and e_pipe._prefetch_loader is not None
    assert e_pipe.train_stats.prefetched_steps == 6
    assert e_sync.train_stats.prefetched_steps == 0
    for n, t in e_sync.state["master"].items():
        assert torch.equal(t, e_pipe.state["master"][n]), n
    e_pipe.destroy()
    assert e_pipe._prefetch_loader is None
    e_sync.destroy()


def test_pld_draws_differ_by_step_and_theta_one_is_off():
    data = _lm_data()
    ref = _tiny_engine(data, prefetch=0).train_steps(4)
    one = _tiny_engine(data, prefetch=2, extra={
        "progressive_layer_drop": {"enabled": True, "theta": 1.0}}).train_steps(4)
    half = _tiny_engine(data, prefetch=2, extra={
        "progressive_layer_drop": {"enabled": True, "theta": 0.1, "gamma": 1.0}})
    assert one.tobytes() == ref.tobytes()
    assert half.train_steps(4).tobytes() != ref.tobytes()
    assert half.progressive_layer_drop.get_theta() == pytest.approx(
        half.progressive_layer_drop.theta_at(4))


def test_deferred_drain_one_step_late_and_flush():
    engine = _tiny_engine(_lm_data(), prefetch=0)
    engine.train_batch()
    assert len(engine._pending_metrics) == 1
    engine.train_batch()
    assert len(engine._pending_metrics) == 1
    engine.drain_metrics()
    assert len(engine._pending_metrics) == 0
    engine.destroy()


def test_checkpoint_load_resets_prefetch_iterator(tmp_path):
    data = _lm_data()
    engine = _tiny_engine(data, prefetch=2)
    engine.train_steps(2)
    assert engine._prefetch_loader is not None
    engine.save_checkpoint(str(tmp_path))
    engine.load_checkpoint(str(tmp_path))
    assert engine._prefetch_loader is None and engine._data_iterator is None
    engine.train_steps(2)
    assert engine.global_steps == 4 and engine._prefetch_loader is not None
    engine.destroy()


def test_curriculum_bucket_cache_tracks_schedule():
    extra = {"curriculum_learning": {
        "enabled": True, "min_difficulty": 8, "max_difficulty": 16,
        "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 8}}}
    engine = _tiny_engine(_lm_data(seqlen=16), prefetch=0, extra=extra)
    widths = []
    orig = engine._stage

    def spy(host):
        widths.append(host["input_ids"].shape[1])
        return orig(host)

    engine._stage = spy
    for _ in range(6):
        engine.train_batch()
    assert widths[0] == 8 and widths[-1] == 16
    assert engine.curriculum_scheduler.current_difficulty == 16
    assert engine._curr_seqlen_state == (16, 16, False)
    engine.destroy()


def test_curriculum_cache_keys_on_widest_leaf():
    extra = {"curriculum_learning": {
        "enabled": True, "min_difficulty": 8, "max_difficulty": 8,
        "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 1, "difficulty_step": 8}}}
    engine = _tiny_engine(prefetch=0, extra=extra)
    narrow = {"aux": np.zeros((8,), np.float32), "input_ids": np.zeros((8, 8), np.int32)}
    wide = {"aux": np.zeros((8,), np.float32), "input_ids": np.ones((8, 24), np.int32)}
    assert engine._prepare_batch(narrow, 0).tree["input_ids"].shape[-1] == 8
    assert engine._prepare_batch(wide, 1).tree["input_ids"].shape[-1] == 8
    engine.destroy()


def test_mixed_explicit_and_pipelined_steps_stay_schedule_exact():
    """An explicit train_batch() between pipelined steps moves the step
    counter outside the producer's keying: the engine restages, so the loss
    stream matches a synchronous engine fed the same sequence."""
    data = _lm_data()
    explicit = {"input_ids": np.random.default_rng(9).integers(0, 64, (8, 8)).astype(np.int32)}

    def run(prefetch):
        e = _tiny_engine(data, prefetch=prefetch, extra=PLD)
        losses = [float(e.train_batch()) for _ in range(2)]
        losses.append(float(e.train_batch(explicit)))
        losses += [float(e.train_batch()) for _ in range(3)]
        e.destroy()
        return losses

    assert run(0) == run(2)


def test_engine_curriculum_seqlen():
    cfg = {"curriculum_learning": {"enabled": True, "min_difficulty": 8, "max_difficulty": 16,
                                   "schedule_type": "fixed_linear",
                                   "schedule_config": {"total_curriculum_step": 4,
                                                       "difficulty_step": 8}}}
    engine = _tiny_engine(prefetch=0, extra=cfg)
    batch = {"input_ids": np.zeros((8, 16), np.int32)}
    engine.train_batch(batch)
    assert engine.curriculum_scheduler.current_difficulty == 8
    for _ in range(4):
        engine.train_batch(batch)
    assert engine.curriculum_scheduler.current_difficulty == 16
    engine.destroy()


def test_engine_trains_from_an_indexed_dataset(tmp_path):
    """training_data over an mmap dataset the JAX builder wrote, through
    the engine's own loader at prefetch 2."""
    prefix = str(tmp_path / "tokens")
    b = jax_make_builder(prefix, dtype=np.int32)
    rng = np.random.default_rng(4)
    for _ in range(24):
        b.add_item(rng.integers(0, 64, 16))
        b.end_document()
    b.finalize()
    ds = make_dataset(prefix)

    class Tokens:
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            return {"input_ids": ds[i]}

    engine = _tiny_engine(Tokens(), prefetch=2)
    losses = engine.train_steps(4)
    assert np.isfinite(losses).all() and engine.global_samples == 32
    engine.destroy()
