"""Sliding-window serving (Mistral) in the port against the JAX package.

Each windowed kernel's plain PyTorch version (what the port runs on the
CPU) is held against the JAX package's Pallas kernel in interpret mode on
the same numpy inputs, at GQA 4/2 with windows that start mid-page and
mid-tile and the window of 1: K2 (packed prefill), K5 (chunk), K3/K4/K6
(decode, step, side buffer with its moving start) and K7 with its merge,
plus the split-K dispatchers. Block tables repeat physical pages the way
the scheduler's page ring does. The page ring itself is held against the
JAX scheduler (both host-only), and the port's engine against the JAX v2
engine on a tiny Mistral whose ring wraps, at split rungs 1, 2 and 4.

Tolerances, as ``test_torch_kernels.py`` and ``test_torch_quant_serving.py``
use for the same kernels without a window: kernels 2e-5 absolute in f32
(flash blocks against one softmax: a few f32 ulps), the split-K paths 1e-5
relative plus 1e-5 absolute; engine logits 1e-4 absolute in f32 and greedy
streams exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JaxSMConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import \
    BlockedAllocator as JaxAllocator
from deepspeed_tpu.inference.v2.ragged.kv_cache import BlockedKVCache as JaxKVCache
from deepspeed_tpu.inference.v2.ragged.kv_cache import KVCacheConfig as JaxKVConfig
from deepspeed_tpu.inference.v2.scheduler import DynamicSplitFuseScheduler as JaxScheduler
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.ops.pallas import paged_splitk as jsk
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_packed as jax_packed
from deepspeed_tpu.ops.pallas.paged_attention import (
    paged_chunk_attention_batched as jax_chunk,
    paged_decode_attention as jax_decode,
    paged_decode_attention_sidebuf as jax_sidebuf,
    paged_decode_attention_step as jax_step)
from deepspeed_tpu_torch.checkpoint import params_from_flat, params_to_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache, KVCacheConfig
from deepspeed_tpu_torch.inference.v2.ragged_model import RaggedModelSpec
from deepspeed_tpu_torch.inference.v2.scheduler import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels import paged_splitk as psk
from deepspeed_tpu_torch.ops.kernels.flash_packed import flash_attention_packed_plain
from deepspeed_tpu_torch.ops.kernels.kv_quant import scale_tile_rows
from deepspeed_tpu_torch.ops.kernels.paged_chunk import paged_chunk_attention_batched_plain
from deepspeed_tpu_torch.ops.kernels.paged_decode import paged_decode_attention_plain

from tests._torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS_ATOL = 1e-4
H, HKV, D, BS, NB, MB = 4, 2, 128, 16, 14, 6
WINDOWS = [1, 21]            # one token; a start 5 tokens into a page


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               **(tol or dict(rtol=0, atol=ATOL)))


def _ring_tables(rng, ctxs, ring=4):
    """Block tables as the page ring makes them: each row owns ``ring``
    physical pages and logical page i >= ring repeats page i - ring."""
    perm = rng.permutation(NB)
    bt = np.zeros((len(ctxs), MB), np.int32)
    for i, c in enumerate(ctxs):
        own = perm[i * ring:(i + 1) * ring] if (i + 1) * ring <= NB else perm[:ring]
        for p in range(-(-c // BS)):
            bt[i, p] = own[p % ring]
    return bt


def _jit(fn, *static, **kw):
    """The JAX function jitted with its static arguments bound (one compile
    instead of op-by-op dispatch of its scans)."""
    return jax.jit(lambda *a: fn(*a, *static, **kw))


def _spec(window):
    return RaggedModelSpec(family="llama", num_layers=1, hidden_size=H * D,
                           num_heads=H, num_kv_heads=HKV, head_dim=D, vocab_size=16,
                           window=window)


# --------------------------------------------------------------------- #
# the windowed kernels' plain versions against the Pallas kernels
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("window", [1, 37])
def test_packed_prefill_window_matches_k2(window):
    """Three segments and padding rows; 64-row Pallas tiles, so a window
    of 37 starts mid-tile and later q-tiles skip whole key tiles."""
    rng = np.random.RandomState(window)
    R = 200
    q, k, v = _f(rng, R, H, D), _f(rng, R, HKV, D), _f(rng, R, HKV, D)
    seg = np.full((R,), -1, np.int32)
    seg[:130], seg[130:180], seg[180:192] = 0, 1, 2
    ref = _jit(jax_packed, block_q=64, block_k=64, window=window)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg))
    port = flash_attention_packed_plain(_t(q), _t(k), _t(v), _t(seg), window=window)
    _close(port[:192], np.asarray(ref)[:192])


@pytest.mark.parametrize("window", WINDOWS)
def test_paged_chunk_window_matches_k5(window):
    """Continuation chunks whose window start falls mid-page, through
    ring tables (slot 0's last page repeats its first), a chunk from 0 and
    an empty slot."""
    rng = np.random.RandomState(window + 1)
    NC, Cs = 4, 8
    ctxs = [90, 8, 41, 0]
    q0 = np.array([82, 0, 33, 0], np.int32)
    pool, bt = _f(rng, NB, 2, HKV, BS, D), _ring_tables(rng, ctxs, ring=5)
    q = _f(rng, NC, Cs, H, D)
    ctx = np.array(ctxs, np.int32)
    ref = _jit(jax_chunk, window=window)(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
                                         jnp.asarray(q0), jnp.asarray(ctx))
    port = paged_chunk_attention_batched_plain(_t(q), _t(pool), _t(bt), _t(q0), _t(ctx),
                                               window=window)
    _close(port, ref)
    assert float(port[3].abs().max()) == 0.0


@pytest.mark.parametrize("window", WINDOWS)
def test_paged_decode_window_matches_k3(window):
    """ctx 0 gives zeros; ctx past the ring reads aliased pages; a window
    start mid-page and exactly on a page edge (ctx 37 - 21 = 16)."""
    rng = np.random.RandomState(window + 2)
    ctxs = [90, 0, 37, 5]
    pool, bt = _f(rng, NB, 2, HKV, BS, D), _ring_tables(rng, ctxs)
    q = _f(rng, len(ctxs), H, D)
    ctx = np.array(ctxs, np.int32)
    ref = _jit(jax_decode, window=window)(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
                                          jnp.asarray(ctx))
    port = paged_decode_attention_plain(_t(q), _t(pool), _t(bt), _t(ctx), window=window)
    _close(port, ref)
    assert float(port[1].abs().max()) == 0.0


@pytest.mark.parametrize("window", WINDOWS)
def test_decode_step_window_matches_k4(window):
    """Both decode-step schedules of the port (side row then write; write
    then attend) against the fused Pallas step: output and pool bytes."""
    rng = np.random.RandomState(window + 3)
    ctxs = [81, 1, 16]
    pool, bt = _f(rng, NB, 2, HKV, BS, D), _ring_tables(rng, ctxs)
    q, kn, vn = _f(rng, 3, H, D), _f(rng, 3, HKV, D), _f(rng, 3, HKV, D)
    ctx = np.array(ctxs, np.int32)
    ref_out, ref_pool = _jit(jax_step, window=window)(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pool),
        jnp.asarray(bt), jnp.asarray(ctx))
    ak = AttentionKernelSpec(_spec(window))
    for step in (ak.decode_step, ak.decode_step_write):
        pool_t = _t(pool.copy())
        _close(step(_t(q), _t(kn), _t(vn), pool_t, _t(bt), _t(ctx)), ref_out)
        np.testing.assert_array_equal(pool_t.numpy(), np.asarray(ref_pool))


@pytest.mark.parametrize("window, j", [(1, 2), (21, 2)])
def test_sidebuf_window_matches_k6(window, j):
    """The page piece's start moves with the in-chunk step (prefix + j + 1
    - window) while the side rows need cc >= j + 1 - window; the slab's
    rows past j hold garbage that must not be attended."""
    rng = np.random.RandomState(window * 10 + j)
    C = 4
    prefix = [20, 0, 70]
    pool, bt = _f(rng, NB, 2, HKV, BS, D), _ring_tables(rng, [p + C for p in prefix])
    q = _f(rng, 3, H, D)
    sk, sv = _f(rng, 3, C, HKV, D), _f(rng, 3, C, HKV, D)
    pl = np.array(prefix, np.int32)
    ref = _jit(jax_sidebuf, j, window=window)(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(pl),
        jnp.asarray(sk), jnp.asarray(sv))
    port = paged_decode_attention_plain(_t(q), _t(pool), _t(bt), _t(pl),
                                        _t(sk.reshape(3, C * HKV, D)),
                                        _t(sv.reshape(3, C * HKV, D)), j, window=window)
    _close(port, ref)


@pytest.mark.parametrize("window, ns", [(1, 2), (21, 4)])
def test_splitk_window_matches_k7(window, ns):
    """Partials and merge against the Pallas split-K kernel: at ctx 90 the
    splits below the window start are empty (at 4 splits of 2 pages, splits
    0 and 1 for window 21) and the merge drops them."""
    rng = np.random.RandomState(window + ns)
    ctxs = [90, 0, 37, 5]
    pool, bt = _f(rng, NB, 2, HKV, BS, D), _ring_tables(rng, ctxs)
    q = _f(rng, len(ctxs), H, D)
    cl = np.array(ctxs, np.int32)
    ref, ref_lse = _jit(jsk.paged_decode_attention_splitk_pallas, ns, window=window,
                        with_lse=True)(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
                                       jnp.asarray(cl))
    out, lse = psk.splitk_attention(_t(q), _t(pool), _t(bt), _t(cl), ns, with_lse=True,
                                    window=window)
    _close(out, ref, **F32)
    live = cl > 0
    _close(lse.numpy()[live], np.asarray(ref_lse)[live], **F32)
    assert float(out[1].abs().max()) == 0.0
    disp = psk.paged_decode_attention_splitk(_t(q), _t(pool), _t(bt), _t(cl), n_splits=ns,
                                             window=window)
    assert torch.equal(disp, out)


@pytest.mark.parametrize("window", [21])
def test_splitk_window_dispatchers_match_jax(window):
    """The side-buffer, scatter-first step and chunk split paths with a
    window, against the JAX dispatchers."""
    rng = np.random.RandomState(window + 7)
    pool, q = _f(rng, NB, 2, HKV, BS, D), _f(rng, 4, H, D)
    C, j = 4, 2
    pfx = np.array([0, 1, 40, 80], np.int32)
    bt = _ring_tables(rng, [p + C for p in pfx])
    sk, sv = _f(rng, 4, C, HKV, D), _f(rng, 4, C, HKV, D)
    ref = _jit(jsk.paged_sidebuf_attention_splitk, j, window=window, n_splits=4)(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(pfx),
        jnp.asarray(sk), jnp.asarray(sv))
    got = psk.paged_sidebuf_attention_splitk(_t(q), _t(pool), _t(bt), _t(pfx),
                                             _t(sk.reshape(4, C * HKV, D)),
                                             _t(sv.reshape(4, C * HKV, D)), j,
                                             n_splits=4, window=window)
    _close(got, ref, **F32)
    kn, vn = _f(rng, 4, HKV, D), _f(rng, 4, HKV, D)
    cl = pfx + 1
    o1, kv1 = _jit(jsk.paged_decode_attention_splitk_step, window=window, n_splits=2)(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pool),
        jnp.asarray(bt), jnp.asarray(cl))
    pool_t = _t(pool.copy())
    o2 = psk.paged_decode_attention_splitk_step(_t(q), _t(kn), _t(vn), pool_t, _t(bt),
                                                _t(cl), n_splits=2, window=window)
    _close(o2, o1, **F32)
    np.testing.assert_array_equal(pool_t.numpy(), np.asarray(kv1))
    Cs = 8
    qc = _f(rng, 4, Cs, H, D)
    ctx = np.array([0, 5, 41, 84], np.int32)
    q0 = np.maximum(ctx - Cs, 0).astype(np.int32)
    ref = _jit(jsk.paged_chunk_attention_splitk, window=window, n_splits=2)(
        jnp.asarray(qc), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(q0),
        jnp.asarray(ctx))
    got = psk.paged_chunk_attention_splitk(_t(qc), _t(pool), _t(bt), _t(q0), _t(ctx),
                                           n_splits=2, window=window)
    _close(got, ref, **F32)


def test_windowed_wrappers_count_nothing_on_cpu_and_refuse_int8():
    """On the CPU the windowed wrappers run their plain versions and count
    no launch, over an int8 pool too (its window branch is ported:
    tests/test_torch_int8_window_alibi.py); a window below 1 is refused."""
    rng = np.random.RandomState(13)
    kernels.reset_launches()
    pool, bt = _f(rng, NB, 2, HKV, BS, D), _ring_tables(rng, [90, 5])
    q, cl = _t(_f(rng, 2, H, D)), _t(np.array([90, 5], np.int32))
    assert torch.equal(kernels.paged_decode_attention(q, _t(pool), _t(bt), cl, window=21),
                       paged_decode_attention_plain(q, _t(pool), _t(bt), cl, window=21))
    assert torch.equal(kernels.splitk_attention(q, _t(pool), _t(bt), cl, 2, window=21),
                       psk.splitk_attention_plain(q, _t(pool), _t(bt), cl, 2, window=21))
    # an int8 pool needs Hkv * bs % 128 == 0: pages of 64 here
    g = torch.Generator().manual_seed(13)
    pool8 = torch.randint(-127, 128, (4, 2, HKV, 64, D), generator=g, dtype=torch.int8)
    tiles = torch.rand(4, scale_tile_rows(HKV, 64), 128, generator=g)
    bt8 = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    assert torch.equal(kernels.paged_decode_attention(q, pool8, bt8, cl, kv_scales=tiles,
                                                      window=21),
                       paged_decode_attention_plain(q, pool8, bt8, cl, kv_scales=tiles,
                                                    window=21))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="window must be >= 1"):
        _loader.window_arg(0)


# --------------------------------------------------------------------- #
# the page ring against the JAX scheduler
# --------------------------------------------------------------------- #

def _schedulers(window, nb=40):
    kw = dict(max_tracked_sequences=4, max_ragged_sequence_count=2,
              max_ragged_batch_size=34, max_context=160, prefill_chunk_size=8)
    jsc = JaxScheduler(JaxSMConfig(**kw),
                       JaxKVCache(JaxKVConfig(num_layers=1, num_kv_heads=1, head_dim=8,
                                              block_size=8, num_blocks=nb + 1)),
                       JaxAllocator(nb))
    psc = DynamicSplitFuseScheduler(
        DSStateManagerConfig(**kw),
        BlockedKVCache(KVCacheConfig(num_layers=1, num_kv_heads=1, head_dim=8,
                                     block_size=8, num_blocks=nb + 1), "cpu"),
        BlockedAllocator(nb))
    jsc.window = psc.window = window
    return jsc, psc


PLAN_KEYS = ("chunk_tokens", "chunk_positions", "chunk_ntok", "chunk_block_tables",
             "chunk_q0", "chunk_ctx_lens", "decode_tokens", "decode_positions",
             "decode_block_tables", "decode_ctx_lens", "kv_dest", "row_seg", "page_ids",
             "page_rows", "page_fill")


@pytest.mark.parametrize("window", [20, 5])
def test_page_ring_matches_jax_scheduler(window):
    """Admissions, passes (chunk takes capped by the ring, page plans that
    skip dead pages, decode rows), a decode reservation and flushes: equal
    block lists, ring sizes, take caps, pass arrays and free counts."""
    jsc, psc = _schedulers(window)
    assert psc.ring_pages == jsc.ring_pages and psc._pass_take_cap == jsc._pass_take_cap
    assert psc.ring_covers(2) == jsc.ring_covers(2)
    assert psc.ring_covers(psc._pass_take_cap + 1) is False
    rng = np.random.RandomState(window)
    prompts = {0: 70, 1: 23, 2: 3}

    def same_state():
        assert {u: s.blocks for u, s in psc.seqs.items()} == \
            {u: list(map(int, s.blocks)) for u, s in jsc.seqs.items()}
        assert psc.allocator.free_blocks == jsc.allocator.free_blocks
        for uid, n in [(0, 50), (1, 200), (7, 90)]:
            assert psc.query(uid, n) == jsc.query(uid, n)
        assert psc.can_schedule([0, 5], [40, 60]) == jsc.can_schedule([0, 5], [40, 60])

    for uid, n in prompts.items():
        toks = rng.randint(0, 100, n).astype(np.int32)
        jsc.add_tokens(uid, toks)
        psc.add_tokens(uid, toks)
    for step in range(14):
        if step in (6, 9):           # decode tokens for the finished prompts
            for uid, s in list(psc.seqs.items()):
                if not len(s.pending):
                    jsc.add_tokens(uid, np.array([step], np.int32))
                    psc.add_tokens(uid, np.array([step], np.int32))
        jb, pb = jsc.schedule_pass(), psc.schedule_pass()
        if jb is None:
            assert pb is None
            continue
        for key in PLAN_KEYS:
            np.testing.assert_array_equal(getattr(pb, key), getattr(jb, key), err_msg=key)
        assert pb.chunk_uids == jb.chunk_uids and pb.decode_uids == jb.decode_uids
        assert pb.pure_prefill == jb.pure_prefill
        assert psc.complete_pass(pb) == jsc.complete_pass(jb)
        same_state()
    # the longest sequence wrapped its ring: repeated ids, ring_pages physical
    long = psc.seqs[0].blocks
    assert len(long) > psc.ring_pages == len(set(long))
    jsc.reserve(1, 30)
    psc.reserve(1, 30)
    same_state()
    for uid in (0, 1, 2):
        jsc.flush(uid)
        psc.flush(uid)
        same_state()
    assert psc.allocator.free_blocks == 40


# --------------------------------------------------------------------- #
# the engine on a tiny Mistral, against the JAX engine
# --------------------------------------------------------------------- #

MISTRAL = dict(vocab_size=128, max_position_embeddings=128, sliding_window=24)
STATE = {"max_tracked_sequences": 8, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 36, "max_context": 128, "prefill_chunk_size": 16}
ENGINE = {"state_manager": STATE, "kv_cache": {"block_size": 8},
          "attention": {"decode_splits": 4, "min_ctx_per_split": 16}}


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, MISTRAL["vocab_size"], n).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def engines():
    cfg = JaxLlamaConfig.tiny(**MISTRAL)
    model = JaxLlama(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    jax_engine = JaxEngine(model=model, model_parameters=params,
                           config={**ENGINE, "dtype": jnp.float32})
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    port_model = LlamaForCausalLM(LlamaConfig.tiny(**MISTRAL), device="cpu", seed=1)
    # Mistral's tree is Llama's: the carrier moves it unchanged
    carried = params_from_flat(flat, device="cpu")
    assert {k: v.tobytes() for k, v in params_to_flat(carried).items()} == \
        {k: v.tobytes() for k, v in flat.items()}
    port_model.load_flat(carried)
    port_engine = InferenceEngineV2(port_model, {**ENGINE, "dtype": torch.float32},
                                    port_model.flat_params(), device="cpu")
    return model, params, port_model, jax_engine, port_engine


def test_dense_forward_with_window_matches_flax(engines):
    model, params, port_model, _, _ = engines
    ids = _prompts(2, [2 * 40])[0].reshape(2, 40)
    ref = _jit(lambda p, x: model.apply({"params": p}, x, method="forward_logits"))(
        params, jnp.asarray(ids))
    got = port_model.forward_logits(torch.from_numpy(ids).long())
    _close(got, ref, rtol=0, atol=LOGITS_ATOL)
    # the window changes the function: full causal attention differs
    full = LlamaForCausalLM(LlamaConfig.tiny(**{**MISTRAL, "sliding_window": None}),
                            device="cpu", seed=1)
    full.load_flat(port_model.flat_params())
    assert float((full.forward_logits(torch.from_numpy(ids).long()) - got).abs().max()) > 1e-3


def test_engine_window_logits_and_ring_match_jax(engines):
    """Prompts past the window (70 tokens wrap the ring of 8 pages), a
    mixed pass of decode rows and a new prompt, at each pinned rung."""
    _, _, _, jax_engine, port_engine = engines
    assert port_engine.spec.window == jax_engine.spec.window == 24
    assert port_engine.scheduler.ring_pages == jax_engine.scheduler.ring_pages == 8
    base = port_engine.free_blocks
    try:
        for rung, seed in [(1, 4), (2, 5), (4, 6)]:
            jax_engine.attn_rung_override = port_engine.attn_rung_override = rung
            prompts = _prompts(seed, [70, 7, 30])
            ref = jax_engine.put([0, 1, 2], prompts)
            got = port_engine.put([0, 1, 2], prompts)
            _close(got, ref, rtol=0, atol=LOGITS_ATOL)
            step = [np.array([int(np.argmax(r))], np.int32) for r in ref[:2]]
            new = _prompts(seed + 10, [27])
            ref2 = jax_engine.put([0, 1, 3], step + new)
            got2 = port_engine.put([0, 1, 3], step + new)
            _close(got2, ref2, rtol=0, atol=LOGITS_ATOL)
            blocks = port_engine.scheduler.seqs[0].blocks
            assert blocks == list(map(int, jax_engine.scheduler.seqs[0].blocks))
            assert len(blocks) > 8 and len(set(blocks)) == 8
            assert port_engine.free_blocks == jax_engine.free_blocks
            for e in (jax_engine, port_engine):
                e.flush([0, 1, 2, 3])
            assert port_engine.free_blocks == base
    finally:
        jax_engine.attn_rung_override = port_engine.attn_rung_override = None


def test_engine_window_greedy_streams_equal_jax_at_each_rung(engines):
    _, _, _, jax_engine, port_engine = engines
    base = port_engine.free_blocks
    prompts = _prompts(7, [66, 5, 31])
    streams = {}
    try:
        for rung in (1, 2, 4):
            jax_engine.attn_rung_override = port_engine.attn_rung_override = rung
            port_engine.attn_stats.reset()
            ref = jax_engine.generate(prompts, max_new_tokens=8)
            got = port_engine.generate(prompts, max_new_tokens=8)
            assert [list(map(int, o)) for o in got] == [list(map(int, o)) for o in ref]
            assert set(port_engine.attn_stats.rungs) == {rung}
            streams[rung] = got
            assert port_engine.free_blocks == base and not port_engine.scheduler.seqs
    finally:
        jax_engine.attn_rung_override = port_engine.attn_rung_override = None


def test_decode_step_schedules_agree_under_window(engines):
    """The decode step's two schedules under a window (side row then write,
    taken when the ring covers it; write then attend otherwise) give the
    same next tokens, and logits and stored pages within f32 association
    noise (the current token's column sits elsewhere in each softmax sum),
    at rungs 1 and 2, on a live state whose ring has wrapped."""
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
    from deepspeed_tpu_torch.inference.v2.ragged_model import build_decode_step
    _, _, _, _, port_engine = engines
    port_engine.put([0, 1], _prompts(8, [60, 9]))
    try:
        db = port_engine.scheduler.decode_batch([0, 1], 2, port_engine.scratch_block)
        ids = port_engine._sample_device_padded([0, 1], False, 1.0, 0)
        bt, pos = to_device(db.block_tables, "cpu"), to_device(db.positions, "cpu")
        for rung in (1, 2):
            outs = []
            for ring_ok in (True, False):
                kv = port_engine.kv.kv.clone()
                step = build_decode_step(port_engine.spec, n_splits=rung,
                                         window_ring_ok=ring_ok)
                nxt, logits = step(port_engine.weights, kv, ids, pos, bt, pos + 1)
                outs.append((nxt, logits, kv))
            assert torch.equal(outs[0][0], outs[1][0])
            _close(outs[0][1], outs[1][1], rtol=0, atol=1e-5)
            _close(outs[0][2], outs[1][2], rtol=0, atol=1e-5)
    finally:
        port_engine.flush([0, 1])


def test_window_refusals_and_max_context_rule(engines):
    """kv_quant with a window and ALiBi over int8 pages validate (both
    branches are ported: tests/test_torch_int8_window_alibi.py), a window
    with tensor_parallel > 1 is refused by name, and a max_context at or
    below the window drops the window (as in JAX)."""
    jmodel, jparams, model, _, _ = engines
    econf = {**ENGINE, "dtype": torch.float32}
    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    int8 = RaggedInferenceEngineConfig.load({"kv_quant": {"enabled": True},
                                             "kv_cache": {"block_size": 64}})
    AttentionKernelSpec.validate_engine_build(_spec(24), int8)
    spec = _spec(None)
    spec.alibi = True
    AttentionKernelSpec.validate_engine_build(spec, RaggedInferenceEngineConfig.load())
    AttentionKernelSpec.validate_engine_build(spec, int8)
    tp = RaggedInferenceEngineConfig.load()
    tp.tensor_parallel = 2
    with pytest.raises(NotImplementedError, match="tensor_parallel > 1"):
        AttentionKernelSpec.validate_engine_build(_spec(24), tp)
    short = {**econf, "state_manager": {**STATE, "max_context": 24}}
    e = InferenceEngineV2(model, short, model.flat_params(), device="cpu")
    assert e.spec.window is None and e.scheduler.ring_pages is None
    from deepspeed_tpu.inference.v2.ragged_model import adapt_llama as jax_adapt
    assert jax_adapt(jparams, jmodel.config, max_context=24)[0].window is None
    assert jax_adapt(jparams, jmodel.config, max_context=25)[0].window == 24
