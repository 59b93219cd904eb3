"""int8 KV pages under a sliding window and under ALiBi, in the port against
the JAX package.

Each int8 kernel's plain PyTorch version (what the port runs on the CPU) is
held against the JAX package's Pallas kernel in interpret mode on the same
numpy inputs, with a window and with ALiBi, at D = 128 and Hkv * bs = 128
(the kv_quant gate): K3 (pages only), K4 (the decode step: output and the
pool's int8 bytes and scale tiles), K6 over a side slab of f32
``kv_write_dequant`` rows at several steps j, K5, and K7 at 2 splits with
the merged lse and with its side piece. Under the window, block tables
repeat physical pages as the scheduler's page ring does. Then a tiny
windowed Llama with int8 pages whose prompt wraps the ring, and a tiny
BLOOM at D = 128 with int8 pages, each against the JAX engine on the same
weights: logits of ``put``, greedy streams through ``generate``, a
``decode_steps`` burst and pinned rung 2.

Tolerances: kernels 1e-5 relative plus 1e-5 absolute in f32 (the two sum
the same f32 products in other orders); engine logits 5e-3 absolute over
int8 pages (``test_torch_multistep_decode.py`` allows 1e-3 without a
window: the two packages' K/V rows agree to f32 rounding, which may cross
an int8 rounding edge, and inside a 24-token window one crossing weighs
more); greedy streams exactly equal. The JAX functions are jitted (one compile instead of
op-by-op dispatch of their scans); test parameters come from
``jax.eval_shape`` plus numpy.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import decoder as jdec
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.ops.pallas import paged_attention as pa
from deepspeed_tpu.ops.pallas import paged_splitk as jsk
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.inference.v2.ragged_model import multistep_schedule
from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.kernels import paged_splitk as psk
from deepspeed_tpu_torch.ops.kernels.paged_chunk import paged_chunk_attention_batched_plain
from deepspeed_tpu_torch.ops.kernels.paged_decode import paged_decode_attention_plain

from tests._torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)
# int8 pages: the two engines' K/V rows agree to f32 rounding, which may
# cross an int8 rounding edge; inside a 24-token window one such crossing
# moved a logit by 1.7e-3 here (logits of order 1)
INT8_LOGITS_ATOL = 5e-3
S, H, HKV, D, BS, NB, MB = 4, 4, 2, 128, 64, 24, 6
WINDOW = 37                     # starts mid-page
MODES = {"window": {"window": WINDOW}, "alibi": {"alibi": True}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               **(tol or F32))


def _jit(fn, *static, **kw):
    """``fn`` jitted with its static arguments bound; the scale tiles go in
    as the traced keyword ``kv_scales``."""
    return jax.jit(lambda *a, kv_scales: fn(*a, *static, kv_scales=kv_scales, **kw))


def _tables(rng, ctxs, mode):
    """Block tables [len(ctxs), MB]; under the window each row owns 3
    physical pages and logical page i >= 3 repeats page i - 3 (the page
    ring), else every page is its own."""
    perm = rng.permutation(NB)
    bt = np.zeros((len(ctxs), MB), np.int32)
    ring = 3 if mode == "window" else MB
    for i, c in enumerate(ctxs):
        own = perm[i * ring:(i + 1) * ring]
        for p in range(-(-c // BS)):
            bt[i, p] = own[p % ring]
    return bt


def _pool(rng):
    """(jax int8 pages, jax scale tiles, torch pages, torch tiles) from one
    f32 draw."""
    kv = (rng.randn(NB, 2, HKV, BS, D) * rng.uniform(0.1, 3, (NB, 2, HKV, BS, 1))
          ).astype(np.float32)
    kvq, scl = pa.kv_quantize_rows(jnp.asarray(kv))
    tiles = pa.kv_scales_to_tiles(scl)
    return kvq, tiles, _t(kvq), _t(tiles)


def _dequant_rows(rng, *shape):
    x = pa.kv_write_dequant(jnp.asarray(rng.randn(*shape).astype(np.float32)))
    return x, _t(x)


# --------------------------------------------------------------------- #
# the int8 plain versions against the Pallas kernels, window and ALiBi
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", sorted(MODES))
def test_int8_decode_matches_k3(mode):
    """Pages only: an empty row, one token, a window start mid-page
    through the ring (ctx 300 wraps 3 pages twice), and ALiBi at ctx 300."""
    rng = np.random.RandomState(1)
    kvq, tiles, pq, pt = _pool(rng)
    ctx = np.array([0, 1, 65, 300], np.int32)
    bt = _tables(rng, ctx, mode)
    q = rng.randn(S, H, D).astype(np.float32)
    ref = _jit(pa.paged_decode_attention, **MODES[mode])(
        jnp.asarray(q), kvq, jnp.asarray(bt), jnp.asarray(ctx), kv_scales=tiles)
    got = paged_decode_attention_plain(_t(q), pq, _t(bt), _t(ctx), kv_scales=pt,
                                       **MODES[mode])
    _close(got, ref)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_int8_decode_step_matches_k4_and_writes_same_bytes(mode):
    """The port's step (the current token as an f32 side row, then its
    quantized write) against the Pallas step: output, page bytes and
    scale tiles (the write into a wrapped ring page replaces its row's
    scale)."""
    rng = np.random.RandomState(2)
    kvq, tiles, pq, pt = _pool(rng)
    ctx = np.array([1, 2, 130, 250], np.int32)
    bt = _tables(rng, ctx, mode)
    q = rng.randn(S, H, D).astype(np.float32)
    kn, kn_t = _dequant_rows(rng, S, HKV, D)
    vn, vn_t = _dequant_rows(rng, S, HKV, D)
    o1, kv1, sc1 = _jit(pa.paged_decode_attention_step, **MODES[mode])(
        jnp.asarray(q), kn, vn, kvq, jnp.asarray(bt), jnp.asarray(ctx), kv_scales=tiles)
    spec = SimpleNamespace(window=MODES[mode].get("window"), alibi=mode == "alibi")
    pq, pt = pq.clone(), pt.clone()
    out = AttentionKernelSpec(spec).decode_step(_t(q), kn_t, vn_t, pq, _t(bt), _t(ctx),
                                                kv_scales=pt)
    _close(out, o1)
    assert pq.numpy().tobytes() == np.asarray(kv1).tobytes()
    # one f32 ulp: the jitted JAX step divides amax by 127 through a
    # reciprocal, eager JAX and the port by an IEEE quotient
    np.testing.assert_allclose(pt.numpy(), np.asarray(sc1), rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("mode, j", [("window", 3), ("alibi", 1)])
def test_int8_sidebuf_matches_k6(mode, j):
    """A frozen int8 prefix plus a side slab of C = 4 f32 rows: the pages'
    window start moves with j, and side row cc sits at prefix + cc under
    ALiBi. Two rows: the Pallas side-slab kernel's interpret-mode time
    grows with them (6.6 s at two, 12 s at four)."""
    rng = np.random.RandomState(3 + j)
    kvq, tiles, pq, pt = _pool(rng)
    C, R = 4, 2
    pfx = np.array([1, 280], np.int32)
    bt = _tables(rng, pfx + C, mode)
    q = rng.randn(R, H, D).astype(np.float32)
    sk, sk_t = _dequant_rows(rng, R, C, HKV, D)
    sv, sv_t = _dequant_rows(rng, R, C, HKV, D)
    ref = _jit(pa.paged_decode_attention_sidebuf, j, **MODES[mode])(
        jnp.asarray(q), kvq, jnp.asarray(bt), jnp.asarray(pfx), sk, sv, kv_scales=tiles)
    got = paged_decode_attention_plain(_t(q), pq, _t(bt), _t(pfx),
                                       sk_t.reshape(R, C * HKV, D),
                                       sv_t.reshape(R, C * HKV, D), j, kv_scales=pt,
                                       **MODES[mode])
    _close(got, ref)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_int8_chunk_matches_k5(mode):
    """Continuation chunks whose window start falls mid-page (a wrapped
    ring), a chunk from 0 and an empty slot."""
    rng = np.random.RandomState(4)
    kvq, tiles, pq, pt = _pool(rng)
    Cs = 16
    ctx = np.array([0, 9, 80, 300], np.int32)
    q0 = np.maximum(ctx - Cs, 0).astype(np.int32)
    bt = _tables(rng, ctx, mode)
    qc = rng.randn(S, Cs, H, D).astype(np.float32)
    ref = _jit(pa.paged_chunk_attention_batched, **MODES[mode])(
        jnp.asarray(qc), kvq, jnp.asarray(bt), jnp.asarray(q0), jnp.asarray(ctx),
        kv_scales=tiles)
    got = paged_chunk_attention_batched_plain(_t(qc), pq, _t(bt), _t(q0), _t(ctx),
                                              kv_scales=pt, **MODES[mode])
    _close(got, ref)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_int8_splitk_matches_k7_with_side_piece(mode):
    """Two splits of 3 pages: under the window split 0 of the 300-token row
    lies wholly below its start and the merge drops it; the lse agrees;
    then the side-buffer dispatcher (2 splits + the side piece of C = 4
    f32 rows at j = 2)."""
    rng = np.random.RandomState(5)
    kvq, tiles, pq, pt = _pool(rng)
    ctx = np.array([0, 1, 65, 300], np.int32)
    bt = _tables(rng, ctx, mode)
    q = rng.randn(S, H, D).astype(np.float32)
    ref, ref_lse = _jit(jsk.paged_decode_attention_splitk_pallas, 2, with_lse=True,
                        **MODES[mode])(jnp.asarray(q), kvq, jnp.asarray(bt),
                                       jnp.asarray(ctx), kv_scales=tiles)
    out, lse = psk.splitk_attention(_t(q), pq, _t(bt), _t(ctx), 2, kv_scales=pt,
                                    with_lse=True, **MODES[mode])
    _close(out, ref)
    _close(lse.numpy()[ctx > 0], np.asarray(ref_lse)[ctx > 0])
    assert float(out[0].abs().max()) == 0.0
    C, j = 4, 2
    pfx = np.array([0, 1, 130, 280], np.int32)
    bt = _tables(rng, pfx + C, mode)
    sk, sk_t = _dequant_rows(rng, S, C, HKV, D)
    sv, sv_t = _dequant_rows(rng, S, C, HKV, D)
    ref = _jit(jsk.paged_sidebuf_attention_splitk, j, n_splits=2, **MODES[mode])(
        jnp.asarray(q), kvq, jnp.asarray(bt), jnp.asarray(pfx), sk, sv, kv_scales=tiles)
    got = psk.paged_sidebuf_attention_splitk(_t(q), pq, _t(bt), _t(pfx),
                                             sk_t.reshape(S, C * HKV, D),
                                             sv_t.reshape(S, C * HKV, D), j, kv_scales=pt,
                                             n_splits=2, **MODES[mode])
    _close(got, ref)


def test_int8_window_and_alibi_wrappers_count_nothing_on_cpu():
    """On the CPU the int8 wrappers run their plain versions under a window
    and under ALiBi and count no launch; the CUDA launch names carry both
    suffixes."""
    rng = np.random.RandomState(6)
    _, _, pq, pt = _pool(rng)
    ctx = np.array([0, 1, 65, 300], np.int32)
    kernels.reset_launches()
    for mode, kw in MODES.items():
        bt, cl = _t(_tables(rng, ctx, mode)), _t(ctx)
        q = _t(rng.randn(S, H, D).astype(np.float32))
        assert torch.equal(kernels.paged_decode_attention(q, pq, bt, cl, kv_scales=pt, **kw),
                           paged_decode_attention_plain(q, pq, bt, cl, kv_scales=pt, **kw))
        assert torch.equal(kernels.splitk_attention(q, pq, bt, cl, 2, kv_scales=pt, **kw),
                           psk.splitk_attention_plain(q, pq, bt, cl, 2, kv_scales=pt, **kw))
        qc, q0 = _t(rng.randn(S, 8, H, D).astype(np.float32)), _t(np.maximum(ctx - 8, 0))
        assert torch.equal(
            kernels.paged_chunk_attention_batched(qc, pq, bt, q0, cl, kv_scales=pt, **kw),
            paged_chunk_attention_batched_plain(qc, pq, bt, q0, cl, kv_scales=pt, **kw))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    from deepspeed_tpu_torch.ops.kernels import paged_decode as pd
    assert pd.launch_name(True, WINDOW, False, 16) == "paged_decode_int8_side_window"
    assert psk.kernel_name(4, alibi=True, quant=True) == "paged_splitk_int8_alibi/4"


# --------------------------------------------------------------------- #
# tiny engines with int8 pages against the JAX engine
# --------------------------------------------------------------------- #

STATE = {"max_tracked_sequences": 4, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 36, "prefill_chunk_size": 16, "max_context": 256}
ENGINE = {"state_manager": STATE, "kv_cache": {"block_size": 64},
          "kv_quant": {"enabled": True},
          "attention": {"decode_splits": 2, "min_ctx_per_split": 64}}
LLAMA = dict(vocab_size=128, hidden_size=512, intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
             sliding_window=24)


def _random_flax(model, seed):
    """(params, flat numpy tree) with every leaf drawn from numpy: norm
    scales near 1, embeddings and kernels at unit-variance outputs."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        if k.endswith(("scale", "weight")):
            flat[k] = 1.0 + 0.1 * noise
        elif k.endswith("embedding"):
            flat[k] = noise / np.float32(np.sqrt(v.shape[1]))
        elif k.endswith("kernel") or v.ndim == 2:
            flat[k] = noise / np.float32(np.sqrt(v.shape[0]))
        else:
            flat[k] = 0.05 * noise
    tree = {}
    for k, a in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree, flat


def _engines(jax_model, port_model, seed, conf=ENGINE):
    params, flat = _random_flax(jax_model, seed)
    jax_engine = JaxEngine(model=jax_model, model_parameters=params,
                           config={**conf, "dtype": jnp.float32})
    port_model.load_flat(params_from_flat(flat, device="cpu"))
    port_engine = InferenceEngineV2(port_model, {**conf, "dtype": torch.float32},
                                    port_model.flat_params(), device="cpu")
    return jax_engine, port_engine


@pytest.fixture(scope="module")
def mistral():
    jax_model = JaxLlama(JaxLlamaConfig(dtype=jnp.float32, **LLAMA))
    return _engines(jax_model, LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu", seed=1),
                    3)


@pytest.fixture(scope="module")
def bloom():
    kw = dict(hidden_size=256, num_attention_heads=2)       # D = 128
    jax_model = jdec.DecoderLM(jdec.DecoderConfig.tiny("bloom", dtype=jnp.float32, **kw))
    # a 68-token pass budget: no page ring to wrap, fewer paged prefill passes
    conf = {**ENGINE, "state_manager": {**STATE, "max_ragged_batch_size": 68}}
    return _engines(jax_model, DecoderLM(DecoderConfig.tiny("bloom", **kw), device="cpu",
                                         seed=1), 4, conf)


def _prompts(seed, lengths, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


def _last_logits(engine, uids):
    engine._materialize(uids)
    return np.stack([engine._last_logits[u] for u in uids])


def _serve_against_jax(jax_engine, port, vocab, lengths):
    """put() logits (prefill, then a mixed pass of decode rows and a new
    prompt) at rung 1 and pinned rung 2; a decode_steps burst at rung 2
    (K7's side piece over the slab) and its final logits; greedy streams
    through generate(). Returns the port's block lists after the first
    put at rung 1."""
    base = port.free_blocks
    blocks = None
    try:
        for rung, seed in ((1, 10), (2, 11)):
            jax_engine.attn_rung_override = port.attn_rung_override = rung
            prompts = _prompts(seed, lengths, vocab)
            ref = jax_engine.put([0, 1, 2], prompts)
            got = port.put([0, 1, 2], prompts)
            _close(got, ref, rtol=0, atol=INT8_LOGITS_ATOL)
            if blocks is None:
                blocks = {u: list(s.blocks) for u, s in port.scheduler.seqs.items()}
                assert blocks == {u: list(map(int, s.blocks))
                                  for u, s in jax_engine.scheduler.seqs.items()}
            step = [np.array([int(np.argmax(r))], np.int32) for r in ref[:2]]
            new = _prompts(seed + 10, [20], vocab)
            _close(port.put([0, 1, 3], step + new), jax_engine.put([0, 1, 3], step + new),
                   rtol=0, atol=INT8_LOGITS_ATOL)
            if rung == 2:          # one burst: the JAX engine compiles each for seconds
                got = port.decode_steps([0, 1, 3], 8)
                ref = jax_engine.decode_steps([0, 1, 3], 8)
                assert got.tolist() == np.asarray(ref).tolist()
                _close(_last_logits(port, [0, 1, 3]), _last_logits(jax_engine, [0, 1, 3]),
                       rtol=0, atol=INT8_LOGITS_ATOL)
            assert set(port.attn_stats.rungs) >= {rung}
            for e in (jax_engine, port):
                e.flush([0, 1, 2, 3])
            assert port.free_blocks == base
        jax_engine.attn_rung_override = port.attn_rung_override = None
        prompts = _prompts(12, lengths, vocab)
        ref = jax_engine.generate(prompts, max_new_tokens=6)
        got = port.generate(prompts, max_new_tokens=6)
        assert [list(map(int, o)) for o in got] == [list(map(int, o)) for o in ref]
        assert port.free_blocks == base and not port.scheduler.seqs
    finally:
        jax_engine.attn_rung_override = port.attn_rung_override = None
    return blocks


def test_windowed_int8_engine_matches_jax_and_wraps_the_ring(mistral):
    """Window 24, pages of 64, take cap 32: the page ring holds 2 pages, so
    the 150-token prompt wraps it (its logical pages repeat physical ids,
    each overwritten in place with its scale rows); logits, the burst and
    greedy streams against the JAX engine."""
    jax_engine, port = mistral
    assert port.spec.window == jax_engine.spec.window == 24
    assert port.kv.kv.dtype == torch.int8 and port.kv.scales is not None
    ring = port.scheduler.ring_pages
    assert ring == jax_engine.scheduler.ring_pages == 2
    # the 8-step burst takes the side slab (f32 rows over an int8 pool),
    # whose bytes the max_side_bytes gate counts at the model dtype
    assert port.scheduler.ring_covers(9) and not port.scheduler.ring_covers(33)
    slab = 2 * port.spec.num_layers * 3 * 8 * port.spec.num_kv_heads * port.spec.head_dim * 4
    assert multistep_schedule(port.spec, 8, 3, True, max_side_bytes=slab) == "sidebuf"
    assert multistep_schedule(port.spec, 8, 3, True, max_side_bytes=slab - 1) == "general"
    assert multistep_schedule(port.spec, 8, 3, False) == "general"
    blocks = _serve_against_jax(jax_engine, port, LLAMA["vocab_size"], [150, 7, 40])
    assert len(blocks[0]) > ring == len(set(blocks[0]))


def test_alibi_int8_engine_matches_jax(bloom):
    """A tiny BLOOM at D = 128 (2 heads over pages of 64) with int8 pages:
    every prefill runs the paged pass with ALiBi; logits, the burst and
    greedy streams against the JAX engine."""
    jax_engine, port = bloom
    assert port.spec.alibi and port.spec.head_dim == 128 and port._pass_prefill is None
    assert port.kv.kv.dtype == torch.int8
    _serve_against_jax(jax_engine, port, port.spec.vocab_size, [80, 7, 30])
