"""ALiBi serving (BLOOM) and the generic decoder families in the port
against the JAX package.

The ALiBi slopes are held against the JAX package's two forms. Each ALiBi
kernel's plain PyTorch version (what the port runs on the CPU) is held
against the JAX package's Pallas kernel in interpret mode on the same numpy
inputs: K5 at G = 1 and G = 2 (the bias's head index is ``kv_head * G +
g``), the decode kernel over pages (D = 128, and D = 64 through the JAX
package's small-D kernel), with side rows at j = 0 and 2 (positions
``prefix + cc``) and as the decode step, K7 at 2 and 4 splits with its lse
(each split biases by ABSOLUTE key position), and the split dispatchers.
The port's dense ``DecoderLM`` is held against the flax module on the same
random weights for six families; a tiny BLOOM engine (f32, CPU) against the
JAX engine at rungs 1/2/4 and with int8 weights; and the other adapter
families' greedy streams against the JAX engine.

Tolerances, as the window and quant files use for the same kernels: kernels
2e-5 absolute in f32, the split-K paths 1e-5 relative plus 1e-5 absolute;
the dense forward and engine logits 1e-4 absolute in f32; greedy streams
exactly equal; slopes 1e-6 relative (f32 powers).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2 import ragged_model as jrm
from deepspeed_tpu.inference.v2.attention import AttentionKernelSpec as JaxSpec
from deepspeed_tpu.inference.v2.config_v2 import \
    RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import decoder as jdec
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.ops.pallas import paged_splitk as jsk
from deepspeed_tpu.ops.pallas.paged_attention import (
    _alibi_slope as jax_alibi_slope,
    paged_chunk_attention_batched as jax_chunk,
    paged_decode_attention as jax_decode,
    paged_decode_attention_sidebuf as jax_sidebuf,
    paged_decode_attention_step as jax_step)
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import attention as pattn
from deepspeed_tpu_torch.inference.v2 import ragged_model as prm
from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM, alibi_slopes
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.kernels import paged_splitk as psk
from deepspeed_tpu_torch.ops.kernels.alibi import alibi_slope
from deepspeed_tpu_torch.ops.kernels.kv_quant import scale_tile_rows
from deepspeed_tpu_torch.ops.kernels.paged_chunk import paged_chunk_attention_batched_plain
from deepspeed_tpu_torch.ops.kernels.paged_decode import paged_decode_attention_plain

from tests._torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS_ATOL = 1e-4
H, HKV, D, BS, NB, MB = 4, 2, 128, 16, 14, 6


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port, np.float32), np.asarray(ref, np.float32),
                               **(tol or dict(rtol=0, atol=ATOL)))


def _tables(rng, ctxs):
    """Block tables [len(ctxs), MB]: each row's pages from one permutation
    of the pool, no page shared."""
    perm = rng.permutation(NB)
    bt = np.zeros((len(ctxs), MB), np.int32)
    used = 0
    for i, c in enumerate(ctxs):
        n = -(-c // BS)
        bt[i, :n] = perm[used:used + n]
        used += n
    return bt


def _jit(fn, *static, **kw):
    """The JAX function jitted with its static arguments bound."""
    return jax.jit(lambda *a: fn(*a, *static, **kw))


def _spec(alibi=True, head_dim=D, heads=H, kv_heads=HKV):
    return prm.RaggedModelSpec(family="bloom", num_layers=1, hidden_size=heads * head_dim,
                               num_heads=heads, num_kv_heads=kv_heads, head_dim=head_dim,
                               vocab_size=16, alibi=alibi)


# --------------------------------------------------------------------- #
# the slopes
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("heads", [1, 4, 12, 16, 20, 32, 112])
def test_alibi_slopes_match_jax(heads):
    """The kernels' analytic f32 slopes against ``_alibi_slope``, the dense
    model's Python-float slopes against ``alibi_slopes``, and the two forms
    against each other (the non-powers of two take the interpolation)."""
    head = np.arange(heads, dtype=np.float32)
    port = alibi_slope(_t(head), heads).numpy()
    ref = np.asarray(jax_alibi_slope(jnp.asarray(head), heads))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    dense = alibi_slopes(heads).numpy()
    np.testing.assert_allclose(dense, np.asarray(jdec.alibi_slopes(heads)), rtol=1e-6, atol=0)
    np.testing.assert_allclose(port, dense, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(kernels.alibi_slopes(heads, torch.device("cpu")).numpy(),
                                  port)


# --------------------------------------------------------------------- #
# the ALiBi kernels' plain versions against the Pallas kernels
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("heads, kv_heads", [(4, 4), (4, 2)])
def test_paged_chunk_alibi_matches_k5(heads, kv_heads):
    """Continuation chunks, a chunk from 0 and an empty slot, at G = 1 and
    G = 2 (the bias's head is kv_head * G + g)."""
    rng = np.random.RandomState(heads + kv_heads)
    NC, Cs = 4, 8
    ctxs = [90, 8, 41, 0]
    q0 = np.array([82, 0, 33, 0], np.int32)
    pool, bt = _f(rng, NB, 2, kv_heads, BS, D), _tables(rng, ctxs)
    q = _f(rng, NC, Cs, heads, D)
    ctx = np.array(ctxs, np.int32)
    ref = _jit(jax_chunk, alibi=True)(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
                                      jnp.asarray(q0), jnp.asarray(ctx))
    port = paged_chunk_attention_batched_plain(_t(q), _t(pool), _t(bt), _t(q0), _t(ctx),
                                               alibi=True)
    _close(port, ref)
    assert float(port[3].abs().max()) == 0.0
    # the bias changes the function
    plain = paged_chunk_attention_batched_plain(_t(q), _t(pool), _t(bt), _t(q0), _t(ctx))
    assert float((plain - port).abs().max()) > 1e-2


@pytest.mark.parametrize("head_dim", [128, 64])
def test_paged_decode_alibi_matches_k3(head_dim):
    """Pages only: D = 128 through the Pallas decode kernel, D = 64 through
    ``_paged_decode_smalld`` (K3s, the kernel BLOOM-560M's D reaches on the
    TPU); ctx 0 gives zeros."""
    rng = np.random.RandomState(head_dim)
    ctxs = [90, 0, 37, 5]
    pool, bt = _f(rng, NB, 2, HKV, BS, head_dim), _tables(rng, ctxs)
    q = _f(rng, len(ctxs), H, head_dim)
    ctx = np.array(ctxs, np.int32)
    ref = _jit(jax_decode, alibi=True)(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
                                       jnp.asarray(ctx))
    port = paged_decode_attention_plain(_t(q), _t(pool), _t(bt), _t(ctx), alibi=True)
    _close(port, ref)
    assert float(port[1].abs().max()) == 0.0


@pytest.mark.parametrize("j", [0, 2])
def test_sidebuf_alibi_matches_k6(j):
    """Side rows at positions prefix + cc (C = 3, over 8 KV heads: the
    Pallas slab needs C * Hkv % 8 == 0); the slab's rows past j hold values
    that must not be attended."""
    rng = np.random.RandomState(10 + j)
    C, heads, kv_heads = 3, 16, 8
    prefix = [20, 0, 70]
    pool, bt = _f(rng, NB, 2, kv_heads, BS, D), _tables(rng, [p + C for p in prefix])
    q = _f(rng, 3, heads, D)
    sk, sv = _f(rng, 3, C, kv_heads, D), _f(rng, 3, C, kv_heads, D)
    pl = np.array(prefix, np.int32)
    ref = _jit(jax_sidebuf, j, alibi=True)(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(pl),
        jnp.asarray(sk), jnp.asarray(sv))
    port = paged_decode_attention_plain(_t(q), _t(pool), _t(bt), _t(pl),
                                        _t(sk.reshape(3, C * kv_heads, D)),
                                        _t(sv.reshape(3, C * kv_heads, D)), j, alibi=True)
    _close(port, ref)


def test_decode_step_alibi_matches_k4():
    """Both decode-step schedules of the port (the current token as a side
    row at ctx - 1, then written; written first, then attended) against the
    fused Pallas step: output and pool bytes."""
    rng = np.random.RandomState(3)
    ctxs = [81, 1, 16]
    pool, bt = _f(rng, NB, 2, HKV, BS, D), _tables(rng, ctxs)
    q, kn, vn = _f(rng, 3, H, D), _f(rng, 3, HKV, D), _f(rng, 3, HKV, D)
    ctx = np.array(ctxs, np.int32)
    ref_out, ref_pool = _jit(jax_step, alibi=True)(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pool),
        jnp.asarray(bt), jnp.asarray(ctx))
    ak = AttentionKernelSpec(_spec())
    for step in (ak.decode_step, ak.decode_step_write):
        pool_t = _t(pool.copy())
        _close(step(_t(q), _t(kn), _t(vn), pool_t, _t(bt), _t(ctx)), ref_out)
        np.testing.assert_array_equal(pool_t.numpy(), np.asarray(ref_pool))


@pytest.mark.parametrize("ns", [2, 4])
def test_splitk_alibi_matches_k7(ns):
    """Partials and merge against the Pallas split-K kernel, lse included:
    each split biases by absolute key position, so the lse streams agree
    (at 4 splits of 2 pages, ctx 37 leaves splits 2 and 3 empty)."""
    rng = np.random.RandomState(20 + ns)
    ctxs = [90, 0, 37, 5]
    pool, bt = _f(rng, NB, 2, HKV, BS, D), _tables(rng, ctxs)
    q = _f(rng, len(ctxs), H, D)
    cl = np.array(ctxs, np.int32)
    ref, ref_lse = _jit(jsk.paged_decode_attention_splitk_pallas, ns, alibi=True,
                        with_lse=True)(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
                                       jnp.asarray(cl))
    out, lse = psk.splitk_attention(_t(q), _t(pool), _t(bt), _t(cl), ns, with_lse=True,
                                    alibi=True)
    _close(out, ref, **F32)
    live = cl > 0
    _close(lse.numpy()[live], np.asarray(ref_lse)[live], **F32)
    assert float(out[1].abs().max()) == 0.0
    disp = psk.paged_decode_attention_splitk(_t(q), _t(pool), _t(bt), _t(cl), n_splits=ns,
                                             alibi=True)
    assert torch.equal(disp, out)


def test_splitk_alibi_dispatchers_match_jax():
    """The side-buffer split path (side piece at prefix + cc), the
    scatter-first step and the chunk split path (``paged_chunk_attention_xla``)
    with ALiBi, against the JAX dispatchers."""
    rng = np.random.RandomState(7)
    pool, q = _f(rng, NB, 2, HKV, BS, D), _f(rng, 4, H, D)
    C, j = 4, 2
    pfx = np.array([0, 1, 30, 60], np.int32)
    bt = _tables(rng, [p + C for p in pfx])
    sk, sv = _f(rng, 4, C, HKV, D), _f(rng, 4, C, HKV, D)
    ref = _jit(jsk.paged_sidebuf_attention_splitk, j, alibi=True, n_splits=4)(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(pfx),
        jnp.asarray(sk), jnp.asarray(sv))
    got = psk.paged_sidebuf_attention_splitk(_t(q), _t(pool), _t(bt), _t(pfx),
                                             _t(sk.reshape(4, C * HKV, D)),
                                             _t(sv.reshape(4, C * HKV, D)), j,
                                             n_splits=4, alibi=True)
    _close(got, ref, **F32)
    kn, vn = _f(rng, 4, HKV, D), _f(rng, 4, HKV, D)
    cl = pfx + 1
    o1, kv1 = _jit(jsk.paged_decode_attention_splitk_step, alibi=True, n_splits=2)(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pool),
        jnp.asarray(bt), jnp.asarray(cl))
    pool_t = _t(pool.copy())
    o2 = psk.paged_decode_attention_splitk_step(_t(q), _t(kn), _t(vn), pool_t, _t(bt),
                                                _t(cl), n_splits=2, alibi=True)
    _close(o2, o1, **F32)
    np.testing.assert_array_equal(pool_t.numpy(), np.asarray(kv1))
    Cs = 8
    qc = _f(rng, 4, Cs, H, D)
    ctx = np.array([0, 5, 33, 64], np.int32)
    q0 = np.maximum(ctx - Cs, 0).astype(np.int32)
    ref = _jit(jsk.paged_chunk_attention_splitk, alibi=True, n_splits=2)(
        jnp.asarray(qc), jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(q0),
        jnp.asarray(ctx))
    got = psk.paged_chunk_attention_splitk(_t(qc), _t(pool), _t(bt), _t(q0), _t(ctx),
                                           n_splits=2, alibi=True)
    _close(got, ref, **F32)


def test_alibi_wrappers_count_nothing_on_cpu_and_refuse_int8():
    """On the CPU the ALiBi wrappers run their plain versions and count no
    launch, over int8 pages too (their ALiBi branch is ported:
    tests/test_torch_int8_window_alibi.py)."""
    rng = np.random.RandomState(13)
    kernels.reset_launches()
    pool, bt = _t(_f(rng, NB, 2, HKV, BS, D)), _t(_tables(rng, [90, 5]))
    q, cl = _t(_f(rng, 2, H, D)), _t(np.array([90, 5], np.int32))
    assert torch.equal(kernels.paged_decode_attention(q, pool, bt, cl, alibi=True),
                       paged_decode_attention_plain(q, pool, bt, cl, alibi=True))
    assert torch.equal(kernels.splitk_attention(q, pool, bt, cl, 2, alibi=True),
                       psk.splitk_attention_plain(q, pool, bt, cl, 2, alibi=True))
    qc, q0 = _t(_f(rng, 2, 8, H, D)), _t(np.array([82, 0], np.int32))
    assert torch.equal(kernels.paged_chunk_attention_batched(qc, pool, bt, q0, cl, alibi=True),
                       paged_chunk_attention_batched_plain(qc, pool, bt, q0, cl, alibi=True))
    # an int8 pool needs Hkv * bs % 128 == 0: pages of 64 here
    g = torch.Generator().manual_seed(13)
    pool8 = torch.randint(-127, 128, (4, 2, HKV, 64, D), generator=g, dtype=torch.int8)
    tiles = torch.rand(4, scale_tile_rows(HKV, 64), 128, generator=g)
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    assert torch.equal(
        kernels.paged_decode_attention(q, pool8, bt, cl, kv_scales=tiles, alibi=True),
        paged_decode_attention_plain(q, pool8, bt, cl, kv_scales=tiles, alibi=True))
    assert torch.equal(
        kernels.splitk_attention(q, pool8, bt, cl, 2, kv_scales=tiles, alibi=True),
        psk.splitk_attention_plain(q, pool8, bt, cl, 2, kv_scales=tiles, alibi=True))
    assert torch.equal(
        kernels.paged_chunk_attention_batched(qc, pool8, bt, q0, cl, kv_scales=tiles,
                                              alibi=True),
        paged_chunk_attention_batched_plain(qc, pool8, bt, q0, cl, kv_scales=tiles,
                                            alibi=True))
    assert all(n == 0 for n in kernels.LAUNCHES.values())


# --------------------------------------------------------------------- #
# the dense decoder against the flax module
# --------------------------------------------------------------------- #

def _flax_decoder(family, seed=0, **kw):
    """A flax DecoderLM of the tiny config with every leaf drawn from numpy,
    and its flat numpy tree."""
    return _random_flax(jdec.DecoderLM(jdec.DecoderConfig.tiny(family, dtype=jnp.float32,
                                                               **kw)), seed)


def _random_flax(model, seed):
    """(model, params, flat numpy tree) with every leaf drawn from numpy
    (biases, norm scales and shifts included; the tree's shapes from
    ``eval_shape``)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        if k.endswith("scale"):
            flat[k] = 1.0 + 0.1 * noise
        elif k.endswith("embedding"):
            flat[k] = noise / np.sqrt(v.shape[1]).astype(np.float32)
        else:
            flat[k] = 0.05 * noise
    tree = jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))
    return model, tree, flat


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _port_decoder(family, flat, **kw):
    model = DecoderLM(DecoderConfig.tiny(family, **kw), device="cpu", seed=1)
    model.load_flat(params_from_flat(flat, device="cpu"))
    return model


@pytest.mark.parametrize("family", ["bloom", "opt", "falcon", "phi", "gpt_neox", "gptj"])
def test_dense_decoder_matches_flax(family):
    model, params, flat = _flax_decoder(family)
    port = _port_decoder(family, flat)
    assert set(port.flat_params()) == set(flat)
    ids = np.random.RandomState(1).randint(0, 256, (2, 24))
    ref = _jit(lambda p, x: model.apply({"params": p}, x, method="forward_logits"))(
        params, jnp.asarray(ids))
    got = port.forward_logits(torch.from_numpy(ids).long())
    _close(got, ref, rtol=0, atol=LOGITS_ATOL)


# --------------------------------------------------------------------- #
# the engine on a tiny BLOOM, and the other families, against the JAX engine
# --------------------------------------------------------------------- #

STATE = {"max_tracked_sequences": 8, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 36, "max_context": 120, "prefill_chunk_size": 16}
ENGINE = {"state_manager": STATE, "kv_cache": {"block_size": 8},
          "attention": {"decode_splits": 4, "min_ctx_per_split": 16}}


def _prompts(seed, lengths, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


def _engines(family, extra=None, **kw):
    model, params, flat = _flax_decoder(family, seed=3, **kw)
    conf = {**ENGINE, **(extra or {})}
    jax_engine = JaxEngine(model=model, model_parameters=params,
                           config={**conf, "dtype": jnp.float32})
    port_model = _port_decoder(family, flat, **kw)
    port_engine = InferenceEngineV2(port_model, {**conf, "dtype": torch.float32},
                                    port_model.flat_params(), device="cpu")
    return jax_engine, port_engine


@pytest.fixture(scope="module")
def bloom_engines():
    return _engines("bloom")


def test_bloom_engine_logits_match_jax(bloom_engines):
    """Prompts over several chunk passes (the paged pass serves every
    prefill: no packed pass exists), then a mixed pass of decode rows and a
    new prompt, at each pinned rung."""
    jax_engine, port_engine = bloom_engines
    assert port_engine.spec.alibi and port_engine.spec.tied_lm_head
    assert port_engine.spec.embed_norm and port_engine.spec.rope_theta is None
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
            for e in (jax_engine, port_engine):
                e.flush([0, 1, 2, 3])
            assert port_engine.free_blocks == base
    finally:
        jax_engine.attn_rung_override = port_engine.attn_rung_override = None


def test_bloom_greedy_streams_equal_jax_at_each_rung(bloom_engines):
    jax_engine, port_engine = bloom_engines
    prompts = _prompts(7, [66, 5, 31])
    try:
        for rung in (1, 2, 4):
            jax_engine.attn_rung_override = port_engine.attn_rung_override = rung
            port_engine.attn_stats.reset()
            ref = jax_engine.generate(prompts, max_new_tokens=8)
            got = port_engine.generate(prompts, max_new_tokens=8)
            assert [list(map(int, o)) for o in got] == [list(map(int, o)) for o in ref]
            assert set(port_engine.attn_stats.rungs) == {rung}
            assert not port_engine.scheduler.seqs
    finally:
        jax_engine.attn_rung_override = port_engine.attn_rung_override = None


def test_bloom_engine_never_runs_packed_prefill(bloom_engines, monkeypatch):
    """No packed prefill program is built for an ALiBi engine, none can be
    built for its spec, and a pure-prefill put never reaches the packed
    kernel."""
    _, port_engine = bloom_engines
    assert port_engine._pass_prefill is None
    with pytest.raises(ValueError, match="no\\s+position bias"):
        prm.build_prefill_forward(port_engine.spec)

    def refuse(*a, **k):
        raise AssertionError("the packed prefill kernel ran for an ALiBi engine")

    monkeypatch.setattr(pattn, "flash_attention_packed", refuse)
    logits = port_engine.put([5], _prompts(9, [40]))
    port_engine.flush([5])
    assert logits.shape == (1, 256) and np.isfinite(logits).all()


def test_bloom_int8_weights_match_jax():
    """weight_bits = 8 on a tied-head model: the tree has no lm_head, so
    only the layers' projections quantize (the repaired
    ``quantize_weights_int8``); logits against the JAX int8 engine."""
    jax_engine, port_engine = _engines("bloom", {"quantization": {"weight_bits": 8},
                                                 "attention": {"decode_splits": 1}})
    assert "lm_head" not in port_engine.weights
    assert isinstance(port_engine.weights["layers"][0]["wq"], dict)
    prompts = _prompts(11, [40, 9])
    _close(port_engine.put([0, 1], prompts), jax_engine.put([0, 1], prompts),
           rtol=0, atol=LOGITS_ATOL)


@pytest.mark.parametrize("family", ["opt", "falcon", "phi", "gpt_neox", "gptj", "gpt2"])
def test_adapter_family_greedy_streams_equal_jax(family):
    """Each other adapter family served by the port's engine (its family
    guessed as the JAX engine guesses it) gives the JAX engine's greedy
    streams; GPT-2 goes through ``adapt_gpt2`` from the port's
    ``GPT2LMHead`` tree."""
    conf = {**ENGINE, "attention": {"decode_splits": 1}}
    if family == "gpt2":
        model, params, flat = _random_flax(JaxGPT2(JaxGPT2Config.tiny(dtype=jnp.float32)), 4)
        jax_engine = JaxEngine(model=model, model_parameters=params,
                               config={**conf, "dtype": jnp.float32})
        port_model = GPT2LMHead(GPT2Config.tiny(), device="cpu")
        port_model.load_flat_params(params_from_flat(flat, device="cpu"))
        port_engine = InferenceEngineV2(port_model, {**conf, "dtype": torch.float32},
                                        port_model.flat_params(), device="cpu")
    else:
        jax_engine, port_engine = _engines(family, {"attention": conf["attention"]})
    assert port_engine.family == jax_engine.family == family
    prompts = _prompts(12, [41, 6])
    ref = jax_engine.generate(prompts, max_new_tokens=6)
    got = port_engine.generate(prompts, max_new_tokens=6)
    assert [list(map(int, o)) for o in got] == [list(map(int, o)) for o in ref]


# --------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------- #

def _message(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


@pytest.mark.parametrize("family, kw", [("gpt_neo", {}), ("opt", {"local_window": 8}),
                                        ("opt", {"attn_scale": 1.0})])
def test_unsupported_decoders_refused_in_jax_words(family, kw):
    """gpt_neo by family, local windows and attn_scale by feature: the
    port's engine raises the JAX adapters' errors word for word."""
    port_model = DecoderLM(DecoderConfig.tiny(family, **kw), device="cpu")
    jcfg = jdec.DecoderConfig.tiny(family, **kw)
    port = _message(lambda: InferenceEngineV2(port_model, {"dtype": torch.float32},
                                              port_model.flat_params(), device="cpu"))
    jax_ = _message(lambda: jrm.adapt_model(family, {}, jcfg))
    assert port == jax_ and port[0] is ValueError


def test_alibi_refusals_match_jax():
    """ALiBi with tensor_parallel > 1 (the JAX engine's words); kv_quant at
    BLOOM-560M's D = 64 fails the alignment gate (the JAX ValueError, word
    for word); at D = 128 both packages validate ALiBi over int8 pages."""
    cfg = RaggedInferenceEngineConfig.load()
    cfg.tensor_parallel = 2
    with pytest.raises(NotImplementedError,
                       match="ALiBi models with tensor_parallel > 1 are not wired"):
        AttentionKernelSpec.validate_engine_build(_spec(), cfg)
    spec = SimpleNamespace(head_dim=64, num_kv_heads=16, window=None, alibi=True, moe=None)
    conf = {"kv_quant": {"enabled": True}, "kv_cache": {"block_size": 128}}
    jax_ = _message(lambda: JaxSpec.validate_engine_build(spec, JaxEngineConfig.load(conf)))
    port = _message(lambda: AttentionKernelSpec.validate_engine_build(
        spec, RaggedInferenceEngineConfig.load(conf)))
    assert port == jax_ and port[0] is ValueError
    spec.head_dim = 128
    JaxSpec.validate_engine_build(spec, JaxEngineConfig.load(conf))
    AttentionKernelSpec.validate_engine_build(spec, RaggedInferenceEngineConfig.load(conf))


def test_unported_decoder_pieces_raise_by_name():
    """The training loss, remat, sequence_parallel and the v1 dense-cache
    decode wait for later slices; an unknown MLP activation is refused
    rather than served."""
    for flag in ("remat", "sequence_parallel"):
        with pytest.raises(NotImplementedError, match=flag):
            DecoderConfig.tiny("bloom", **{flag: True})
    model = DecoderLM(DecoderConfig.tiny("bloom"), device="cpu")
    with pytest.raises(NotImplementedError, match="training loss"):
        model({"input_ids": torch.zeros(1, 4, dtype=torch.long)})
    with pytest.raises(NotImplementedError, match="decode"):
        model.decode(None, None, 0)
    with pytest.raises(ValueError, match="unknown MLP activation 'mish'"):
        prm._plain_act("mish")
