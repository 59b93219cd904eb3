"""Memory-lean serving in the port against the JAX package: int8 KV pages,
weight-only int8 matmuls (K8) and flash-decoding split-K (K7).

Each kernel's plain PyTorch version (what the port runs on the CPU) is held
against the JAX package's Pallas kernel in interpret mode on the same
inputs, drawn from numpy seeds; the int8 pool and weight bytes are held
byte-equal (pages must stay movable between the two packages); and the
port's engine with all three features on is held against the JAX engine on
the same weights.

Tolerances: f32 attention and matmuls 1e-5 relative plus 1e-5 absolute (the
two frameworks sum the same f32 products in other orders); bf16 pools and
matmuls 2e-2 (bf16 rounds at other places in the two); engine logits 1e-4
absolute, as in ``test_torch_engine.py``; greedy streams exactly equal.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2 import ragged_model as jrm
from deepspeed_tpu.inference.v2.config_v2 import \
    RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.ops.pallas import paged_attention as pa
from deepspeed_tpu.ops.pallas import paged_splitk as jsk
from deepspeed_tpu.ops.pallas.quantized_matmul import quantized_matmul as jax_qmm
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import ragged_model as prm
from deepspeed_tpu_torch.inference.v2.attention import (AttentionKernelSpec,
                                                        write_token_rows)
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.kernels import kv_quant as pkq
from deepspeed_tpu_torch.ops.kernels import paged_splitk as psk
from deepspeed_tpu_torch.ops.kernels.paged_chunk import paged_chunk_attention_batched
from deepspeed_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
from deepspeed_tpu_torch.ops.kernels.quantized_matmul import (quantized_matmul,
                                                              quantized_matmul_plain)

from tests._torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
LOGITS_ATOL = 1e-4

# the JAX split-K tests' geometry: the int8 scale tiles need
# Hkv * bs % 128 == 0 and D % 128 == 0
S, H, HKV, D, BS, NB, MB = 4, 4, 2, 128, 64, 48, 6
CTX_EDGES = [0, 1, 65, 200]          # empty row, one token, past a page edge, mid-table


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _setup(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(S, H, D).astype(np.float32)
    kv = rng.randn(NB, 2, HKV, BS, D).astype(np.float32)
    bt = rng.choice(NB, size=(S, MB), replace=False).astype(np.int32)
    return rng, q, kv, bt


def _int8_pool(kv):
    """(jax int8 pages, jax scale tiles, torch int8 pages, torch tiles)."""
    kvq, scl = pa.kv_quantize_rows(jnp.asarray(kv))
    tiles = pa.kv_scales_to_tiles(scl)
    return kvq, tiles, _t(kvq), _t(tiles)


# --------------------------------------------------------------------- #
# int8 KV helpers: byte-equal to the JAX package
# --------------------------------------------------------------------- #

def test_kv_quant_helpers_byte_equal():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 2, 4, 16, 128) * rng.uniform(0.01, 30, (3, 2, 4, 16, 1))
         ).astype(np.float32)
    x[0, 0, 0, 0] = 0.0                            # a zero row
    x[1, 1, 2, 3, :4] = [1e4, -1e4, 5e3, -2.5e3]   # +-max in one row
    x[2, 0, 1, 5] = -x[2, 0, 1, 5]
    jq, js = pa.kv_quantize_rows(jnp.asarray(x))
    pq, ps = pkq.kv_quantize_rows(_t(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert pq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ps.numpy().tobytes() == np.asarray(js).tobytes()
    assert np.abs(pq.numpy()).max() == 127
    assert pkq.kv_write_dequant(_t(x)).numpy().tobytes() == \
        np.asarray(pa.kv_write_dequant(jnp.asarray(x))).tobytes()
    # re-quantizing the dequantized rows stores the same bytes
    rq, rs = pkq.kv_quantize_rows(pkq.kv_write_dequant(_t(x)))
    assert torch.equal(rq, pq) and torch.equal(rs, ps)
    # tiles: layout, padding and the round trip back to logical scales
    for hkv, bs in [(4, 16), (2, 64), (40, 128), (3, 32)]:
        assert pkq.scale_tile_rows(hkv, bs) == pa._scale_tile_rows(hkv, bs)
        assert pkq.kv_scale_tiles_shape(5, hkv, bs) == \
            tuple(pa.kv_scale_tiles_shape(5, hkv, bs))
    tiles = pkq.scales_to_tiles(ps)
    assert tiles.numpy().tobytes() == np.asarray(pa.kv_scales_to_tiles(js)).tobytes()
    assert torch.equal(pkq.scales_from_tiles(tiles, 4, 16), ps)


# --------------------------------------------------------------------- #
# K8: the int8 weight matmul
# --------------------------------------------------------------------- #

def _qweights(rng, K=512, N=384):
    w = rng.randn(K, N).astype(np.float32) * 0.05
    w[:, 3] = 0.0                                      # an all-zero column
    qd = prm.quantize_weight_int8(_t(w))
    return qd["w8"], qd["scale"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 7, 64])
def test_quantized_matmul_plain_matches_jax(M, dtype):
    rng = np.random.RandomState(M)
    w8, scale = _qweights(rng)
    a = rng.randn(M, 512).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    aj = jnp.asarray(a).astype(jdt)
    at = _t(np.asarray(aj.astype(jnp.float32))).to(tdt)
    got = quantized_matmul_plain(at, w8, scale)
    assert got.dtype == tdt and torch.equal(quantized_matmul(at, w8, scale), got)
    tol = F32 if dtype == "float32" else BF16
    ref = jax_qmm(aj, jnp.asarray(w8.numpy()), jnp.asarray(scale.numpy()[0]))
    np.testing.assert_allclose(_np(got), np.asarray(ref.astype(jnp.float32)), **tol)
    mm = jrm._mm(aj, {"w8": jnp.asarray(w8.numpy()), "scale": jnp.asarray(scale.numpy())})
    np.testing.assert_allclose(_np(prm._mm(at, {"w8": w8, "scale": scale})),
                               np.asarray(mm.astype(jnp.float32)), **tol)


# --------------------------------------------------------------------- #
# int8 bodies of the decode (K3/K4/K6) and chunk (K5) kernels
# --------------------------------------------------------------------- #

def test_int8_decode_plain_matches_pallas():
    _, q, kv, bt = _setup(1)
    kvq, tiles, pq, pt = _int8_pool(kv)
    cl = np.array(CTX_EDGES, np.int32)
    ref = pa.paged_decode_attention(jnp.asarray(q), kvq, jnp.asarray(bt),
                                    jnp.asarray(cl), kv_scales=tiles)
    got = paged_decode_attention(_t(q), pq, _t(bt), _t(cl), kv_scales=pt)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)
    assert np.all(_np(got)[0] == 0)


def test_int8_decode_step_matches_pallas_and_writes_same_bytes():
    """The port's step (attend the current token as an f32 side row, then
    write it quantized) against the JAX step kernel; both take the
    ``kv_write_dequant`` rows, as their engines hand them."""
    rng, q, kv, bt = _setup(2)
    kvq, tiles, pq, pt = _int8_pool(kv)
    cl = np.array([1, 2, 65, 200], np.int32)
    kn = pa.kv_write_dequant(jnp.asarray(rng.randn(S, HKV, D).astype(np.float32)))
    vn = pa.kv_write_dequant(jnp.asarray(rng.randn(S, HKV, D).astype(np.float32)))
    o1, kv1, sc1 = pa.paged_decode_attention_step(
        jnp.asarray(q), kn, vn, kvq, jnp.asarray(bt), jnp.asarray(cl), kv_scales=tiles)
    spec = SimpleNamespace(window=None, alibi=False)
    pq, pt = pq.clone(), pt.clone()
    out = AttentionKernelSpec(spec).decode_step(_t(q), _t(kn), _t(vn), pq, _t(bt),
                                                _t(cl), kv_scales=pt)
    np.testing.assert_allclose(_np(out), np.asarray(o1), **F32)
    assert pq.numpy().tobytes() == np.asarray(kv1).tobytes()
    assert pt.numpy().tobytes() == np.asarray(sc1).tobytes()


@pytest.mark.parametrize("j", [0, 2])
def test_int8_sidebuf_plain_matches_pallas(j):
    rng, q, kv, bt = _setup(3)
    kvq, tiles, pq, pt = _int8_pool(kv)
    C = 4
    pfx = np.array([0, 1, 130, 300], np.int32)
    sk = pa.kv_write_dequant(jnp.asarray(rng.randn(S, C, HKV, D).astype(np.float32)))
    sv = pa.kv_write_dequant(jnp.asarray(rng.randn(S, C, HKV, D).astype(np.float32)))
    ref = pa.paged_decode_attention_sidebuf(jnp.asarray(q), kvq, jnp.asarray(bt),
                                            jnp.asarray(pfx), sk, sv, j, kv_scales=tiles)
    got = paged_decode_attention(_t(q), pq, _t(bt), _t(pfx), _t(sk).reshape(S, C * HKV, D),
                                 _t(sv).reshape(S, C * HKV, D), j, kv_scales=pt)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)


def test_int8_chunk_plain_matches_pallas():
    rng, _, kv, bt = _setup(4)
    kvq, tiles, pq, pt = _int8_pool(kv)
    Cs = 16
    qc = rng.randn(S, Cs, H, D).astype(np.float32)
    ctx = np.array([0, 9, 80, 300], np.int32)
    q0 = np.maximum(ctx - Cs, 0).astype(np.int32)
    ref = pa.paged_chunk_attention_batched(jnp.asarray(qc), kvq, jnp.asarray(bt),
                                           jnp.asarray(q0), jnp.asarray(ctx),
                                           kv_scales=tiles)
    got = paged_chunk_attention_batched(_t(qc), pq, _t(bt), _t(q0), _t(ctx),
                                        kv_scales=pt)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)


# --------------------------------------------------------------------- #
# K7: split-K decode and its merge
# --------------------------------------------------------------------- #

def test_merge_splitk_partials_matches_jax():
    rng = np.random.RandomState(5)
    out_p = rng.randn(3, 4, H, D).astype(np.float32)
    lse_p = rng.randn(3, 4, H).astype(np.float32)
    lse_p[0, 2] = psk.NEG_INF           # one empty split
    lse_p[1] = psk.NEG_INF              # an all-empty row
    jo, jl = jsk.merge_splitk_partials(jnp.asarray(out_p), jnp.asarray(lse_p))
    po, pl_ = psk.merge_splitk_partials(_t(out_p), _t(lse_p))
    np.testing.assert_allclose(_np(po), np.asarray(jo), **F32)
    np.testing.assert_allclose(_np(pl_), np.asarray(jl), **F32)
    assert np.all(_np(po)[1] == 0) and np.all(_np(pl_)[1] <= psk.NEG_INF * 0.5)


@pytest.mark.parametrize("ns", [2, 4])
@pytest.mark.parametrize("pool", ["bfloat16", "int8"])
def test_splitk_plain_matches_pallas(pool, ns):
    _, q, kv, bt = _setup(6 + ns)
    cl = np.array(CTX_EDGES, np.int32)      # short rows leave splits empty
    if pool == "int8":
        jkv, jsc, pkv, psc = _int8_pool(kv)
        jq, pq_, tol = jnp.asarray(q), _t(q), F32
    else:
        jkv = jnp.asarray(kv).astype(jnp.bfloat16)
        pkv = _t(np.asarray(jkv.astype(jnp.float32))).to(torch.bfloat16)
        jq = jnp.asarray(q).astype(jnp.bfloat16)
        pq_ = _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
        jsc = psc = None
        tol = BF16
    ref, ref_lse = jsk.paged_decode_attention_splitk_pallas(
        jq, jkv, jnp.asarray(bt), jnp.asarray(cl), ns, with_lse=True, kv_scales=jsc)
    out, lse = psk.splitk_attention(pq_, pkv, _t(bt), _t(cl), ns, kv_scales=psc,
                                    with_lse=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref.astype(jnp.float32)), **tol)
    live = cl > 0
    np.testing.assert_allclose(_np(lse)[live], np.asarray(ref_lse)[live], **tol)
    assert np.all(_np(out)[0] == 0) and np.all(_np(lse)[0] <= psk.NEG_INF * 0.5)
    # the dispatcher at this split count is the same function
    disp = psk.paged_decode_attention_splitk(pq_, pkv, _t(bt), _t(cl), kv_scales=psc,
                                             n_splits=ns)
    assert torch.equal(disp, out)


def test_splitk_dispatchers_split1_and_step_and_sidebuf():
    rng, q, kv, bt = _setup(9)
    kvq, tiles, pq, pt = _int8_pool(kv)
    cl = np.array([1, 2, 65, 200], np.int32)
    # split 1 without lse is the base decode kernel, byte for byte
    base = paged_decode_attention(_t(q), pq, _t(bt), _t(cl), kv_scales=pt)
    assert torch.equal(psk.paged_decode_attention_splitk(
        _t(q), pq, _t(bt), _t(cl), kv_scales=pt, n_splits=1), base)
    one = psk.paged_decode_attention_splitk(_t(q), pq, _t(bt), _t(cl), kv_scales=pt,
                                            n_splits=1, with_lse=True)[0]
    np.testing.assert_allclose(_np(one), _np(base), **F32)
    # scatter-first split-K step against the JAX one: output and pool bytes
    kn = pa.kv_write_dequant(jnp.asarray(rng.randn(S, HKV, D).astype(np.float32)))
    vn = pa.kv_write_dequant(jnp.asarray(rng.randn(S, HKV, D).astype(np.float32)))
    o1, kv1, sc1 = jsk.paged_decode_attention_splitk_step(
        jnp.asarray(q), kn, vn, kvq, jnp.asarray(bt), jnp.asarray(cl), kv_scales=tiles,
        n_splits=2)
    pq2, pt2 = pq.clone(), pt.clone()
    o2 = psk.paged_decode_attention_splitk_step(_t(q), _t(kn), _t(vn), pq2, _t(bt),
                                                _t(cl), kv_scales=pt2, n_splits=2)
    np.testing.assert_allclose(_np(o2), np.asarray(o1), **F32)
    assert pq2.numpy().tobytes() == np.asarray(kv1).tobytes()
    assert pt2.numpy().tobytes() == np.asarray(sc1).tobytes()
    # split-K side buffer: pages split 4 ways plus the side piece
    C, j = 4, 2
    pfx = np.array([0, 1, 130, 300], np.int32)
    sk = pa.kv_write_dequant(jnp.asarray(rng.randn(S, C, HKV, D).astype(np.float32)))
    sv = pa.kv_write_dequant(jnp.asarray(rng.randn(S, C, HKV, D).astype(np.float32)))
    ref = jsk.paged_sidebuf_attention_splitk(jnp.asarray(q), kvq, jnp.asarray(bt),
                                             jnp.asarray(pfx), sk, sv, j,
                                             kv_scales=tiles, n_splits=4)
    got = psk.paged_sidebuf_attention_splitk(_t(q), pq, _t(bt), _t(pfx),
                                             _t(sk).reshape(S, C * HKV, D),
                                             _t(sv).reshape(S, C * HKV, D), j,
                                             kv_scales=pt, n_splits=4)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)


@pytest.mark.parametrize("ns", [2, 4])
def test_chunk_split_path_matches_jax(ns):
    rng, _, kv, bt = _setup(10)
    kvq, tiles, pq, pt = _int8_pool(kv)
    Cs = 8
    qc = rng.randn(S, Cs, H, D).astype(np.float32)
    ctx = np.array([0, 5, 70, 300], np.int32)
    q0 = np.maximum(ctx - Cs, 0).astype(np.int32)
    ref = jsk.paged_chunk_attention_splitk(jnp.asarray(qc), kvq, jnp.asarray(bt),
                                           jnp.asarray(q0), jnp.asarray(ctx),
                                           kv_scales=tiles, n_splits=ns)
    got = psk.paged_chunk_attention_splitk(_t(qc), pq, _t(bt), _t(q0), _t(ctx),
                                           kv_scales=pt, n_splits=ns)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)


def test_pass_write_and_step_write_store_the_same_bytes():
    """Quantize-on-write: the ragged pass quantizes the raw K/V rows; the
    decode step re-quantizes their ``kv_write_dequant`` values. Both store
    the same page and scale bytes for the same token."""
    rng, _, kv, bt = _setup(11)
    _, _, pq, pt = _int8_pool(kv)
    k = _t(rng.randn(S, HKV, D).astype(np.float32) * 3)
    v = _t(rng.randn(S, HKV, D).astype(np.float32))
    pos = torch.tensor([0, 63, 64, 300], dtype=torch.int32)
    page = _t(bt).long().gather(1, (pos.long() // BS)[:, None])[:, 0]
    dest = (page * BS + pos.long() % BS).to(torch.int32)
    a_kv, a_sc, b_kv, b_sc = pq.clone(), pt.clone(), pq.clone(), pt.clone()
    rows = prm._kv_write_rows(dest, HKV, BS)
    prm._kv_page_write_quant(a_kv, a_sc, k, v, torch.arange(S), rows)
    write_token_rows(b_kv, pkq.kv_write_dequant(k), pkq.kv_write_dequant(v), _t(bt), pos,
                     b_sc)
    assert torch.equal(a_kv, b_kv) and torch.equal(a_sc, b_sc)
    assert not torch.equal(a_kv, pq)


# --------------------------------------------------------------------- #
# configuration and capability table
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("section, value", [
    ("quantization", {"weight_bits": 5}),
    ("kv_quant", {"enabled": True, "bits": 4}),
    ("attention", {"decode_splits": 3}),
    ("attention", {"decode_splits": 2, "min_ctx_per_split": 0}),
])
def test_config_validation_messages_match_jax(section, value):
    with pytest.raises(ValueError) as jax_err:
        JaxEngineConfig.load({section: value})
    with pytest.raises(ValueError) as port_err:
        RaggedInferenceEngineConfig.load({section: value})
    assert str(port_err.value) == str(jax_err.value)


def test_kv_quant_alignment_gate_matches_jax():
    from deepspeed_tpu.inference.v2.attention import AttentionKernelSpec as JaxSpec
    spec = SimpleNamespace(head_dim=64, num_kv_heads=2, window=None, alibi=False,
                           moe=None)
    conf = {"kv_quant": {"enabled": True}, "kv_cache": {"block_size": 16}}
    with pytest.raises(ValueError) as jax_err:
        JaxSpec.validate_engine_build(spec, JaxEngineConfig.load(conf))
    with pytest.raises(ValueError) as port_err:
        AttentionKernelSpec.validate_engine_build(spec, RaggedInferenceEngineConfig.load(conf))
    assert str(port_err.value) == str(jax_err.value)
    spec.head_dim = 128
    conf["kv_cache"]["block_size"] = 64
    AttentionKernelSpec.validate_engine_build(spec, RaggedInferenceEngineConfig.load(conf))


def test_weight_bits_4_still_raises_by_name():
    """Packed int4 weights load (served against the JAX engine:
    tests/test_torch_int4_weights.py); another bit width is refused in the
    JAX package's words."""
    cfg = RaggedInferenceEngineConfig.load({"quantization": {"weight_bits": 4}})
    assert cfg.quantization.weight_bits == 4
    conf = {"quantization": {"weight_bits": 3}}
    with pytest.raises(ValueError) as jax_err:
        JaxEngineConfig.load(conf)
    with pytest.raises(ValueError) as port_err:
        RaggedInferenceEngineConfig.load(conf)
    assert str(port_err.value) == str(jax_err.value)


def test_weight_carrier_defaults_to_cuda_and_raises_here():
    flat = {"w": np.ones((2, 2), np.float32)}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_flat(flat, device=None)
    assert params_from_flat(flat, device="cpu")["w"].device.type == "cpu"


@pytest.mark.parametrize("live, override, want", [
    ([], None, 1), ([100], None, 1), ([511, 40], None, 1), ([512], None, 1),
    ([1024], None, 2), ([1535, 7], None, 2), ([2048], None, 4), ([4200, 900], None, 8),
    ([100000], None, 8), ([4200], 1, 1), ([10], 4, 4), ([10], 64, 8), ([10], 0, 1),
])
def test_attn_rung_matches_jax(live, override, want):
    from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JE
    from deepspeed_tpu.monitor.serving import AttnSplitStats as JaxStats
    from deepspeed_tpu_torch.inference.v2.engine_v2 import AttnSplitStats

    def stub(stats):
        return SimpleNamespace(
            config=SimpleNamespace(attention=SimpleNamespace(decode_splits=8,
                                                             min_ctx_per_split=512)),
            attn_rung_override=override, attn_stats=stats,
            scheduler=SimpleNamespace(seqs={i: SimpleNamespace(seen_tokens=n)
                                            for i, n in enumerate(live)}))

    js, ps = stub(JaxStats()), stub(AttnSplitStats())
    assert JE._attn_rung(js) == InferenceEngineV2._attn_rung(ps) == want
    assert ps.attn_stats.rungs == {want: 1}


# --------------------------------------------------------------------- #
# the engine with int8 weights, int8 KV and split-K, against the JAX one
# --------------------------------------------------------------------- #

LLAMA = dict(vocab_size=256, hidden_size=512, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=512)
ENGINE = {"state_manager": {"max_tracked_sequences": 4, "max_ragged_sequence_count": 4,
                            "max_ragged_batch_size": 64, "prefill_chunk_size": 16,
                            "max_context": 256},
          "kv_cache": {"block_size": 64},
          "quantization": {"weight_bits": 8}, "kv_quant": {"enabled": True},
          "attention": {"decode_splits": 4, "min_ctx_per_split": 16}}


@pytest.fixture(scope="module")
def quant_engines():
    cfg = JaxLlamaConfig(dtype=jnp.float32, **LLAMA)
    model = JaxLlama(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    jax_engine = JaxEngine(model=model, model_parameters=params,
                           config={**ENGINE, "dtype": jnp.float32})
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    port_model = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu", seed=1)
    port_model.load_flat(params_from_flat(flat, device="cpu"))
    port_engine = InferenceEngineV2(port_model, {**ENGINE, "dtype": torch.float32},
                                    port_model.flat_params(), device="cpu")
    return jax_engine, port_engine


def _prompts(seed, lengths, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lengths]


def test_int8_weight_trees_byte_equal(quant_engines):
    jax_engine, port_engine = quant_engines
    jw, pw = jax_engine.weights, port_engine.weights
    for l, layer in enumerate(pw["layers"]):
        for key in prm._QUANT_KEYS:
            jd = (jw["layers"]["mlp"][key] if key.startswith("w_")
                  else jw["layers"][key])
            for part in ("w8", "scale"):
                assert layer[key][part].numpy().tobytes() == \
                    np.asarray(jd[part][l]).tobytes(), (l, key, part)
    for part in ("w8", "scale"):
        assert pw["lm_head"][part].numpy().tobytes() == \
            np.asarray(jw["lm_head"][part]).tobytes()
    assert port_engine.kv.kv.dtype == torch.int8
    assert tuple(port_engine.kv.scales.shape) == tuple(jax_engine.kv.kv[1].shape)


def test_int8_weight_trees_byte_equal_from_bf16():
    """The same bf16 weights quantize to the same bytes: the JAX package's
    stacked ``[L, K, N]`` tree against the port's per-layer dicts."""
    rng = np.random.RandomState(14)
    L, hid, ff, V = 2, 256, 384, 512
    shapes = {"wq": (hid, hid), "wk": (hid, 128), "wv": (hid, 128), "wo": (hid, hid),
              "w_gate": (hid, ff), "w_up": (hid, ff), "w_down": (ff, hid)}
    stacks = {k: jnp.asarray(rng.randn(L, *sh).astype(np.float32) * 0.05).astype(jnp.bfloat16)
              for k, sh in shapes.items()}
    head = jnp.asarray(rng.randn(hid, V).astype(np.float32) * 0.05).astype(jnp.bfloat16)
    jtree = {"layers": {**{k: stacks[k] for k in ("wq", "wk", "wv", "wo")},
                        "mlp": {k: stacks[k] for k in ("w_gate", "w_up", "w_down")}},
             "lm_head": head}
    jrm.quantize_weights_int8(jtree)

    def bf16(x):
        return _t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)

    ptree = {"layers": [{k: bf16(stacks[k][l]) for k in shapes} for l in range(L)],
             "lm_head": bf16(head)}
    prm.quantize_weights_int8(ptree)
    for l in range(L):
        for k in shapes:
            jd = jtree["layers"]["mlp"][k] if k.startswith("w_") else jtree["layers"][k]
            for part in ("w8", "scale"):
                assert ptree["layers"][l][k][part].numpy().tobytes() == \
                    np.asarray(jd[part][l]).tobytes(), (l, k, part)
    for part in ("w8", "scale"):
        assert ptree["lm_head"][part].numpy().tobytes() == \
            np.asarray(jtree["lm_head"][part]).tobytes()


def test_quant_engine_put_logits_and_pool_match_jax(quant_engines):
    jax_engine, port_engine = quant_engines
    base = port_engine.free_blocks
    prompts = _prompts(1, [70, 9, 33])           # 70 tokens span two passes
    ref = jax_engine.put([0, 1, 2], prompts)
    got = port_engine.put([0, 1, 2], prompts)
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGITS_ATOL)
    # a mixed pass at rung 4 (the 70-token context): decode rows + a prompt
    step = [np.array([int(np.argmax(r))], np.int32) for r in ref[:2]]
    new = _prompts(2, [20])
    ref2 = jax_engine.put([0, 1, 3], step + new)
    got2 = port_engine.put([0, 1, 3], step + new)
    np.testing.assert_allclose(got2, ref2, rtol=0, atol=LOGITS_ATOL)
    assert port_engine.attn_stats.rungs.get(4, 0) > 0
    # the int8 pages the two engines hold for the same tokens agree: values
    # within one int8 step (the K/V rows agree to f32 rounding, which may
    # cross a rounding edge), scales to f32 rounding
    jkv, jsc = (np.asarray(a) for a in jax_engine.kv.kv)
    pkv, psc = port_engine.kv.kv.numpy(), port_engine.kv.scales.numpy()
    for uid in (0, 1, 2, 3):
        jseq, pseq = jax_engine.scheduler.seqs[uid], port_engine.scheduler.seqs[uid]
        assert pseq.seen_tokens == jseq.seen_tokens
        for jb, pb in zip(jseq.blocks, pseq.blocks):
            np.testing.assert_allclose(pkv[:, pb].astype(np.int32),
                                       jkv[:, jb].astype(np.int32), rtol=0, atol=1)
            np.testing.assert_allclose(psc[:, pb], jsc[:, jb], rtol=1e-4, atol=1e-7)
    for e in quant_engines:
        e.flush([0, 1, 2, 3])
    assert port_engine.free_blocks == base


def test_quant_engine_greedy_streams_equal_jax(quant_engines):
    jax_engine, port_engine = quant_engines
    prompts = _prompts(3, [70, 5, 40])
    ref = jax_engine.generate(prompts, max_new_tokens=6)
    got = port_engine.generate(prompts, max_new_tokens=6)
    assert [list(map(int, o)) for o in got] == [list(map(int, o)) for o in ref]
    assert not port_engine.scheduler.seqs


def test_quant_engine_streams_invariant_across_pinned_rungs(quant_engines):
    _, port_engine = quant_engines
    prompts = _prompts(4, [90, 30])
    streams = {}
    try:
        for rung in port_engine.attn_split_ladder:
            port_engine.attn_rung_override = rung
            port_engine.attn_stats.reset()
            streams[rung] = port_engine.generate(prompts, max_new_tokens=6)
            assert set(port_engine.attn_stats.rungs) == {rung}
    finally:
        port_engine.attn_rung_override = None
    assert port_engine.attn_split_ladder == [1, 2, 4]
    assert all(s == streams[1] for s in streams.values())


def test_new_wrappers_run_plain_on_cpu_and_count_nothing():
    rng = np.random.RandomState(12)
    kernels.reset_launches()
    w8, scale = _qweights(rng)
    a = _t(rng.randn(3, 512).astype(np.float32))
    assert torch.equal(kernels.quantized_matmul(a, w8, scale),
                       kernels.quantized_matmul_plain(a, w8, scale))
    _, q, kv, bt = _setup(13)
    cl = _t(np.array(CTX_EDGES, np.int32))
    assert torch.equal(kernels.splitk_attention(_t(q), _t(kv), _t(bt), cl, 2),
                       kernels.splitk_attention_plain(_t(q), _t(kv), _t(bt), cl, 2))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        kernels.quantized_matmul(a.to("meta"), w8, scale)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.splitk_attention(_t(q).to("meta"), _t(kv), _t(bt), cl, 2)
