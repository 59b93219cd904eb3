"""Packed int4 weights (``quantization.weight_bits = 4``) in the port against
the JAX package.

``ops/quantizer.pack_int4`` / ``unpack_int4`` and the engine's
``quantize_weights_int4`` are held byte-equal to the JAX package's on
numpy inputs made from a seed (every int4 value, odd and even positions,
several axes; a bf16 weight tree quantized stacked in JAX and per layer in
the port, an all-zero column included); ``_mm`` over a packed weight
against the JAX package's ``_mm`` (unpack, f32 dot, column scale); and a
tiny Llama served with ``weight_bits = 4`` against the JAX engine on the
same weights: its packed tree byte-equal, ``put`` logits and greedy
streams.

Tolerances: f32 matmuls 1e-5 relative plus 1e-5 absolute, bf16 2e-2 (as
``test_torch_quant_serving.py``); engine logits 1e-4 absolute in f32
(``test_torch_engine.py``); greedy streams exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2 import ragged_model as jrm
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import ragged_model as prm
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.quantizer import pack_int4, unpack_int4

from tests._torch_threads import one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
LOGITS_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# --------------------------------------------------------------------- #
# the packed format and the quantizer, byte-equal to the JAX package
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("shape, axis", [((16, 6), -2), ((3, 10, 4), -2), ((4, 8), -1),
                                         ((2, 4, 6), 0)])
def test_pack_unpack_int4_byte_equal_jax(shape, axis):
    """Every value of [-8, 7] packs to JAX's bytes; every byte unpacks to
    JAX's values (sign-extended nibbles); unpack inverts pack."""
    rng = np.random.RandomState(len(shape) * 10 + axis)
    q = rng.randint(-8, 8, shape).astype(np.int8)
    q.reshape(-1)[:16] = np.arange(-8, 8)
    ref = np.asarray(jq.pack_int4(jnp.asarray(q), axis=axis))
    got = pack_int4(_t(q), axis=axis)
    assert got.dtype == torch.int8 and got.shape == ref.shape
    assert got.numpy().tobytes() == ref.tobytes()
    assert torch.equal(unpack_int4(got, axis=axis), _t(q))
    p = rng.randint(-128, 128, ref.shape).astype(np.int8)
    p.reshape(-1)[:4] = [-128, -1, 0, 127]
    want = np.asarray(jq.unpack_int4(jnp.asarray(p), axis=axis))
    assert unpack_int4(_t(p), axis=axis).numpy().tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="must be even"):
        pack_int4(_t(np.zeros((3, 5), np.int8)), axis=0)


def _bf16(x):
    return _t(np.asarray(jnp.asarray(x).astype(jnp.float32))).to(torch.bfloat16)


def test_int4_weight_trees_byte_equal_from_bf16():
    """The same bf16 weights quantize to the same packed bytes and scales:
    the JAX package's stacked ``[L, K, N]`` tree against the port's
    per-layer dicts, the head included; an all-zero column gets scale 1."""
    rng = np.random.RandomState(14)
    L, hid, ff, V = 2, 256, 384, 512
    shapes = {"wq": (hid, hid), "wk": (hid, 128), "wv": (hid, 128), "wo": (hid, hid),
              "w_gate": (hid, ff), "w_up": (hid, ff), "w_down": (ff, hid)}
    stacks = {k: jnp.asarray(rng.randn(L, *sh).astype(np.float32) * 0.05).astype(jnp.bfloat16)
              for k, sh in shapes.items()}
    stacks["wq"] = stacks["wq"].at[:, :, 5].set(0)
    head = jnp.asarray(rng.randn(hid, V).astype(np.float32) * 0.05).astype(jnp.bfloat16)
    jtree = {"layers": {**{k: stacks[k] for k in ("wq", "wk", "wv", "wo")},
                        "mlp": {k: stacks[k] for k in ("w_gate", "w_up", "w_down")}},
             "lm_head": head}
    jrm.quantize_weights_int4(jtree)
    ptree = {"layers": [{k: _bf16(stacks[k][l]) for k in shapes} for l in range(L)],
             "lm_head": _bf16(head)}
    prm.quantize_weights_int4(ptree)
    for l in range(L):
        for k in shapes:
            jd = jtree["layers"]["mlp"][k] if k.startswith("w_") else jtree["layers"][k]
            for part in ("w4", "scale"):
                assert ptree["layers"][l][k][part].numpy().tobytes() == \
                    np.asarray(jd[part][l]).tobytes(), (l, k, part)
    for part in ("w4", "scale"):
        assert ptree["lm_head"][part].numpy().tobytes() == \
            np.asarray(jtree["lm_head"][part]).tobytes()
    w4 = ptree["layers"][0]["wq"]
    assert w4["w4"].shape == (hid // 2, hid) and w4["scale"].shape == (1, hid)
    assert float(w4["scale"][0, 5]) == 1.0
    assert int(unpack_int4(w4["w4"]).abs().max()) == 7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_mm_matches_jax(dtype):
    """``_mm`` over a packed weight: unpack, then K8's function (f32 sum,
    the column scale once), against the JAX package's ``_mm`` w4 branch."""
    rng = np.random.RandomState(3)
    w = rng.randn(512, 384).astype(np.float32) * 0.05
    qd = prm.quantize_weight_int4(_t(w))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    a = jnp.asarray(rng.randn(7, 512).astype(np.float32)).astype(jdt)
    at = _t(np.asarray(a.astype(jnp.float32))).to(tdt)
    ref = jrm._mm(a, {"w4": jnp.asarray(qd["w4"].numpy()),
                      "scale": jnp.asarray(qd["scale"].numpy())})
    kernels.reset_launches()
    got = prm._mm(at, qd)
    assert got.dtype == tdt and all(n == 0 for n in kernels.LAUNCHES.values())
    assert torch.equal(got, kernels.quantized_matmul_plain(at, unpack_int4(qd["w4"]),
                                                           qd["scale"]))
    np.testing.assert_allclose(_np(got), np.asarray(ref.astype(jnp.float32)),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_mm_above_the_gemv_rows_matches_jax(dtype):
    """``_mm`` over a packed weight at M = 9, one row past K8's gemv: the
    route that unpacks the weight for ``qmm_mma`` (on the CPU, its plain
    version), against the JAX package's ``_mm`` w4 branch."""
    rng = np.random.RandomState(4)
    w = rng.randn(512, 384).astype(np.float32) * 0.05
    qd = prm.quantize_weight_int4(_t(w))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    a = jnp.asarray(rng.randn(9, 512).astype(np.float32)).astype(jdt)
    at = _t(np.asarray(a.astype(jnp.float32))).to(tdt)
    ref = jrm._mm(a, {"w4": jnp.asarray(qd["w4"].numpy()),
                      "scale": jnp.asarray(qd["scale"].numpy())})
    kernels.reset_launches()
    got = prm._mm(at, qd)
    assert got.dtype == tdt and all(n == 0 for n in kernels.LAUNCHES.values())
    assert torch.equal(got, kernels.quantized_matmul_plain(at, unpack_int4(qd["w4"]),
                                                           qd["scale"]))
    np.testing.assert_allclose(_np(got), np.asarray(ref.astype(jnp.float32)),
                               **(F32 if dtype == "float32" else BF16))


def test_weight_bits_4_config_loads():
    cfg = RaggedInferenceEngineConfig.load({"quantization": {"weight_bits": 4}})
    assert cfg.quantization.weight_bits == 4
    with pytest.raises(ValueError, match="weight_bits must be None, 4 or 8"):
        RaggedInferenceEngineConfig.load({"quantization": {"weight_bits": 2}})


# --------------------------------------------------------------------- #
# a tiny Llama served with int4 weights, against the JAX engine
# --------------------------------------------------------------------- #

LLAMA = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=256)
ENGINE = {"state_manager": {"max_tracked_sequences": 4, "max_ragged_sequence_count": 4,
                            "max_ragged_batch_size": 68, "prefill_chunk_size": 16,
                            "max_context": 256},
          "kv_cache": {"block_size": 16}, "quantization": {"weight_bits": 4}}


def _random_flax(model, seed):
    """(params, flat numpy tree): every leaf drawn from numpy, kernels at
    unit-variance outputs."""
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
        else:
            flat[k] = noise / np.float32(np.sqrt(v.shape[0]))
    tree = {}
    for k, a in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree, flat


@pytest.fixture(scope="module")
def int4_engines():
    model = JaxLlama(JaxLlamaConfig(dtype=jnp.float32, **LLAMA))
    params, flat = _random_flax(model, 5)
    jax_engine = JaxEngine(model=model, model_parameters=params,
                           config={**ENGINE, "dtype": jnp.float32})
    port_model = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu", seed=1)
    port_model.load_flat(params_from_flat(flat, device="cpu"))
    port_engine = InferenceEngineV2(port_model, {**ENGINE, "dtype": torch.float32},
                                    port_model.flat_params(), device="cpu")
    return jax_engine, port_engine


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, LLAMA["vocab_size"], n).astype(np.int32) for n in lengths]


def test_int4_engine_tree_byte_equal_jax(int4_engines):
    """The engine quantizes its model-dtype tree at build, as the JAX
    engine does: the same packed bytes and scales per layer and head."""
    jax_engine, port_engine = int4_engines
    jw, pw = jax_engine.weights, port_engine.weights
    for l, layer in enumerate(pw["layers"]):
        for key in prm._QUANT_KEYS:
            jd = jw["layers"]["mlp"][key] if key.startswith("w_") else jw["layers"][key]
            assert set(layer[key]) == {"w4", "scale"}
            for part in ("w4", "scale"):
                assert layer[key][part].numpy().tobytes() == \
                    np.asarray(jd[part][l]).tobytes(), (l, key, part)
    for part in ("w4", "scale"):
        assert pw["lm_head"][part].numpy().tobytes() == \
            np.asarray(jw["lm_head"][part]).tobytes()


def test_int4_engine_logits_and_greedy_streams_match_jax(int4_engines):
    """put() logits (a prompt across two passes, then decode rows mixed
    with a new prompt) and greedy streams through generate()."""
    jax_engine, port_engine = int4_engines
    base = port_engine.free_blocks
    prompts = _prompts(1, [90, 9, 33])
    ref = jax_engine.put([0, 1, 2], prompts)
    got = port_engine.put([0, 1, 2], prompts)
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGITS_ATOL)
    step = [np.array([int(np.argmax(r))], np.int32) for r in ref[:2]]
    new = _prompts(2, [20])
    np.testing.assert_allclose(port_engine.put([0, 1, 3], step + new),
                               jax_engine.put([0, 1, 3], step + new), rtol=0,
                               atol=LOGITS_ATOL)
    for e in int4_engines:
        e.flush([0, 1, 2, 3])
    prompts = _prompts(3, [70, 5, 40])
    ref = jax_engine.generate(prompts, max_new_tokens=6)
    got = port_engine.generate(prompts, max_new_tokens=6)
    assert [list(map(int, o)) for o in got] == [list(map(int, o)) for o in ref]
    assert port_engine.free_blocks == base and not port_engine.scheduler.seqs
