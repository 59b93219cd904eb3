"""Mixtral MoE serving in the port against the JAX package.

The port's dense Mixtral forward against the JAX package's
``MixtralForCausalLM(dispatch_mode="dropless")``; the port's ``_moe_ffn``
against the JAX engine's on the same rows, with one expert that gets no
rows and one that gets all of them, over f32 and int8 expert stacks; K8's
grouped entry (its plain version on the CPU) against each expert's rows
through ``quantized_matmul_plain``; the port's engine against the JAX
engine on the same weights (``put`` logits, greedy streams, bursts against
per-step decoding); ``weight_bits = 8``: int8 expert stacks byte-equal to
the JAX engine's and to quantizing after the build, greedy streams equal
to the JAX int8 engine's, and, on the JAX package's own test model and
prompts, to the f32 engine's; and the refusals (MoE with int4 weights or
``tensor_parallel > 1``, ``dispatch_mode="capacity"``).

Tolerances: f32 logits and FFN rows 1e-4 absolute plus 1e-4 relative (the
two frameworks sum in other orders; the routing itself has no ties on
these random f32 weights); the grouped plain version against per-expert
products bitwise (the same products); greedy streams exactly equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2 import ragged_model as jrm
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from deepspeed_tpu_torch.checkpoint import params_from_flat, params_to_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import ragged_model as prm
from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.models import MixtralConfig, MixtralForCausalLM
from deepspeed_tpu_torch.ops import kernels

from tests._torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
MIXTRAL = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
               num_local_experts=4, num_experts_per_tok=2)
ENGINE = {"state_manager": {"max_tracked_sequences": 4, "max_ragged_sequence_count": 4,
                            "max_ragged_batch_size": 68, "prefill_chunk_size": 16,
                            "max_context": 128},
          "kv_cache": {"block_size": 16}}


def _random_flax(model, seed):
    """(params, flat numpy tree) from ``jax.eval_shape`` shapes and numpy at
    the scales of the JAX package's initialisers: norms near 1, embeddings
    at 1/sqrt(hidden), kernels at 1/sqrt(fan_in), expert stacks at 0.02
    (``MixtralSparseMoeBlock``'s normal(0.02)); biases at 0.1."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        if k.endswith("weight"):
            flat[k] = 1.0 + 0.1 * noise
        elif k.endswith("embedding"):
            flat[k] = noise / np.float32(np.sqrt(v.shape[1]))
        elif k.endswith("bias"):
            flat[k] = 0.1 * noise
        elif k.endswith(("w_gate", "w_up", "w_down")):
            flat[k] = 0.02 * noise
        else:
            flat[k] = noise / np.float32(np.sqrt(v.shape[-2]))
    tree = {}
    for k, a in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree, flat


@pytest.fixture(scope="module")
def mixtral():
    """(JAX model, JAX params, flat numpy tree, port model) on the same
    weights."""
    jmodel = JaxMixtral(JaxMixtralConfig(dtype=jnp.float32, dispatch_mode="dropless",
                                         **MIXTRAL))
    params, flat = _random_flax(jmodel, 7)
    port = MixtralForCausalLM(MixtralConfig(**MIXTRAL), device="cpu", seed=1)
    port.load_flat(params_from_flat(flat, device="cpu"))
    return jmodel, params, flat, port


@pytest.fixture(scope="module")
def engines(mixtral):
    """The JAX engine and the port's, f32, on the same weights."""
    jmodel, params, _, port = mixtral
    jax_engine = JaxEngine(model=jmodel, model_parameters=params,
                           config={**ENGINE, "dtype": jnp.float32})
    port_engine = InferenceEngineV2(port, {**ENGINE, "dtype": torch.float32},
                                    port.flat_params(), device="cpu")
    return jax_engine, port_engine


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, MIXTRAL["vocab_size"], n).astype(np.int32) for n in lengths]


def test_mixtral_dense_forward_matches_jax(mixtral):
    """The dense forward with dropless top-2 routing against the JAX
    model's, in f32; the flat tree carries the router and the [E, K, N]
    expert stacks both ways byte for byte."""
    jmodel, params, flat, port = mixtral
    ids = np.random.RandomState(2).randint(0, MIXTRAL["vocab_size"], (2, 19)).astype(np.int32)
    ref = jmodel.apply({"params": params}, jnp.asarray(ids), method="forward_logits")
    got = port.forward_logits(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    back = params_to_flat(port.flat_params())
    assert set(back) == set(flat)
    assert back["layers_1/block_sparse_moe/w_down"].shape == (4, 128, 64)
    assert all(back[k].tobytes() == flat[k].tobytes() for k in flat)


def test_capacity_dispatch_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="dispatch_mode='capacity'"):
        MixtralForCausalLM(MixtralConfig.tiny(dispatch_mode="capacity"), device="cpu")


def _moe_weights(seed, E=4, hid=64, ff=128):
    """One layer's router and expert stacks (numpy) whose routing sends
    every token to expert 0 first and none to expert 3: feature 0 of every
    row is 4, and the router's row 0 is +25 for expert 0, -25 for expert 3."""
    rng = np.random.RandomState(seed)
    w = {"router": rng.randn(hid, E).astype(np.float32) * 0.3,
         "w_gate": rng.randn(E, hid, ff).astype(np.float32) / 8,
         "w_up": rng.randn(E, hid, ff).astype(np.float32) / 8,
         "w_down": rng.randn(E, ff, hid).astype(np.float32) / 11}
    w["router"][0] = [25.0, 0.0, 0.0, -25.0]
    x = rng.randn(13, hid).astype(np.float32)
    x[:, 0] = 4.0
    return w, x


@pytest.mark.parametrize("quant", [False, True])
def test_moe_ffn_matches_jax_with_empty_and_full_experts(quant):
    """The port's ``_moe_ffn`` against the JAX engine's on the same rows
    (13 tokens, top-2 of 4 experts): expert 0 gets every token, expert 3
    none; f32 stacks, and int8 stacks quantized by each side's quantizer
    (byte-equal)."""
    w, x = _moe_weights(3)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    pw = {k: torch.from_numpy(v) for k, v in w.items()}
    if quant:
        for k in prm._QUANT_MLP_KEYS:
            jw[k] = jrm.quantize_weights_int8({"layers": {"moe": {k: jw[k]}}})["layers"]["moe"][k]
            pw[k] = prm.quantize_weight_int8(pw[k])
            for part in ("w8", "scale"):
                assert pw[k][part].numpy().tobytes() == np.asarray(jw[k][part]).tobytes()
            assert pw[k]["scale"].shape == (4, 1, pw[k]["w8"].shape[-1])
    ids = torch.topk(torch.from_numpy(x) @ pw["router"], 2, dim=-1).indices
    assert bool((ids[:, 0] == 0).all()) and not bool((ids == 3).any())
    ref = jrm._moe_ffn(jnp.asarray(x), jw, 2, jnp.float32)
    kernels.reset_launches()
    got = prm._moe_ffn(torch.from_numpy(x), pw, 2, torch.float32)
    assert all(n == 0 for n in kernels.LAUNCHES.values())   # the CPU runs plain versions
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_grouped_plain_matches_per_expert_products():
    """K8's grouped entry on CPU tensors (its plain version): each
    expert's rows through ``quantized_matmul_plain`` with that expert's
    weight and scale, bit for bit, empty experts included."""
    rng = np.random.RandomState(5)
    E, K, N = 5, 96, 48
    qd = prm.quantize_weight_int8(torch.from_numpy(rng.randn(E, K, N).astype(np.float32)))
    counts = [3, 0, 7, 0, 1]
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.from_numpy(rng.randn(sum(counts), K).astype(np.float32)).to(dtype)
        got = kernels.quantized_matmul_grouped(a, ends, qd["w8"], qd["scale"])
        assert got.dtype == dtype and got.shape == (11, N)
        start = 0
        for e, end in enumerate(ends.tolist()):
            want = kernels.quantized_matmul_plain(a[start:end], qd["w8"][e], qd["scale"][e])
            assert torch.equal(got[start:end], want)
            start = end
    with pytest.raises(ValueError, match="bad shapes"):
        kernels.quantized_matmul_grouped(a[:, :8], ends, qd["w8"], qd["scale"])


def test_engine_logits_and_greedy_streams_match_jax(engines):
    """put() logits (a prompt across two passes, then decode rows mixed
    with a new prompt) and greedy streams through generate(), as the JAX
    package's ``test_mixtral_moe_path``."""
    jax_engine, port_engine = engines
    base = port_engine.free_blocks
    prompts = _prompts(1, [40, 9, 23])
    ref = jax_engine.put([0, 1, 2], prompts)
    got = port_engine.put([0, 1, 2], prompts)
    np.testing.assert_allclose(got, ref, **TOL)
    step = [np.array([int(np.argmax(r))], np.int32) for r in ref[:2]]
    new = _prompts(2, [20])
    np.testing.assert_allclose(port_engine.put([0, 1, 3], step + new),
                               jax_engine.put([0, 1, 3], step + new), **TOL)
    for e in engines:
        e.flush([0, 1, 2, 3])
    prompts = _prompts(3, [30, 5, 17])
    ref = jax_engine.generate(prompts, max_new_tokens=6)
    got = port_engine.generate(prompts, max_new_tokens=6)
    assert [list(map(int, o)) for o in got] == [list(map(int, o)) for o in ref]
    assert port_engine.free_blocks == base and not port_engine.scheduler.seqs


def test_burst_streams_equal_per_step_streams(mixtral):
    """A ``decode_steps`` burst gives the greedy ids of per-step
    ``sample_next`` + ``put`` on a second engine (the JAX package's burst
    test, on the MoE layer)."""
    port = mixtral[3]
    e1, e2 = (InferenceEngineV2(port, {**ENGINE, "dtype": torch.float32}, port.flat_params(),
                                device="cpu") for _ in range(2))
    toks = _prompts(4, [11, 26])
    e1.put([1, 2], [t.copy() for t in toks])
    ids_ms = e1.decode_steps([1, 2], 6)
    e2.put([1, 2], [t.copy() for t in toks])
    step_ids = []
    for _ in range(6):
        nxt = e2.sample_next([1, 2])
        step_ids.append(nxt)
        e2.put([1, 2], [np.asarray([nxt[0]], np.int32), np.asarray([nxt[1]], np.int32)])
    assert np.array_equal(ids_ms, np.stack(step_ids, 1))


def test_int8_experts_match_jax_engine_bytes_and_streams(mixtral):
    """``weight_bits = 8``: the expert stacks are int8 with one scale per
    (expert, column), byte-equal to the JAX engine's; the router stays in
    the model dtype; greedy streams equal the JAX int8 engine's."""
    jmodel, params, _, port = mixtral
    qcfg = {**ENGINE, "quantization": {"weight_bits": 8}}
    port_q = InferenceEngineV2(port, {**qcfg, "dtype": torch.float32}, port.flat_params(),
                               device="cpu")
    jax_q = JaxEngine(model=jmodel, model_parameters=params,
                      config={**qcfg, "dtype": jnp.float32})
    jmoe = jax_q.weights["layers"]["moe"]
    for l, layer in enumerate(port_q.weights["layers"]):
        moe = layer["moe"]
        assert isinstance(moe["router"], torch.Tensor) and moe["router"].dtype == torch.float32
        for key in prm._QUANT_MLP_KEYS:
            assert moe[key]["w8"].dtype == torch.int8 and moe[key]["w8"].dim() == 3
            for part in ("w8", "scale"):
                assert moe[key][part].numpy().tobytes() == \
                    np.asarray(jmoe[key][part][l]).tobytes(), (l, key, part)
    prompts = _prompts(6, [21, 7])
    out_q = port_q.generate(prompts, max_new_tokens=4)
    ref_q = jax_q.generate(prompts, max_new_tokens=4)
    assert [list(map(int, o)) for o in out_q] == [list(map(int, o)) for o in ref_q]


# the JAX package's test_inference_v2.py: its prompts and engine config
JAX_PROMPTS = [[5, 7, 11, 13, 2, 9], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]]
JAX_V2_CONFIG = {"state_manager": {"max_tracked_sequences": 8, "max_ragged_sequence_count": 4,
                                   "max_ragged_batch_size": 12, "max_context": 64},
                 "kv_cache": {"block_size": 8, "num_blocks": 32}}


def test_int8_weights_quantize_moe_experts():
    """The JAX package's ``test_int8_weights_quantize_moe_experts`` on the
    port: its model (``MixtralConfig.tiny``, f32, flax's init at
    ``PRNGKey(0)``) and prompts; ``weight_bits = 8`` makes the expert
    stacks int8 and the greedy streams equal the f32 engine's."""
    jmodel = JaxMixtral(JaxMixtralConfig.tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0),
                         {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    port = MixtralForCausalLM(MixtralConfig.tiny(), device="cpu", seed=1)
    port.load_flat(params_from_flat(flatten_tree(params), device="cpu"))
    engine = {**JAX_V2_CONFIG, "dtype": torch.float32}
    e_f32 = InferenceEngineV2(port, engine, port.flat_params(), device="cpu")
    e_q = InferenceEngineV2(port, {**engine, "quantization": {"weight_bits": 8}},
                            port.flat_params(), device="cpu")
    for key in prm._QUANT_MLP_KEYS:
        assert all(layer["moe"][key]["w8"].dtype == torch.int8
                   for layer in e_q.weights["layers"])
    prompts = [np.asarray(p, np.int32) for p in JAX_PROMPTS]
    out_f32 = e_f32.generate(prompts, max_new_tokens=4)
    out_q = e_q.generate(prompts, max_new_tokens=4)
    assert [list(map(int, o)) for o in out_q] == [list(map(int, o)) for o in out_f32]


def _quant_models():
    """One tiny model of each lineage the landing quantizes: (family, the
    port's model, weight bits, quantized leaves expected)."""
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    return {
        "mixtral": (MixtralForCausalLM(MixtralConfig.tiny(**MIXTRAL), device="cpu", seed=3),
                    8, 2 * (4 + 3) + 1),
        "qwen2": (LlamaForCausalLM(LlamaConfig.tiny(qkv_bias=True), device="cpu", seed=3),
                  4, 2 * 7 + 1),
        "gpt2": (GPT2LMHead(GPT2Config.tiny(), device="cpu"), 8, None),
        "gptj": (DecoderLM(DecoderConfig.tiny("gptj"), device="cpu", seed=3), 4, None),
    }


@pytest.mark.parametrize("family", ["mixtral", "qwen2", "gpt2", "gptj"])
def test_quantize_as_built_bytes_equal_build_then_quantize(family):
    """Every lineage quantizes each projection, expert stack and untied
    head as it lands (GPT-2's fused qkv before it is cut into columns); the
    bytes equal quantizing the whole f32 tree after the build, int8 or
    packed int4."""
    port, bits, n_expected = _quant_models()[family]
    built = InferenceEngineV2(port, {**ENGINE, "dtype": torch.float32}, port.flat_params(),
                              family=family, device="cpu")
    after = {8: prm.quantize_weights_int8, 4: prm.quantize_weights_int4}[bits](
        copy.deepcopy(built.weights))
    landed = InferenceEngineV2(port, {**ENGINE, "dtype": torch.float32,
                                      "quantization": {"weight_bits": bits}},
                               port.flat_params(), family=family, device="cpu").weights

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    a, b = dict(leaves(after)), dict(leaves(landed))
    assert set(a) == set(b)
    packed = "w8" if bits == 8 else "w4"
    n = sum(1 for p in a if p[-1] == packed)
    assert n > 0 and (n_expected is None or n == n_expected)
    for path, t in a.items():
        assert t.dtype == b[path].dtype and t.shape == b[path].shape, path
        assert t.numpy().tobytes() == b[path].numpy().tobytes(), path


class _Unreadable(dict):
    """A flat tree whose every read fails the test: a refusal must come
    before any tensor lands."""

    def __getitem__(self, name):
        raise AssertionError(f"{name} was read before the refusal")


def test_moe_refusals_name_the_feature(mixtral):
    """MoE with packed int4 weights (the JAX engine packs the expert stacks
    and then fails in its ``_moe_ffn``) and MoE with ``tensor_parallel >
    1`` are refused by name; MoE alone validates."""
    spec = prm.RaggedModelSpec(family="mixtral", num_layers=1, hidden_size=64, num_heads=4,
                               num_kv_heads=2, head_dim=16, vocab_size=16,
                               moe={"num_experts": 4, "top_k": 2})
    AttentionKernelSpec.validate_engine_build(spec, RaggedInferenceEngineConfig.load({}))
    AttentionKernelSpec.validate_engine_build(spec, RaggedInferenceEngineConfig.load(
        {"quantization": {"weight_bits": 8}}))
    with pytest.raises(NotImplementedError, match="MoE with quantization.weight_bits = 4"):
        AttentionKernelSpec.validate_engine_build(spec, RaggedInferenceEngineConfig.load(
            {"quantization": {"weight_bits": 4}}))
    cfg = RaggedInferenceEngineConfig.load({})
    cfg.tensor_parallel = 2
    with pytest.raises(NotImplementedError, match="MoE with tensor_parallel > 1"):
        AttentionKernelSpec.validate_engine_build(spec, cfg)
    port = mixtral[3]
    with pytest.raises(NotImplementedError, match="weight_bits = 4"):
        InferenceEngineV2(port, {**ENGINE, "dtype": torch.float32,
                                 "quantization": {"weight_bits": 4}},
                          _Unreadable(port.flat_params()), device="cpu")
