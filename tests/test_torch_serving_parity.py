"""The port's serving frontend against the JAX package's, on the same tiny
Llama weights (fp32 on the CPU; every leaf from numpy at the shapes of
``jax.eval_shape``, moved across with ``checkpoint.params_from_flat``).

The same seeded Poisson arrivals go through both frontends, driven by
``step()`` (arrival i is submitted before the first step at or past its
time, in steps of ``DT`` seconds of the schedule, not of the wall clock),
with SLOs no request can miss, so nothing is shed and no plan reads a
clock. The pool is small enough that preemption by offload fires.

Tolerances: each greedy stream of the port equals the JAX frontend's for
the same request, or parts from it only where the JAX engine's top-2
logits lie under 1e-4 apart; the clock-free counts (admitted, preempted,
restored, finished) are equal. A disaggregated handoff's payload has the
JAX engine's page layout and dtype; the JAX engine's ``export_kv`` pages
import into the port's decode engine byte for byte. The pages the port
itself computes for the same sequence agree with the JAX engine's to 1e-5
(XLA and torch round fp32 differently, so they are not bit-equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2.serving import PoissonLoadGen as JaxLoadGen
from deepspeed_tpu.inference.v2.serving import WorkloadComponent as JaxComponent
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.serving import PoissonLoadGen, WorkloadComponent
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

from tests._torch_threads import one_torch_thread  # noqa: F401

LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
_CLASSES = [{"name": "hi", "priority": 2, "ttft_slo_ms": 1e9, "tbt_slo_ms": 1e9},
            {"name": "lo", "priority": 0, "ttft_slo_ms": 1e9, "tbt_slo_ms": 1e9}]
ENGINE = {"state_manager": {"max_tracked_sequences": 8, "max_ragged_sequence_count": 4,
                            "max_ragged_batch_size": 96, "max_context": 176,
                            "prefill_chunk_size": 32},
          "kv_cache": {"block_size": 16, "num_blocks": 12},
          "serving": {"decode_slice": 4, "idle_wait_s": 0.005, "classes": _CLASSES}}
MIX = [("hi", 2.0, [8, 16, 24], [4, 8], 0), ("lo", 2.0, [24, 40], [24, 32], 0),
       ("hi", 1.0, [96], [8], 0)]
RATE, N, DT = 20.0, 12, 0.02
TIE = 1e-4


def _params(seed=0):
    """The tiny Llama's flax tree and flat numpy tree (shapes from
    ``jax.eval_shape``)."""
    model = JaxLlama(JaxLlamaConfig(dtype=jnp.float32, **LLAMA))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        flat[k] = (1.0 + 0.1 * noise if k.endswith("weight")
                   else noise / np.float32(np.sqrt(v.shape[-1 if "embedding" in k else 0])))
    tree = {}
    for k, a in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return tree, flat


@pytest.fixture(scope="module")
def weights():
    params, flat = _params()
    port_model = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu", seed=1)
    port_model.load_flat(params_from_flat(flat, device="cpu"))
    return params, port_model


def _engines(weights, **extra):
    params, port_model = weights
    jax_engine = JaxEngine(model=JaxLlama(JaxLlamaConfig(dtype=jnp.float32, **LLAMA)),
                           model_parameters=params,
                           config={**ENGINE, **extra, "dtype": jnp.float32})
    port = InferenceEngineV2(port_model, {**ENGINE, **extra, "dtype": torch.float32},
                             port_model.flat_params(), device="cpu")
    return jax_engine, port


def _drive(fe, arrivals):
    """Submit each arrival before the first step at or past its time; step
    until every stream is done."""
    hs, i, k = [], 0, 0
    while i < len(arrivals) or not all(h.finished for h in hs):
        while i < len(arrivals) and arrivals[i].t <= k * DT:
            a = arrivals[i]
            hs.append(fe.submit(a.prompt, priority=a.cls, max_new_tokens=a.max_new_tokens))
            i += 1
        fe.step()
        k += 1
        assert k < 3000, "the frontend stopped making progress"
    return hs


def _counts(fe):
    st = fe.stats
    return {"admitted": {c: n.admitted for c, n in st.classes.items()},
            "finished": {c: n.completed for c, n in st.classes.items()},
            "shed": {c: n.shed for c, n in st.classes.items()},
            "preempted": st.preemptions, "restored": st.restores,
            "recompute": st.recompute_preemptions}


def _top2_gap(jax_engine, tokens) -> float:
    """The JAX engine's top-2 logit gap after ``tokens``."""
    uid = 77_000 + _top2_gap.k
    _top2_gap.k += 1
    logits = np.asarray(jax_engine.put([uid], [np.asarray(tokens, np.int32)])[0], np.float64)
    jax_engine.flush([uid])
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


_top2_gap.k = 0


def test_frontend_streams_and_counts_match_jax(weights):
    mix = [WorkloadComponent(*m) for m in MIX]
    arrivals = PoissonLoadGen(RATE, mix, vocab=128, seed=0).arrivals(n=N)
    jax_arrivals = JaxLoadGen(RATE, [JaxComponent(*m) for m in MIX], vocab=128,
                              seed=0).arrivals(n=N)
    # the copied load generator draws the JAX package's arrivals
    assert [(a.t, a.cls, a.max_new_tokens) for a in arrivals] == \
        [(a.t, a.cls, a.max_new_tokens) for a in jax_arrivals]
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(arrivals, jax_arrivals))
    jax_engine, port = _engines(weights)
    jfe, pfe = jax_engine.serving_frontend(), port.serving_frontend()
    jhs, phs = _drive(jfe, jax_arrivals), _drive(pfe, arrivals)
    assert [h.status for h in phs] == [h.status for h in jhs] == ["finished"] * N
    counts = _counts(pfe)
    assert counts == _counts(jfe)
    assert counts["preempted"] >= 1 and counts["restored"] >= 1
    assert sum(counts["shed"].values()) == 0
    for a, jh, ph in zip(arrivals, jhs, phs):
        assert len(ph.tokens) == len(jh.tokens) == a.max_new_tokens
        if ph.tokens == jh.tokens:
            continue
        k = next(i for i, (x, y) in enumerate(zip(ph.tokens, jh.tokens)) if x != y)
        gap = _top2_gap(jax_engine, np.concatenate([a.prompt, jh.tokens[:k]]))
        assert gap < TIE, (f"request {ph.uid} parts from the JAX stream at token {k} "
                           f"where the top-2 gap is {gap:.3g}")
    jfe.close()
    pfe.close()
    assert port.free_blocks == port.allocator.total_blocks
    assert pfe.offload.bytes_held == 0 and pfe.offload.pool.outstanding == 0


@pytest.mark.parametrize("n", [24, 40], ids=["partial-page", "three-pages"])
def test_handoff_pages_match_jax_export(weights, n):
    """A disaggregated handoff's payload: the port's ``export_kv`` of a
    prefilled sequence has the JAX engine's page layout and dtype and its
    values (XLA and torch round fp32 differently: 2.8e-06 apart at most
    here, so the computed pages are held at 1e-05, not bit for bit); the
    JAX engine's payload imports into the port's decode engine byte for
    byte, and the port decodes from it the JAX engine's continuation."""
    jax_engine, port = _engines(weights)
    _, receiver = _engines(weights)
    prompt = np.random.RandomState(n).randint(0, 128, n).astype(np.int32)
    jax_engine.put([5], [prompt])
    port._put_nofetch([5], [prompt])
    jpages, jlogits = (np.asarray(x) for x in jax_engine.export_kv(5))
    ppages, plogits = port.export_kv(5)
    assert ppages.shape == jpages.shape and ppages.dtype == jpages.dtype
    np.testing.assert_allclose(ppages, jpages, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plogits, jlogits, rtol=0, atol=1e-5)
    ids = receiver.import_kv(5, prompt, jpages, jlogits)
    assert np.array_equal(receiver.fetch_pages(ids).view(np.uint8),
                          np.ascontiguousarray(jpages).view(np.uint8))
    assert np.array_equal(receiver._last_logits[5], jlogits)
    ids = jax_engine.import_kv(6, prompt, jpages, jlogits)
    want = [int(t) for t in np.asarray(jax_engine.decode_pipeline([6]).run(8))[0]]
    got = [int(t) for t in receiver.decode_pipeline([5]).run(8)[0]]
    if got != want:
        k = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
        assert _top2_gap(jax_engine, np.concatenate([prompt, want[:k]])) < TIE
