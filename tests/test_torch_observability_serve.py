"""The serving side of the port's timeline: the counters equal the spans.
The decode pipeline's five stamps a step feed both ``pipeline_stats`` and
the ``serve/decode/*`` spans, its drain records ``serve/drain/fetch_to_host``,
the split ladder's choice ``serve/attn/select`` (counted in
``attn_stats``), speculative decoding ``serve/spec/*`` (``spec_stats``) and
the LoRA registry ``serve/lora/{fault,swap}`` (``LoraStats``); tracing
changes no token, and the exported traces pass ``scripts/trace_check.py``
unchanged. Against the JAX package: a traced tiny decode run records the
same set of span names on the same lanes, and ``write_monitor_events``
emits the JAX package's ``inference/v2/pipeline/*`` fields."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint.state import flatten_tree
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.monitor.trace import tracer as jax_tracer
from deepspeed_tpu_torch.checkpoint import params_from_flat
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.serving import ServingCluster
from deepspeed_tpu_torch.inference.v2.serving.health import HealthMonitor
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.module_inject import load_lora_adapter
from deepspeed_tpu_torch.monitor.trace import tracer
from deepspeed_tpu_torch.utils.caching import next_pow2

from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(vocab_size=128, hidden_size=128, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=256)
STATE = {"max_tracked_sequences": 6, "max_ragged_sequence_count": 4,
         "max_ragged_batch_size": 40, "prefill_chunk_size": 16, "max_context": 128}
POOL = {"kv_cache": {"block_size": 16, "num_blocks": 48}}
LADDER = {"attention": {"decode_splits": 2, "min_ctx_per_split": 16}}
PROMPTS = [np.array([3, 14, 15, 92, 6, 53, 58, 97, 93, 23, 84, 62], np.int32),
           np.array([27, 18, 28, 18, 28, 45, 90, 45, 23], np.int32),
           np.array([31, 41, 59, 26, 53, 58, 97, 93, 23, 84, 62, 64, 33, 83, 27, 95, 2], np.int32)]
LOOP = np.tile(np.array([7, 1, 88, 3, 41, 9], np.int32), 4)
PIPELINE_FIELDS = ("dispatch_ms_per_step", "host_build_ms_per_step", "fetch_drain_ms_per_step",
                   "bubble_ms_per_step", "fetch_bytes_per_step", "steps", "tokens")


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracer.reset()
    yield
    tracer.reset()


@pytest.fixture(scope="module")
def weights():
    jax_model = JaxLlama(JaxLlamaConfig(dtype=jnp.float32, **LLAMA))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            {"input_ids": jnp.zeros((1, 8), jnp.int32)})["params"]
    rng = np.random.RandomState(0)
    flat = {}
    for k, v in sorted(flatten_tree(shapes).items()):
        noise = rng.randn(*v.shape).astype(np.float32)
        flat[k] = (1.0 + 0.1 * noise if k.endswith("weight")
                   else noise / np.float32(np.sqrt(v.shape[-1 if "embedding" in k else 0])))
    port = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu", seed=1)
    port.load_flat(params_from_flat(flat, device="cpu"))
    return jax_model, flat, port


def _conf(**extra):
    return {"state_manager": STATE, **POOL, **extra}


def _port(model, **extra):
    return InferenceEngineV2(model, {**_conf(**extra), "dtype": torch.float32},
                             model.flat_params(), device="cpu")


class _Capture:
    def __init__(self):
        self.events = []

    def write_events(self, events):
        self.events.extend(events)


def _trace_check(path, *args):
    r = subprocess.run([sys.executable, "scripts/trace_check.py", str(path), *args],
                       capture_output=True, text=True, cwd=ROOT, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr


def test_pipeline_stats_and_monitor_fields(weights):
    e = _port(weights[2])
    e.put([0, 1], PROMPTS[:2])
    e.pipeline_stats.reset()
    e.decode_pipeline([0, 1]).run(5)
    st = e.pipeline_stats
    assert st.steps == 5 and st.tokens == 10
    # one int32 token row a bucket slot crosses a step
    assert st.fetch_bytes_per_step == 4.0 * next_pow2(2)
    assert st.last_fetch_bytes == 4 * next_pow2(2)
    assert len(st.step_wall_ms) == 5 and all(w > 0 for w in st.step_wall_ms)
    mon = _Capture()
    e.write_monitor_events(mon, step=3)
    names = {n for n, _, _ in mon.events}
    for field in PIPELINE_FIELDS:
        assert f"inference/v2/pipeline/{field}" in names
    assert all(s == 3 for _, _, s in mon.events)
    e.flush([0, 1])


def test_traced_decode_byte_identical_with_spans_equal_to_stats(weights, tmp_path):
    """Tracing changes no token; serve/decode/step counts the stats' steps,
    the phase spans sum to the stats' ms, the split ladder records one
    select a step (and one a prefill pass), and the trace passes
    trace_check with serve/decode, serve/drain and serve/attn tracks."""
    N = 6
    e = _port(weights[2], **LADDER)
    uids = [0, 1, 2]
    e.put(uids, PROMPTS)
    ref = e.decode_pipeline(uids).run(N)
    e.flush(uids)
    tracer.configure(trace_dir=str(tmp_path), enabled=True, ring_size=2048)
    e.put(uids, PROMPTS)
    e.pipeline_stats.reset()
    e.attn_stats.reset()
    calls = []
    got = e.decode_pipeline(uids).run(N, on_tokens=lambda j, u, row: calls.append(j))
    assert np.array_equal(got, ref) and calls == list(range(N))
    summary = tracer.summary()
    st = e.pipeline_stats
    assert summary["serve/decode/step"][0] == st.steps == N
    assert summary["serve/decode/dispatch"][0] == summary["serve/decode/callback"][0] == N
    assert summary["serve/drain/fetch_to_host"][0] >= N
    for phase, field in (("dispatch", "dispatch_ms"), ("drain", "fetch_drain_ms")):
        assert 1e3 * summary[f"serve/decode/{phase}"][1] == \
            pytest.approx(getattr(st, field), abs=1e-3 * N)
    assert summary["serve/attn/select"][0] == e.attn_stats.selects >= N
    mon = _Capture()
    e.write_monitor_events(mon, step=1)
    assert {n for n, _, _ in mon.events} >= {"serve/attn/selects", "serve/attn/merged_steps"}
    e.flush(uids)
    path = tracer.export()
    assert path is not None
    _trace_check(tmp_path, "--require", "serve/decode", "serve/drain", "serve/attn")


def test_attn_stats_counters(weights):
    e = _port(weights[2], **LADDER)
    e.attn_stats.reset()
    prompt = np.arange(3, 43, dtype=np.int32)     # 40 tokens: past 2 x 16 -> rung 2
    e.put([0], [prompt])
    e.decode_pipeline([0]).run(6)
    e.flush([0])
    s = e.attn_stats
    assert s.selects > 0 and s.splits >= s.selects
    assert s.merged_steps > 0 and s.max_live_ctx >= len(prompt)
    assert s.rungs[2] == s.merged_steps
    ev = {name: (st, val) for name, val, st in s.events(step=7)}
    assert ev["serve/attn/selects"] == (7, float(s.selects))
    assert set(ev) == {"serve/attn/selects", "serve/attn/splits_per_select",
                       "serve/attn/merged_steps", "serve/attn/max_live_ctx",
                       "serve/attn/select_ms_per_step"}


def test_spec_stats_and_spans(weights):
    e = _port(weights[2], spec_decode={"enabled": True, "k": 3})
    tracer.configure(enabled=True, ring_size=2048)
    e.put([0, 1], [PROMPTS[0], LOOP])
    e.spec_stats.reset()
    got = e.decode_pipeline([0, 1]).run(6)
    st = e.spec_stats
    assert st.steps == 6 and st.tokens >= 12 and st.fetch_bytes > 0 and st.verify_ms > 0
    assert all(len(g) >= 6 for g in got)
    summary = tracer.summary()
    assert summary["serve/spec/step"][0] == st.steps == 6
    assert summary["serve/spec/draft"][0] == 6
    assert 1e3 * summary["serve/spec/draft"][1] == pytest.approx(st.draft_ms, abs=1e-3 * 6)
    assert "serve/spec/drain" in summary and "serve/drain/fetch_to_host" in summary
    e.flush([0, 1])



def test_spec_pipeline_leaves_decode_pipeline_stats_alone(weights):
    """The speculative pipeline records into ``spec_stats`` only, as the JAX
    package's does: the decode pipeline's counters, step walls and
    ``inference/v2/pipeline/*`` events are unchanged by a spec run, and the
    health heartbeat still sees the spec steps as progress."""
    e = _port(weights[2], spec_decode={"enabled": True, "k": 3})
    e.put([0, 1], [PROMPTS[0], LOOP])
    replica = SimpleNamespace(role="serve", engine=e, frontend=SimpleNamespace(_inflight=1))
    before, busy = HealthMonitor._progress(None, replica)
    e.decode_pipeline([0, 1]).run(6)
    assert e.spec_stats.steps == 6
    st = e.pipeline_stats
    assert (st.steps, st.tokens, st.step_wall_ms, st.fetch_bytes) == (0, 0, [], 0)
    assert st.dispatch_ms == st.fetch_drain_ms == st.host_build_ms == st.bubble_ms == 0.0
    mon = _Capture()
    e.write_monitor_events(mon, step=1)
    names = {n for n, _, _ in mon.events}
    assert "serve/spec/steps" in names
    assert not any(n.startswith("inference/v2/pipeline/") for n in names)
    after, _ = HealthMonitor._progress(None, replica)
    assert busy and after != before
    e.flush([0, 1])


def test_cluster_labels_attn_events_per_replica(weights):
    """Two replicas' split-ladder events fanned into one monitor stay apart:
    the cluster labels ``attn_stats`` as it labels the spec and frontend
    stats."""
    e0, e1 = _port(weights[2], **LADDER), _port(weights[2], **LADDER)
    ServingCluster([e0, e1])
    assert (e0.attn_stats.replica, e1.attn_stats.replica) == ("r0", "r1")
    mon = _Capture()
    for e in (e0, e1):
        e.put([0], PROMPTS[:1])
        e.decode_pipeline([0]).run(3)
        e.flush([0])
        e.write_monitor_events(mon, step=1)
    attn = [n for n, _, _ in mon.events if n.startswith("serve/attn")]
    r0 = {n for n in attn if n.startswith("serve/attn/r0/")}
    r1 = {n for n in attn if n.startswith("serve/attn/r1/")}
    assert r0 and len(r0) == len(r1) and len(attn) == len(r0) + len(r1)
    assert {n.replace("/r0/", "/") for n in r0} == {n.replace("/r1/", "/") for n in r1}
    e0.attn_stats.reset()
    assert e0.attn_stats.replica == "r0"        # reset never drops the label

def _adapter(spec, rank, seed):
    g = np.random.RandomState(seed)
    dq, dv = spec.num_heads * spec.head_dim, spec.num_kv_heads * spec.head_dim
    return {"alpha": float(rank),
            "q": {"A": (g.standard_normal((spec.hidden_size, rank)) * 0.2).astype(np.float32),
                  "B": (g.standard_normal((rank, dq)) * 0.2).astype(np.float32)},
            "v": {"A": (g.standard_normal((spec.hidden_size, rank)) * 0.2).astype(np.float32),
                  "B": (g.standard_normal((rank, dv)) * 0.2).astype(np.float32)}}


def test_lora_spans_match_lora_stats(weights):
    """A pool of 4 pages and two rank-3 adapters: serving one after the
    other faults each in and evicts the first; the spans count what the
    stats count."""
    e = _port(weights[2], lora={"enabled": True, "targets": ["q", "v"], "max_rank": 4,
                                "pool_pages": 4, "swap_buffers": 8})
    load_lora_adapter(e, "a", _adapter(e.spec, 3, 1))
    load_lora_adapter(e, "b", _adapter(e.spec, 3, 2))
    tracer.configure(enabled=True)
    for uid, name in ((0, "a"), (1, "b"), (2, "a")):
        e.lora.acquire(uid, name)
        e.put([uid], [PROMPTS[0]])
        e.decode_pipeline([uid]).run(2)
        e.flush([uid])
        e.lora.release(uid)
    summary = tracer.summary()
    faults = sum(a.faults for a in e.lora.stats.adapters.values())
    evictions = sum(a.evictions for a in e.lora.stats.adapters.values())
    assert faults == summary["serve/lora/fault"][0] == 3
    assert evictions == summary["serve/lora/swap"][0] >= 2
    lanes = {r[4] for r in tracer.iter_records() if r[1].startswith("serve/lora/")}
    assert lanes == {"serve/lora"}


def _span_lanes(records):
    return {(r[1], r[4]) for r in records if r[3] is not None}


def test_span_names_and_lanes_match_jax_engine(weights):
    """The same config (split ladder on) and prompts traced through both
    engines' put + decode pipeline: the same set of (span name, lane)."""
    jax_model, flat, port = weights
    tree = {}
    for k, a in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    uids = [0, 1]
    jax_tracer.reset()
    try:
        jeng = JaxEngine(model=jax_model, model_parameters=tree,
                         config={**_conf(**LADDER), "dtype": jnp.float32})
        jax_tracer.configure(enabled=True)
        jeng.put(uids, PROMPTS[:2])
        jeng.decode_pipeline(uids).run(4)
        jax_spans = _span_lanes(jax_tracer.iter_records())
    finally:
        jax_tracer.reset()
    e = _port(port, **LADDER)
    tracer.configure(enabled=True)
    e.put(uids, PROMPTS[:2])
    e.decode_pipeline(uids).run(4)
    port_spans = _span_lanes(tracer.iter_records())
    assert ("serve/decode/step", "serve/decode") in port_spans
    assert ("serve/attn/select", "serve/attn") in port_spans
    assert port_spans == jax_spans
