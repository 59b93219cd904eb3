"""Package-level contracts of the PyTorch/CUDA port (deepspeed_tpu_torch):
no JAX anywhere in it, the card by default, plain versions only for CPU
tensors, and a named refusal for every feature the port does not carry."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.checkpoint.state import flatten_tree, unflatten_into
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.ragged_model import RaggedModelSpec
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.kernels.paged_splitk import merge_splitk_partials, splitk_merge

from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "deepspeed_tpu"}


def test_import_loads_no_jax():
    code = ("import deepspeed_tpu_torch, sys; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


WINDOW_MODULES = (
    "deepspeed_tpu_torch.inference.v2.scheduler", "deepspeed_tpu_torch.inference.v2.attention",
    "deepspeed_tpu_torch.inference.v2.ragged_model",
    "deepspeed_tpu_torch.inference.v2.engine_v2", "deepspeed_tpu_torch.models.llama",
    "deepspeed_tpu_torch.ops.kernels.flash_packed", "deepspeed_tpu_torch.ops.kernels.paged_chunk",
    "deepspeed_tpu_torch.ops.kernels.paged_decode",
    "deepspeed_tpu_torch.ops.kernels.paged_splitk")


def test_window_serving_modules_import_without_jax():
    """The modules the sliding window touches, each imported by its own
    name in a fresh interpreter, load no JAX."""
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {WINDOW_MODULES!r}]; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


ALIBI_MODULES = ("deepspeed_tpu_torch.models.decoder",
                 "deepspeed_tpu_torch.ops.kernels.alibi")


def test_alibi_serving_modules_import_without_jax():
    """The generic decoder and the slope module, each imported by its own
    name in a fresh interpreter, load no JAX."""
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {ALIBI_MODULES!r}]; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


@pytest.mark.parametrize("module, names", [
    ("deepspeed_tpu_torch", ("DecoderConfig", "DecoderLM")),
    ("deepspeed_tpu_torch.models", ("DecoderConfig", "DecoderLM", "alibi_bias",
                                    "alibi_slopes")),
    ("deepspeed_tpu_torch.inference.v2", ("ADAPTERS", "RaggedModelSpec", "adapt_model")),
    ("deepspeed_tpu_torch.ops.kernels", ("alibi_slope", "alibi_slopes")),
])
def test_alibi_slice_exports(module, names):
    import importlib
    mod = importlib.import_module(module)
    assert all(hasattr(mod, n) for n in names), [n for n in names if not hasattr(mod, n)]


BURST_MODULES = ("deepspeed_tpu_torch.inference.v2.engine_v2",
                 "deepspeed_tpu_torch.inference.v2.ragged_model",
                 "deepspeed_tpu_torch.inference.v2.scheduler",
                 "deepspeed_tpu_torch.inference.v2.ragged.kv_cache",
                 "deepspeed_tpu_torch.inference.v2.ragged.ragged_batch")
BURST_ENTRY_POINTS = ("decode_steps", "sample_next", "fetch_pages", "put_pages",
                      "fetch_page", "put_page", "export_kv", "import_kv")


def test_burst_and_page_fabric_modules_import_without_jax():
    """The modules that hold decode_steps, sample_next and the page movers,
    each imported by its own name in a fresh interpreter, load no JAX."""
    code = ("import importlib, sys; "
            f"mods = [importlib.import_module(m) for m in {BURST_MODULES!r}]; "
            "e = mods[0].InferenceEngineV2; "
            f"assert all(callable(getattr(e, n)) for n in {BURST_ENTRY_POINTS!r}); "
            "assert isinstance(e.page_payload_spec, property); "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


LORA_MODULES = ("deepspeed_tpu_torch.inference.v2.lora",
                "deepspeed_tpu_torch.inference.v2.lora.pool",
                "deepspeed_tpu_torch.inference.v2.lora.registry",
                "deepspeed_tpu_torch.module_inject", "deepspeed_tpu_torch.module_inject.lora",
                "deepspeed_tpu_torch.runtime.swap_tensor",
                "deepspeed_tpu_torch.runtime.swap_tensor.buffer_pool",
                "deepspeed_tpu_torch.utils.fault_injection")


def test_lora_modules_import_without_jax():
    """The multi-tenant LoRA modules, each imported by its own name in a
    fresh interpreter, load no JAX and nothing of the JAX package."""
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {LORA_MODULES!r}]; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


CHECKPOINT_MODULES = ("deepspeed_tpu_torch.checkpoint",
                      "deepspeed_tpu_torch.checkpoint.state",
                      "deepspeed_tpu_torch.checkpoint.engine",
                      "deepspeed_tpu_torch.checkpoint.rolling",
                      "deepspeed_tpu_torch.checkpoint.sharded",
                      "deepspeed_tpu_torch.checkpoint.universal",
                      "deepspeed_tpu_torch.monitor", "deepspeed_tpu_torch.monitor.training",
                      "deepspeed_tpu_torch.utils.logging",
                      "deepspeed_tpu_torch.utils.threads",
                      "deepspeed_tpu_torch.utils.resilience",
                      "deepspeed_tpu_torch.utils.zero_to_fp32")


def test_checkpoint_modules_import_without_jax():
    """The checkpoint slice's modules, each imported by its own name in a
    fresh interpreter, load no JAX and nothing of the JAX package."""
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {CHECKPOINT_MODULES!r}]; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


OFFLOAD_MODULES = ("deepspeed_tpu_torch.ops.native", "deepspeed_tpu_torch.ops.native.builder",
                   "deepspeed_tpu_torch.ops.native.cpu_optimizer",
                   "deepspeed_tpu_torch.ops.native.aio",
                   "deepspeed_tpu_torch.runtime.swap_tensor",
                   "deepspeed_tpu_torch.runtime.swap_tensor.optimizer_swapper",
                   "deepspeed_tpu_torch.runtime.zero", "deepspeed_tpu_torch.runtime.zero.offload",
                   "deepspeed_tpu_torch.runtime.activation_checkpointing",
                   "deepspeed_tpu_torch.runtime.engine")


def test_offload_modules_import_without_jax():
    """The offload tier's modules, each imported by its own name in a fresh
    interpreter, load no JAX and nothing of the JAX package, and build
    nothing at import: the native library is built at first use."""
    code = ("import importlib, sys; "
            f"mods = [importlib.import_module(m) for m in {OFFLOAD_MODULES!r}]; "
            "assert mods[1]._lib is None; "
            "assert hasattr(mods[7], 'HostOffloadOptimizer'); "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


ROLLOUT_MODULES = ("deepspeed_tpu_torch.runtime.colocated",
                   "deepspeed_tpu_torch.runtime.hybrid_engine",
                   "deepspeed_tpu_torch.inference.config", "deepspeed_tpu_torch.inference.engine",
                   "deepspeed_tpu_torch.utils.timer", "deepspeed_tpu_torch.monitor.training")


def test_rollout_modules_import_without_jax():
    """The colocated rollout's and the hybrid engine's modules, each
    imported by its own name in a fresh interpreter, load no JAX and
    nothing of the JAX package, and the entry points are where a user
    looks for them."""
    code = ("import importlib, sys; "
            f"mods = [importlib.import_module(m) for m in {ROLLOUT_MODULES!r}]; "
            "assert hasattr(mods[0], 'WeightBridge') and hasattr(mods[0], 'RolloutLoop'); "
            "assert hasattr(mods[1], 'DeepSpeedHybridEngine'); "
            "assert hasattr(mods[5], 'RolloutStats'); "
            "import deepspeed_tpu_torch; assert callable(deepspeed_tpu_torch.init_inference); "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


TRAINING_MODULES = ("deepspeed_tpu_torch.ops.lamb", "deepspeed_tpu_torch.ops.lion",
                    "deepspeed_tpu_torch.ops.adagrad", "deepspeed_tpu_torch.ops.sgd",
                    "deepspeed_tpu_torch.runtime.activation_checkpointing",
                    "deepspeed_tpu_torch.runtime.progressive_layer_drop",
                    "deepspeed_tpu_torch.runtime.dataloader",
                    "deepspeed_tpu_torch.runtime.data_pipeline",
                    "deepspeed_tpu_torch.data", "deepspeed_tpu_torch.data.indexed_dataset",
                    "deepspeed_tpu_torch.data.data_sampler",
                    "deepspeed_tpu_torch.data.curriculum_scheduler",
                    "deepspeed_tpu_torch.runtime.engine", "deepspeed_tpu_torch.models.llama")


def test_training_modules_import_without_jax():
    """The modules of one-device training (optimizers, activation
    checkpointing, layer drop, the data pipeline), each imported by its own
    name in a fresh interpreter, load no JAX and nothing of the JAX
    package."""
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {TRAINING_MODULES!r}]; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


SERVING_MODULES = ("deepspeed_tpu_torch.inference.v2.serving",
                   "deepspeed_tpu_torch.inference.v2.serving.admission",
                   "deepspeed_tpu_torch.inference.v2.serving.kv_offload",
                   "deepspeed_tpu_torch.inference.v2.serving.frontend",
                   "deepspeed_tpu_torch.inference.v2.serving.loadgen",
                   "deepspeed_tpu_torch.inference.v2.serving.cluster",
                   "deepspeed_tpu_torch.inference.v2.serving.health",
                   "deepspeed_tpu_torch.inference.v2.serving.router",
                   "deepspeed_tpu_torch.monitor.trace", "deepspeed_tpu_torch.monitor.serving")


def test_serving_modules_import_without_jax():
    """The serving frontend and cluster modules, the tracer and the serving
    counters, each imported by its own name in a fresh interpreter, load no
    JAX and nothing of the JAX package."""
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {SERVING_MODULES!r}]; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


OBSERVABILITY_MODULES = ("deepspeed_tpu_torch.monitor", "deepspeed_tpu_torch.monitor.monitor",
                         "deepspeed_tpu_torch.monitor.export",
                         "deepspeed_tpu_torch.profiling",
                         "deepspeed_tpu_torch.profiling.flops_profiler",
                         "deepspeed_tpu_torch.utils.locksan", "deepspeed_tpu_torch.utils.threads",
                         "deepspeed_tpu_torch.utils.timer",
                         "deepspeed_tpu_torch.utils.fault_injection",
                         "deepspeed_tpu_torch.elasticity",
                         "deepspeed_tpu_torch.elasticity.elasticity",
                         "deepspeed_tpu_torch.elasticity.elastic_agent",
                         "deepspeed_tpu_torch.elasticity.cli")


def test_observability_modules_import_without_jax():
    """The monitor sinks and exporter, the flops profiler, the lock-order
    sanitizer, the timers and the elastic agent, each imported by its own
    name in a fresh interpreter, load no JAX and nothing of the JAX
    package."""
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {OBSERVABILITY_MODULES!r}]; "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(ROOT)})


@pytest.mark.parametrize("module, names", [
    ("deepspeed_tpu_torch.monitor",
     ("Event", "Monitor", "MonitorMaster", "TensorBoardMonitor", "WandbMonitor", "CsvMonitor",
      "PrometheusExporter", "TelemetryPump", "sanitize_metric_name", "PipelineStats",
      "TrainPipelineStats", "CheckpointStats")),
    ("deepspeed_tpu_torch.profiling", ("FlopsProfiler", "ModuleProfile", "get_model_profile")),
    ("deepspeed_tpu_torch.utils.locksan",
     ("arm", "disarm", "SanLock", "SanSemaphore", "note_blocking", "find_cycles", "report",
      "check_static")),
    ("deepspeed_tpu_torch.utils.threads",
     ("make_lock", "make_rlock", "make_semaphore", "make_condition", "thread_role")),
    ("deepspeed_tpu_torch.utils.timer", ("Timer", "SynchronizedWallClockTimer", "ThroughputTimer")),
    ("deepspeed_tpu_torch.utils.fault_injection", ("install_from_env", "KILL_EXIT_CODE")),
    ("deepspeed_tpu_torch.elasticity",
     ("ElasticityError", "compute_elastic_config", "validate_elastic_nodes")),
    ("deepspeed_tpu_torch.elasticity.elastic_agent", ("DSElasticAgent", "RunRecord")),
])
def test_observability_slice_exports(module, names):
    import importlib
    mod = importlib.import_module(module)
    assert all(hasattr(mod, n) for n in names), [n for n in names if not hasattr(mod, n)]


@pytest.mark.parametrize("module, names", [
    ("deepspeed_tpu_torch.inference.v2.serving",
     ("ServingFrontend", "RequestHandle", "AdmissionController", "KVOffloadManager",
      "PoissonLoadGen", "replay", "goodput_report", "ServingCluster", "PrefillWorker",
      "ServingRouter", "ClusterPrefixIndex", "HealthMonitor")),
    ("deepspeed_tpu_torch.inference.v2.config_v2",
     ("PriorityClassConfig", "ServingConfig", "HealthConfig", "RouterConfig")),
    ("deepspeed_tpu_torch.monitor.serving",
     ("FrontendStats", "HealthStats", "RouterStats", "PipelineStats")),
    ("deepspeed_tpu_torch.monitor.trace", ("Tracer", "tracer", "install_from_env")),
])
def test_serving_slice_exports(module, names):
    import importlib
    mod = importlib.import_module(module)
    assert all(hasattr(mod, n) for n in names), [n for n in names if not hasattr(mod, n)]


def test_serving_frontend_defaults_to_the_card(monkeypatch):
    """``engine.serving_frontend()`` serves on the engine's device, which
    is the card unless the caller asked for the CPU; the colocated
    rollout's weight swap runs there (it was refused by name until it was
    ported), and a tree on another device is refused."""
    model, econf = _tiny_engine_args()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(model, econf, model.flat_params()).serving_frontend()
    e = InferenceEngineV2(model, econf, model.flat_params(), device="cpu")
    fe = e.serving_frontend()
    assert fe.engine.device.type == "cpu" and not fe.offload.pool.pin_memory
    with pytest.raises(ValueError, match="structure"):
        fe.swap_weights({})
    moved = unflatten_into(e.weights, {k: t.to("meta")
                                       for k, t in flatten_tree(e.weights).items()})
    with pytest.raises(ValueError, match="on meta"):
        fe.swap_weights(moved)
    assert fe.swap_weights(unflatten_into(e.weights, flatten_tree(e.weights))) == 1
    assert e.weight_version == 1
    fe.close()


def test_zero_to_fp32_cli_runs_without_jax(tmp_path):
    """``python -m deepspeed_tpu_torch.utils.zero_to_fp32 <ckpt_dir> <out>``
    consolidates a tag on a host with no JAX."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(GPT2Config.tiny(n_layer=1), device="cpu"),
        config={"train_batch_size": 2, "steps_per_print": 0}, device="cpu")
    engine.save_checkpoint(str(tmp_path / "ck"))
    code = ("import runpy, sys; sys.argv = ['zero_to_fp32', sys.argv[1], sys.argv[2]]; "
            "runpy.run_module('deepspeed_tpu_torch.utils.zero_to_fp32', run_name='__main__'); "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'deepspeed_tpu') "
            "or m.startswith(('jax.', 'flax.', 'deepspeed_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "ck"), str(tmp_path / "w.pt")],
                   cwd=ROOT, check=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    sd = torch.load(tmp_path / "w.pt")
    want = engine.state["master"]
    assert sorted(sd) == sorted(k.replace("/", ".") for k in want)
    assert all(torch.equal(sd[k.replace("/", ".")], t) for k, t in want.items())


@pytest.mark.parametrize("module, names", [
    ("deepspeed_tpu_torch.inference.v2.lora", ("LoraPagePool", "LoraAdapterRegistry",
                                               "REGISTERED", "RESIDENT", "EVICTED")),
    ("deepspeed_tpu_torch.module_inject", ("load_lora_adapter", "validate_lora_adapter",
                                           "pack_lora_pages")),
    ("deepspeed_tpu_torch.inference.v2.ragged_model", ("LORA_TARGETS", "lora_target_dims",
                                                       "lora_page_layout",
                                                       "lora_layer_operands")),
    ("deepspeed_tpu_torch.inference.v2.engine_v2", ("LoraStats",)),
])
def test_lora_slice_exports(module, names):
    import importlib
    mod = importlib.import_module(module)
    assert all(hasattr(mod, n) for n in names), [n for n in names if not hasattr(mod, n)]


@pytest.mark.parametrize("module, names", [
    ("deepspeed_tpu_torch.inference.v2", ("InferenceEngineV2", "build_multistep_decode",
                                          "multistep_schedule")),
    ("deepspeed_tpu_torch.inference.v2.ragged_model", ("build_multistep_decode",
                                                       "multistep_schedule",
                                                       "flush_side_slab")),
    ("deepspeed_tpu_torch.inference.v2.scheduler",
     ("DynamicSplitFuseScheduler.adopt_sequence",)),
])
def test_burst_slice_exports(module, names):
    """Dotted names resolve attribute by attribute."""
    import functools
    import importlib
    mod = importlib.import_module(module)

    def has(name):
        try:
            functools.reduce(getattr, name.split("."), mod)
            return True
        except AttributeError:
            return False

    assert all(has(n) for n in names), [n for n in names if not has(n)]


def test_burst_entry_points_follow_the_engine_device(monkeypatch):
    """The burst and the page movers take no device of their own: they run
    where the engine runs, which is the card unless the caller asks for the
    CPU; a CUDA upload stages through pinned memory, which this CPU-only
    build refuses."""
    import inspect
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import host_to_device, to_device
    for name in BURST_ENTRY_POINTS:
        assert "device" not in inspect.signature(getattr(InferenceEngineV2, name)).parameters
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, econf = _tiny_engine_args()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(model, econf, model.flat_params())
    with pytest.raises(RuntimeError):
        host_to_device(torch.zeros(2), "cuda")
    a = np.arange(3, dtype=np.int32)
    t = to_device(a, "cpu")
    a[0] = 7                                   # the caller may reuse its array
    assert t.tolist() == [0, 1, 2]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    """The module NAME is matched exactly: deepspeed_tpu_torch shares the
    deepspeed_tpu prefix."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _tiny_engine_args():
    cfg = LlamaConfig.tiny(vocab_size=64)
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    econf = {"dtype": torch.float32,
             "state_manager": {"max_tracked_sequences": 4,
                               "max_ragged_sequence_count": 4,
                               "max_ragged_batch_size": 36,
                               "max_context": 64, "prefill_chunk_size": 16},
             "kv_cache": {"block_size": 8}}
    return model, econf


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, econf = _tiny_engine_args()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(model, econf, model.flat_params())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(model.config)
    # asking for the CPU works
    e = InferenceEngineV2(model, econf, model.flat_params(), device="cpu")
    assert e.kv.kv.device.type == "cpu"


def _kernel_inputs(seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    pool = f(6, 2, 2, 4, 16)
    w8 = torch.from_numpy(rng.randint(-127, 128, (32, 16)).astype(np.int8))
    lse_p = f(2, 3, 4)
    lse_p[0, 1] = -1e30                     # an empty split
    # K9: per-head layouts in blocks of 16 over S = 48 (a ragged 64-tile)
    bsa = lambda causal: {"tables": kernels.get_tables(
        np.array([[[1, 0, 0], [1, 1, 0], [0, 1, 1]], [[1, 1, 1], [0, 1, 0], [1, 0, 1]]]),
        16, causal, 48, "cpu"), "scale": 0.25}
    x = lambda: f(1, 2, 48, 16)
    # K10: L = 4 rows in groups of R = 2, a ragged S = 9, H = 2, D = 16
    e = lambda: f(4, 9, 2, 16)
    evo = lambda: (e(), e(), e(), torch.where(f(4, 9) > 1, -1e9, 0.0), f(2, 2, 9, 9))
    evo_kw = {"scale": 0.25, "R": 2}
    return {
        "flash_packed": lambda: ((f(10, 4, 16), f(10, 2, 16), f(10, 2, 16),
                                  i32([0] * 6 + [1] * 3 + [-1])), {}),
        "paged_chunk": lambda: ((f(2, 4, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                 i32([2, 0]), i32([6, 0])), {}),
        "paged_decode": lambda: ((f(2, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                  i32([5, 0]), f(2, 2, 16), f(2, 2, 16)), {"j": 0}),
        # the window branches: starts mid-page, and a page below every row's
        # window start (logical page 0 of row 0)
        "flash_packed_window": lambda: ((f(10, 4, 16), f(10, 2, 16), f(10, 2, 16),
                                         i32([0] * 6 + [1] * 3 + [-1])), {"window": 3}),
        "flash_packed_lse": lambda: ((f(10, 4, 16), f(10, 2, 16), f(10, 2, 16),
                                      i32([0] * 6 + [1] * 3 + [-1])), {"with_lse": True}),
        "flash_packed_window_lse": lambda: ((f(10, 4, 16), f(10, 2, 16), f(10, 2, 16),
                                             i32([0] * 6 + [1] * 3 + [-1])),
                                            {"window": 3, "with_lse": True}),
        "paged_chunk_window": lambda: ((f(2, 4, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                        i32([2, 0]), i32([6, 0])), {"window": 3}),
        "paged_decode_window": lambda: ((f(2, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                         i32([6, 0]), f(2, 4, 16), f(2, 4, 16)),
                                        {"j": 1, "window": 2}),
        "splitk_attention_window": lambda: ((f(2, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                             i32([6, 0])),
                                            {"n_splits": 2, "side_k": f(2, 2, 16),
                                             "side_v": f(2, 2, 16), "j": 0, "window": 3}),
        # the ALiBi branches: side rows at positions lens + cc
        "paged_chunk_alibi": lambda: ((f(2, 4, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                       i32([2, 0]), i32([6, 0])), {"alibi": True}),
        # the side buffer of a burst (C > 1 side rows; counted under _side)
        "paged_decode_side": lambda: ((f(2, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                       i32([5, 0]), f(2, 6, 16), f(2, 6, 16)), {"j": 2}),
        "splitk_attention_side": lambda: ((f(2, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                           i32([5, 0])),
                                          {"n_splits": 2, "side_k": f(2, 6, 16),
                                           "side_v": f(2, 6, 16), "j": 1}),
        "paged_decode_alibi": lambda: ((f(2, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                        i32([6, 0]), f(2, 4, 16), f(2, 4, 16)),
                                       {"j": 1, "alibi": True}),
        "splitk_attention_alibi": lambda: ((f(2, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                            i32([6, 0])),
                                           {"n_splits": 2, "side_k": f(2, 2, 16),
                                            "side_v": f(2, 2, 16), "j": 0, "alibi": True}),
        "flash_fwd": lambda: ((f(2, 9, 2, 16), f(2, 9, 2, 16), f(2, 9, 2, 16)),
                              {"causal": True, "scale": 0.25}),
        "flash_bwd_dq": lambda: ((f(2, 9, 2, 16), f(2, 9, 2, 16), f(2, 9, 2, 16),
                                  f(2, 9, 2, 16), f(2, 2, 9), f(2, 2, 9)),
                                 {"causal": True, "scale": 0.25}),
        "flash_bwd_dkv": lambda: ((f(2, 9, 2, 16), f(2, 7, 2, 16), f(2, 7, 2, 16),
                                   f(2, 9, 2, 16), f(2, 2, 9), f(2, 2, 9)),
                                  {"causal": False, "scale": 0.25}),
        # the whole backward: q, k, v, o, lse, dO
        "flash_bwd": lambda: ((f(2, 9, 2, 16), f(2, 9, 2, 16), f(2, 9, 2, 16),
                               f(2, 9, 2, 16), f(2, 2, 9), f(2, 9, 2, 16)),
                              {"causal": True, "scale": 0.25}),
        "quantized_matmul": lambda: ((f(3, 32), w8, f(16).abs()), {}),
        # packed int4 [K/2, N]: every byte value, so every nibble pair
        "quantized_matmul_int4": lambda: ((f(3, 32), torch.from_numpy(
            rng.randint(-128, 128, (16, 16)).astype(np.int8)), f(16).abs()), {}),
        "splitk_attention": lambda: ((f(2, 4, 16), pool, i32([[1, 2], [3, 0]]),
                                      i32([5, 0])),
                                     {"n_splits": 2, "side_k": f(2, 2, 16),
                                      "side_v": f(2, 2, 16), "j": 0}),
        "splitk_merge": lambda: ((f(2, 3, 4, 16), lse_p),
                                 {"dtype": torch.float32, "with_lse": True}),
        "block_sparse_fwd": lambda: ((x(), x(), x()), bsa(True)),
        "block_sparse_dq": lambda: ((x(), x(), x(), x(), f(1, 2, 48), f(1, 2, 48)),
                                    bsa(False)),
        "block_sparse_dkv": lambda: ((x(), x(), x(), x(), f(1, 2, 48), f(1, 2, 48)),
                                     bsa(True)),
        # the whole backward: q, k, v, o, lse, dO
        "block_sparse_bwd": lambda: ((x(), x(), x(), x(), f(1, 2, 48), x()), bsa(True)),
        "evoformer_fwd": lambda: (evo(), evo_kw),
        "evoformer_dq": lambda: ((*evo(), e(), f(4, 2, 9), f(4, 2, 9)), evo_kw),
        "evoformer_dkv": lambda: ((*evo(), e(), f(4, 2, 9), f(4, 2, 9)), evo_kw),
        "evoformer_dbias": lambda: ((*evo(), e(), f(4, 2, 9), f(4, 2, 9)), evo_kw),
        # the whole backward: q, k, v, mask, pair, o, lse, dO
        "evoformer_bwd": lambda: ((*evo(), e(), f(4, 2, 9), e()), evo_kw),
    }


WRAPPERS = {
    "flash_packed": (kernels.flash_attention_packed, kernels.flash_attention_packed_plain),
    "paged_chunk": (kernels.paged_chunk_attention_batched,
                    kernels.paged_chunk_attention_batched_plain),
    "paged_decode": (kernels.paged_decode_attention, kernels.paged_decode_attention_plain),
    "flash_packed_window": (kernels.flash_attention_packed,
                            kernels.flash_attention_packed_plain),
    "flash_packed_lse": (kernels.flash_attention_packed, kernels.flash_attention_packed_plain),
    "flash_packed_window_lse": (kernels.flash_attention_packed,
                                kernels.flash_attention_packed_plain),
    "paged_chunk_window": (kernels.paged_chunk_attention_batched,
                           kernels.paged_chunk_attention_batched_plain),
    "paged_decode_window": (kernels.paged_decode_attention,
                            kernels.paged_decode_attention_plain),
    "splitk_attention_window": (kernels.splitk_attention, kernels.splitk_attention_plain),
    "paged_chunk_alibi": (kernels.paged_chunk_attention_batched,
                          kernels.paged_chunk_attention_batched_plain),
    "paged_decode_alibi": (kernels.paged_decode_attention,
                           kernels.paged_decode_attention_plain),
    "splitk_attention_alibi": (kernels.splitk_attention, kernels.splitk_attention_plain),
    "paged_decode_side": (kernels.paged_decode_attention,
                          kernels.paged_decode_attention_plain),
    "splitk_attention_side": (kernels.splitk_attention, kernels.splitk_attention_plain),
    "flash_fwd": (kernels.flash_attention_fwd, kernels.flash_attention_fwd_plain),
    "flash_bwd_dq": (kernels.flash_bwd_dq, kernels.flash_bwd_dq_plain),
    "flash_bwd_dkv": (kernels.flash_bwd_dkv, kernels.flash_bwd_dkv_plain),
    "flash_bwd": (kernels.flash_attention_bwd, kernels.flash_attention_bwd_plain),
    "quantized_matmul": (kernels.quantized_matmul, kernels.quantized_matmul_plain),
    "quantized_matmul_int4": (kernels.quantized_matmul_int4,
                              kernels.quantized_matmul_int4_plain),
    "splitk_attention": (kernels.splitk_attention, kernels.splitk_attention_plain),
    # the merge kernel's wrapper; merge_splitk_partials is its plain version
    "splitk_merge": (splitk_merge, lambda out_p, lse_p, dtype, with_lse:
                     merge_splitk_partials(out_p, lse_p)),
    "block_sparse_fwd": (kernels.block_sparse_fwd, kernels.block_sparse_fwd_plain),
    "block_sparse_dq": (kernels.block_sparse_dq, kernels.block_sparse_dq_plain),
    "block_sparse_dkv": (kernels.block_sparse_dkv, kernels.block_sparse_dkv_plain),
    "block_sparse_bwd": (kernels.block_sparse_bwd, kernels.block_sparse_bwd_plain),
    "evoformer_fwd": (kernels.evoformer_fwd, kernels.evoformer_fwd_plain),
    "evoformer_dq": (kernels.evoformer_dq, kernels.evoformer_dq_plain),
    "evoformer_dkv": (kernels.evoformer_dkv, kernels.evoformer_dkv_plain),
    "evoformer_dbias": (kernels.evoformer_dbias, kernels.evoformer_dbias_plain),
    "evoformer_bwd": (kernels.evoformer_bwd, kernels.evoformer_bwd_plain),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_runs_plain_on_cpu_and_counts_nothing(name):
    kernels.reset_launches()
    args, kw = _kernel_inputs()[name]()
    wrapper, plain = WRAPPERS[name]
    torch.testing.assert_close(wrapper(*args, **kw), plain(*args, **kw), rtol=0, atol=0)
    assert kernels.LAUNCHES == {k: 0 for k in kernels.LAUNCHES}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_other_devices(name):
    args, kw = _kernel_inputs()[name]()
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="CUDA"):
        WRAPPERS[name][0](*meta, **kw)


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_loader.shutil, "which", lambda _: None)
    monkeypatch.setattr(_loader.os.path, "isfile", lambda _: False)
    monkeypatch.setattr(_loader, "BUILD_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _loader.build_library()
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("section, value, feature", [
    # spec decode and the prefix cache load since they were ported; each
    # stays refused with a sliding-window model, in the JAX package's words
    pytest.param("spec_decode", {"enabled": True}, "spec_decode",
                 id="spec_decode-value0-spec_decode"),
    pytest.param("prefix_cache", {"enabled": True}, "prefix_cache",
                 id="prefix_cache-value1-prefix_cache"),
    # lora loads since it was ported; with tensor_parallel > 1 it is
    # refused in the JAX engine's words
    pytest.param("lora", {"enabled": True}, "lora", id="lora-value2-lora"),
    ("tensor_parallel", 2, "tensor_parallel"),
    # the id this case had while a fourth one preceded it
    pytest.param("serving", {"decode_slice": 4}, "serving", id="serving-value5-serving"),
])
def test_unported_config_feature_raises(section, value, feature):
    if section in ("spec_decode", "prefix_cache"):
        cfg = RaggedInferenceEngineConfig.load({section: value})
        AttentionKernelSpec.validate_engine_build(_spec(), cfg)
        with pytest.raises(NotImplementedError, match=f"{feature} with a sliding-window"):
            AttentionKernelSpec.validate_engine_build(_spec(window=64), cfg)
        return
    if section == "lora":
        assert RaggedInferenceEngineConfig.load({section: value}).lora.enabled
        with pytest.raises(NotImplementedError,
                           match="multi-tenant LoRA with tensor_parallel > 1 is not wired"):
            RaggedInferenceEngineConfig.load({section: value, "tensor_parallel": 2})
        return
    if section == "serving":
        # the serving frontend loads since it was ported; tensor_parallel > 1
        # is still refused beside it
        assert RaggedInferenceEngineConfig.load({section: value}).serving.decode_slice == 4
        with pytest.raises(NotImplementedError, match="tensor_parallel"):
            RaggedInferenceEngineConfig.load({section: value, "tensor_parallel": 2})
        return
    with pytest.raises(NotImplementedError, match=feature):
        RaggedInferenceEngineConfig.load({section: value})


@pytest.mark.parametrize("section, value", [
    ("kv_quant", {"enabled": True}),
    ("attention", {"decode_splits": 8, "min_ctx_per_split": 512}),
    ("quantization", {"weight_bits": 8}),
    ("quantization", {"weight_bits": 4}),
])
def test_ported_config_feature_loads(section, value):
    cfg = RaggedInferenceEngineConfig.load({section: value})
    for k, v in value.items():
        assert getattr(getattr(cfg, section), k) == v


def _spec(**kw):
    return RaggedModelSpec(family="llama", num_layers=1, hidden_size=256,
                           num_heads=2, num_kv_heads=2, head_dim=128,
                           vocab_size=16, **kw)


@pytest.mark.parametrize("kw, feature", [
    ({"window": 64}, "sliding window"),
    ({"alibi": True}, "ALiBi"),
    ({"moe": {"num_experts": 4, "top_k": 2}}, "MoE"),
])
def test_unported_model_feature_raises(kw, feature):
    """A sliding window, ALiBi and MoE over an int8 pool validate (their
    branches are ported); MoE with packed int4 weights is refused by
    name."""
    cfg = RaggedInferenceEngineConfig.load({"kv_quant": {"enabled": True}})
    AttentionKernelSpec.validate_engine_build(_spec(), cfg)
    AttentionKernelSpec.validate_engine_build(_spec(**kw), cfg)
    if feature == "MoE":
        int4 = RaggedInferenceEngineConfig.load({"quantization": {"weight_bits": 4}})
        with pytest.raises(NotImplementedError, match=feature):
            AttentionKernelSpec.validate_engine_build(_spec(**kw), int4)


def test_sliding_window_model_raises_at_engine_build():
    """A windowed model with int8 KV pages builds (D = 128, Hkv * bs =
    128): the window is bound into its kernels and the pool is int8 with
    its scale tiles (served against the JAX engine:
    tests/test_torch_int8_window_alibi.py)."""
    cfg = LlamaConfig.tiny(vocab_size=64, hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=2, sliding_window=16)
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    _, econf = _tiny_engine_args()
    econf["kv_cache"] = {"block_size": 64}
    econf["kv_quant"] = {"enabled": True}
    engine = InferenceEngineV2(model, econf, model.flat_params(), device="cpu")
    assert engine.spec.window == 16 and engine.scheduler.ring_pages is not None
    assert engine.kv.kv.dtype == torch.int8 and engine.kv.scales is not None


def test_compile_section_is_accepted():
    cfg = RaggedInferenceEngineConfig.load({"compile": {"warmup": True}})
    assert cfg.compile.warmup is True
