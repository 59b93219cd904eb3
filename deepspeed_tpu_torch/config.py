"""Typed configuration tree of the training engine: a copy of the JAX
package's ``config.py`` with torch dtypes.

One JSON/dict configures every feature, mirroring the reference's single-dict
philosophy (``deepspeed/runtime/config.py:94`` ``DeepSpeedConfig`` and the pydantic
``DeepSpeedConfigModel`` at ``deepspeed/runtime/config_utils.py:16``).  We keep the
same key spellings (``train_batch_size``, ``zero_optimization.stage``,
``bf16.enabled`` ...) so existing DeepSpeed configs parse unchanged, but the tree is
plain dataclasses: no pydantic dependency, scientific-notation string coercion, alias
and deprecated-key migration, and central batch-size resolution
(micro x GAS x dp == train_batch_size, see ``_batch_assertion`` in the reference).

Every section parses as in the JAX package. Those whose feature the port
does not run yet raise ``NotImplementedError`` naming the section when they
are switched on (:meth:`DeepSpeedTPUConfig.check_slice`); the defaults are
the JAX package's.

The ``mesh`` key keeps the JAX package's axis names; the port runs on a
world of one device, so every axis must resolve to 1.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
from dataclasses import dataclass, field, fields
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

logger = logging.getLogger("deepspeed_tpu_torch")


class ConfigError(ValueError):
    """Raised on invalid / inconsistent config input."""


def _coerce_number(value: Any, target: type) -> Any:
    """Coerce scientific-notation strings and floats to the target numeric type.

    The reference accepts ``"1e-5"`` for floats and ``1e9``/"1e9" for ints
    (``ScientificNotationEncoder`` / ``pp_int`` in ``runtime/config_utils.py``).
    """
    if target is int:
        if isinstance(value, bool):
            raise ConfigError(f"expected int, got bool {value!r}")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                f = float(value)
            except ValueError:
                raise ConfigError(f"expected int, got {value!r}") from None
            if f.is_integer():
                return int(f)
        raise ConfigError(f"expected int, got {value!r}")
    if target is float:
        if isinstance(value, bool):
            raise ConfigError(f"expected float, got bool {value!r}")
        if isinstance(value, (int, float)):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value)
            except ValueError:
                raise ConfigError(f"expected float, got {value!r}") from None
        raise ConfigError(f"expected float, got {value!r}")
    if target is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f"expected bool, got {value!r}")
    return value


class ConfigModel:
    """Mixin giving dataclasses ``from_dict`` with key validation and coercion.

    Parity: ``DeepSpeedConfigModel`` (reference ``runtime/config_utils.py:16``) —
    extra-key warnings, field aliases via metadata, deprecated-key migration.
    """

    # mapping of deprecated/alias key -> canonical field name
    _aliases: Dict[str, str] = {}
    # mapping of deprecated key -> (canonical field name, value migration fn);
    # used where the legacy value shape differs (e.g. bool -> sub-config dict)
    _migrations: Dict[str, Tuple[str, Any]] = {}

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]], path: str = "") -> "ConfigModel":
        data = dict(data or {})
        kwargs: Dict[str, Any] = {}
        field_map = {f.name: f for f in fields(cls)}  # type: ignore[arg-type]
        for alias, canonical in cls._aliases.items():
            if alias in data:
                if canonical in data:
                    raise ConfigError(f"{path}: both '{alias}' and '{canonical}' set")
                logger.warning(f"config key '{path}.{alias}' is deprecated; use '{canonical}'")
                data[canonical] = data.pop(alias)
        for legacy, (canonical, migrate) in cls._migrations.items():
            if legacy in data:
                if canonical in data:
                    raise ConfigError(f"{path}: both '{legacy}' and '{canonical}' set")
                logger.warning(f"config key '{path}.{legacy}' is deprecated; use '{canonical}'")
                data[canonical] = migrate(data.pop(legacy))
        for key, value in data.items():
            if key not in field_map:
                logger.warning(f"unknown config key '{path}.{key}' ignored" if path else f"unknown config key '{key}' ignored")
                continue
            f = field_map[key]
            kwargs[key] = _convert_field(f, value, f"{path}.{key}" if path else key)
        obj = cls(**kwargs)  # type: ignore[call-arg]
        return obj

    def to_dict(self) -> Dict[str, Any]:
        def enc(v):
            if isinstance(v, Enum):
                return v.value
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                return {f.name: enc(getattr(v, f.name)) for f in fields(v)}
            if isinstance(v, (list, tuple)):
                return [enc(x) for x in v]
            if isinstance(v, dict):
                return {k: enc(x) for k, x in v.items()}
            return v
        return enc(self)  # type: ignore[return-value]


def _convert_field(f: dataclasses.Field, value: Any, path: str) -> Any:
    t = f.type
    origin = getattr(t, "__origin__", None)
    # resolve string annotations lazily (from __future__ annotations)
    if isinstance(t, str):
        t = eval(t, globals())  # noqa: S307 - annotations are module-local
        origin = getattr(t, "__origin__", None)
    if origin is Union:
        args = [a for a in t.__args__ if a is not type(None)]
        if value is None:
            return None
        t = args[0]
        origin = getattr(t, "__origin__", None)
    if isinstance(t, type) and issubclass(t, ConfigModel):
        if isinstance(value, t):
            return value
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected dict, got {value!r}")
        return t.from_dict(value, path)
    if isinstance(t, type) and issubclass(t, Enum):
        try:
            return t(value)
        except ValueError as e:
            raise ConfigError(f"{path}: {e}") from e
    if t in (int, float, bool):
        try:
            return _coerce_number(value, t)
        except ConfigError as e:
            raise ConfigError(f"{path}: {e}") from e
    if origin in (list, tuple):
        return list(value) if origin is list else tuple(value)
    return value


# --------------------------------------------------------------------------- #
# Precision
# --------------------------------------------------------------------------- #


@dataclass
class FP16Config(ConfigModel):
    """Parity: reference ``fp16`` block (``runtime/config.py`` get_fp16_enabled etc.).

    On TPU bf16 is the native mixed-precision mode; fp16 + dynamic loss scaling is
    implemented for capability parity but off by default.
    """

    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 -> dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0


@dataclass
class BF16Config(ConfigModel):
    """Parity: reference ``bf16`` block; ``accumulate_grads_via_hooks`` analog is moot
    (grad accumulation is a jitted scan on TPU)."""

    enabled: bool = False
    immediate_grad_update: bool = False


# --------------------------------------------------------------------------- #
# ZeRO
# --------------------------------------------------------------------------- #


class OffloadDeviceEnum(str, Enum):
    """Parity: ``runtime/zero/offload_config.py:12``."""

    none = "none"
    cpu = "cpu"
    nvme = "nvme"


@dataclass
class OffloadParamConfig(ConfigModel):
    """Parity: ``DeepSpeedZeroOffloadParamConfig`` (``offload_config.py:19``)."""

    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False


@dataclass
class OffloadOptimizerConfig(ConfigModel):
    """Parity: ``DeepSpeedZeroOffloadOptimizerConfig`` (``offload_config.py:50``)."""

    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0
    # Delayed Param Update (ZeRO-Offload paper §5, DeepSpeed's DPU): run the
    # host optimizer for step N concurrently with device step N+1; host-flow
    # params apply one step late. Trades exact SGD semantics (one-step
    # staleness on the offloaded leaves) for step time ~= max(device, host)
    # instead of device + transfer + host.
    delayed_param_update: bool = False
    # Three-stage group pipeline inside the host step (docs/TRAINING.md
    # "Offloaded optimizer pipeline"): while group g runs its host kernel,
    # group g+1's grad D2H is in flight and group g-1's updated master is
    # already uploading/casting back. False restores the fully serial
    # fetch-all / step-all / upload-all step (identical math — the bench's
    # byte-equality baseline).
    overlap_step: bool = True
    # Worker threads for the host optimizer kernel (leaves are chunked and
    # stepped concurrently; both the native OpenMP kernels via ctypes and
    # numpy's vectorized inner loops release the GIL). 0 = auto: one worker
    # with an OpenMP team of every core (the JAX package's auto is
    # min(4, cpu_count()); the port's reason is in runtime/zero/offload.py).
    host_workers: int = 0
    # Leaves per pipeline group. 0 = buffer_count (the same sub-group sizing
    # the NVMe swapper uses, so grad fetches, kernel runs, and state swaps
    # all move through the pipeline in lock-step groups).
    group_size: int = 0
    # NVMe IO failure discipline (docs/ELASTICITY.md): bounded retries per
    # failed read/write (then the error SURFACES at the step), and a deadline
    # on AIO waits (0 = no deadline) so a dead disk hangs the step with a
    # clean IOTimeout instead of forever.
    io_retries: int = 2
    io_timeout_s: float = 0.0

    _aliases = {"delayed_update": "delayed_param_update"}


@dataclass
class ZeroConfig(ConfigModel):
    """Parity: ``DeepSpeedZeroConfig`` (reference ``runtime/zero/config.py:82``).

    On TPU the stages collapse into sharding policy (see
    ``deepspeed_tpu/runtime/zero/partition.py``):
      stage 0 -> replicated params + psum grads (plain DP)
      stage 1 -> optimizer states sharded over the fsdp axis
      stage 2 -> + gradients reduce-scattered (XLA emits reduce_scatter when the
                 optimizer shards are the only consumers)
      stage 3 -> + parameters sharded, allgathered on demand by the SPMD partitioner

    Bucket sizes become XLA all-gather/reduce-scatter combiner thresholds; the
    prefetch/persistence knobs become compiler-visible scheduling hints.
    """

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[OffloadParamConfig] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    # Explicit ZeRO-3 collective schedule (runtime/zero/prefetch.py). None =
    # unscheduled (implicit XLA placement, bit-for-bit the pre-schedule path).
    # 0 = serial schedule (each wave's gather tied to its own input: gather-
    # then-compute, no lookahead); d >= 1 = gathers issued d waves ahead of
    # compute (double-buffered at d=1). With the schedule armed,
    # allgather_bucket_size / reduce_bucket_size become the real wave/bucket
    # byte bounds of the scheduled collectives instead of XLA combiner hints.
    stage3_prefetch_depth: Optional[int] = None
    stage3_gather_16bit_weights_on_model_save: bool = False
    stage3_module_granularity_threshold: int = 0
    zero_hpz_partition_size: int = 1  # hierarchical (secondary) partition size, ZeRO++
    zero_quantized_weights: bool = False  # qwZ
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False  # qgZ
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    memory_efficient_linear: bool = True
    round_robin_gradients: bool = False
    use_multi_rank_bucket_allreduce: bool = True
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    override_module_apply: bool = True

    _aliases = {
        "stage3_gather_fp16_weights_on_model_save": "stage3_gather_16bit_weights_on_model_save",
    }
    # Reference accepted `cpu_offload: true` booleans pre-offload_config
    # (runtime/zero/config.py deprecated fields); migrate to the dict form.
    _migrations = {
        "cpu_offload": ("offload_optimizer",
                        lambda v: {"device": "cpu"} if v is True else (v or None)),
        "cpu_offload_param": ("offload_param",
                              lambda v: {"device": "cpu"} if v is True else (v or None)),
    }

    def __post_init__(self):
        if not 0 <= self.stage <= 3:
            raise ConfigError(f"zero_optimization.stage must be in [0,3], got {self.stage}")
        if self.stage3_prefetch_depth is not None:
            if self.stage3_prefetch_depth < 0:
                raise ConfigError(
                    "zero_optimization.stage3_prefetch_depth must be >= 0 "
                    f"(or null to disable the schedule), got {self.stage3_prefetch_depth}")
            if self.stage != 3:
                raise ConfigError(
                    "zero_optimization.stage3_prefetch_depth requires stage 3 "
                    f"(params are not sharded at stage {self.stage})")


# --------------------------------------------------------------------------- #
# Optimizer / scheduler
# --------------------------------------------------------------------------- #


@dataclass
class OptimizerConfig(ConfigModel):
    """Parity: the ``optimizer`` block consumed by
    ``DeepSpeedEngine._configure_basic_optimizer`` (``runtime/engine.py:1258``).

    ``type`` is one of the registry names in ``deepspeed_tpu/ops`` (adam, adamw,
    lamb, lion, adagrad, sgd, onebitadam, zerooneadam, onebitlamb, muon)."""

    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)
    legacy_fusion: bool = False


@dataclass
class SchedulerConfig(ConfigModel):
    """Parity: ``scheduler`` block -> ``deepspeed_tpu/runtime/lr_schedules.py``
    (reference ``deepspeed/runtime/lr_schedules.py``)."""

    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


# --------------------------------------------------------------------------- #
# Activation checkpointing
# --------------------------------------------------------------------------- #


@dataclass
class ActivationCheckpointingConfig(ConfigModel):
    """Parity: ``runtime/activation_checkpointing/checkpointing.py:1070 configure``.

    On TPU this maps to ``jax.checkpoint`` policies: ``partition_activations`` ->
    sharded remat saveables; ``cpu_checkpointing`` -> host offload of residuals
    (XLA memory_kind pinned_host); contiguous buffers are an XLA concern.
    """

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


# --------------------------------------------------------------------------- #
# Observability
# --------------------------------------------------------------------------- #


@dataclass
class CommsLoggerConfig(ConfigModel):
    """Parity: ``deepspeed/comm/config.py`` ``CommsConfig``."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@dataclass
class TensorBoardConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class WandbConfig(ConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


@dataclass
class CSVConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class PrometheusConfig(ConfigModel):
    """Live telemetry endpoint (``monitor/export.py``,
    docs/OBSERVABILITY.md "Live telemetry"): a pull-based Prometheus-text
    snapshot of the latest monitor events, served from an embedded HTTP
    endpoint (``GET /metrics``) so a dashboard scrapes the run without
    touching CSV files. No reference analog — the reference's monitor is
    write-side only."""

    enabled: bool = False
    # bind address/port for the scrape endpoint; port 0 = OS-assigned
    # (read back from ``PrometheusExporter.port``)
    addr: str = "127.0.0.1"
    port: int = 0
    # metric-name prefix (``serve/frontend/queue_depth`` ->
    # ``<prefix>_serve_frontend_queue_depth``)
    prefix: str = "dstpu"
    # when set, close() writes a final ``metrics.prom`` snapshot under
    # ``output_path/job_name`` (the CSV convention)
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class TraceConfig(ConfigModel):
    """Span tracing (``monitor/trace.py``, docs/OBSERVABILITY.md): a
    Perfetto-exportable timeline across the train/serve/offload/checkpoint
    pipelines plus a crash flight recorder. No direct reference analog — the
    reference leans on torch.profiler; here the async pipelines carry their
    own zero-sync span instrumentation. Also armable without config via the
    ``DSTPU_TRACE=<dir>`` env var (subprocess benches)."""

    enabled: bool = False
    # where trace_{pid}.json / trace_crash.json land; nonempty implies enabled
    dir: str = ""
    # spans retained per thread — bounded memory AND the flight-recorder
    # window a crash dump preserves
    ring_size: int = 16384
    # per-request serve/req/u<uid> lanes exported under their own track;
    # older (retired) requests recycle onto pooled serve/req/recycled/<k>
    # tracks so a long serving run's timeline stays bounded in rows
    req_lane_window: int = 64


@dataclass
class MonitorConfig(ConfigModel):
    """Monitor-subsystem knobs beyond the per-backend sections (which stay
    top-level for reference parity: ``tensorboard``/``wandb``/``csv_monitor``)."""

    trace: TraceConfig = field(default_factory=TraceConfig)


@dataclass
class FlopsProfilerConfig(ConfigModel):
    """Parity: ``profiling/config.py`` ``DeepSpeedFlopsProfilerConfig``."""

    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


# --------------------------------------------------------------------------- #
# Elasticity / autotuning
# --------------------------------------------------------------------------- #


@dataclass
class ElasticityConfig(ConfigModel):
    """Parity: ``elasticity/config.py`` ``ElasticityConfig``."""

    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.2
    ignore_non_elastic_batch_info: bool = False
    prefer_larger_batch_size: bool = True


@dataclass
class AutotuningConfig(ConfigModel):
    """Parity: ``autotuning/config.py``."""

    enabled: bool = False
    fast: bool = True
    results_dir: str = "autotuning_results"
    exps_dir: str = "autotuning_exps"
    overwrite: bool = False
    metric: str = "throughput"
    start_profile_step: int = 3
    end_profile_step: int = 5
    tuner_type: str = "gridsearch"
    tuner_early_stopping: int = 5
    tuner_num_trials: int = 50
    arg_mappings: Dict[str, str] = field(default_factory=dict)
    max_train_batch_size: Optional[int] = None
    min_train_batch_size: int = 1
    max_train_micro_batch_size_per_gpu: int = 1024
    min_train_micro_batch_size_per_gpu: int = 1


# --------------------------------------------------------------------------- #
# Data efficiency / curriculum
# --------------------------------------------------------------------------- #


@dataclass
class CurriculumLearningConfig(ConfigModel):
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DataEfficiencyConfig(ConfigModel):
    """Parity: ``runtime/data_pipeline/config.py``."""

    enabled: bool = False
    seed: int = 1234
    data_sampling: Dict[str, Any] = field(default_factory=dict)
    data_routing: Dict[str, Any] = field(default_factory=dict)


# --------------------------------------------------------------------------- #
# Mesh (TPU-specific: replaces the reference's process-group plumbing)
# --------------------------------------------------------------------------- #


@dataclass
class MeshConfig(ConfigModel):
    """Device-mesh geometry.

    Axis sizes multiply to the total device count; -1 for ``data`` means "absorb the
    remainder" (like the reference deriving dp_world_size from
    world_size / (mp * ep * sp), ``utils/groups.py``).

    Axes (outer to inner; inner axes map to ICI-adjacent devices):
      pipe   - pipeline stages (DCN-spanning allowed)
      data   - pure data parallel (replicated params)
      fsdp   - ZeRO sharding axis (params/grads/opt states)
      expert - expert parallel (MoE all-to-all)
      seq    - sequence parallel (Ulysses / ring attention)
      tensor - tensor/model parallel
    """

    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    fsdp_sub: int = 1  # hpZ secondary partition / MiCS sub-group (inner fsdp axis)
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    # device order: "default" follows jax.devices(); on real slices XLA device order
    # is already ICI-contiguous in the trailing axes.
    axis_order: Tuple[str, ...] = ("pipe", "data", "fsdp", "fsdp_sub", "expert",
                                   "seq", "tensor")

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in ("pipe", "data", "fsdp", "fsdp_sub",
                                               "expert", "seq", "tensor")}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ConfigError(f"mesh: only one axis may be -1, got {wild}")
        fixed = 1
        for a, s in sizes.items():
            if s != -1:
                if s < 1:
                    raise ConfigError(f"mesh.{a} must be >= 1 or -1, got {s}")
                fixed *= s
        if wild:
            if n_devices % fixed != 0:
                raise ConfigError(f"mesh: {n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise ConfigError(f"mesh axes product {fixed} != device count {n_devices}")
        return sizes


# --------------------------------------------------------------------------- #
# Hybrid engine (RLHF) + progressive layer drop
# --------------------------------------------------------------------------- #


@dataclass
class HybridEngineConfig(ConfigModel):
    """Parity: ``hybrid_engine`` block (``runtime/hybrid_engine.py`` /
    ``runtime/config.py`` hybrid engine section)."""

    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8


@dataclass
class ProgressiveLayerDropConfig(ConfigModel):
    """Parity: ``progressive_layer_drop`` block (engine.py:1812 hook)."""

    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


# --------------------------------------------------------------------------- #
# Training step-loop pipelining (docs/TRAINING.md)
# --------------------------------------------------------------------------- #


@dataclass
class TrainPipelineConfig(ConfigModel):
    """The training step loop's input staging (``runtime/data_pipeline.py``):
    ``prefetch`` global batches of the engine's own data pipeline
    (``training_data``) are staged ahead by a producer thread (collate,
    curriculum truncation, PLD, the host->device copy on a stream of its
    own); 0 stages each batch on the caller's thread, with the same results.
    The JAX package's default."""

    prefetch: int = 2


# --------------------------------------------------------------------------- #
# Checkpoint
# --------------------------------------------------------------------------- #


@dataclass
class RollingCheckpointConfig(ConfigModel):
    """Continuous rolling checkpoints on a step cadence (the spot/preemptible
    resume story, docs/ELASTICITY.md). No direct reference analog — the
    reference leaves the save cadence to user training loops; here the engine
    owns it so the cadence interleaves correctly with the async step loop
    (metric drain) and the offload pipeline (upload-lane quiesce)."""

    # save every N global steps through the configured checkpoint engine
    # (0 = disabled). Pair with ``engine: "async"`` so only the device
    # snapshot runs on the step loop's critical path.
    every_n_steps: int = 0
    # retention: newest K rolling tags survive pruning (the tag ``latest``
    # points at is never pruned)
    keep_last: int = 2
    # where the rolling tags live; REQUIRED when every_n_steps > 0
    save_dir: str = ""
    # bounded writer lag/backpressure: at most this many snapshots may be
    # queued-but-uncommitted before the NEXT save blocks until the oldest
    # commit lands — the queue can never grow without bound when the disk
    # is slower than the cadence
    max_pending: int = 1
    # tag names: f"{tag_prefix}{global_step}"
    tag_prefix: str = "rolling_step"


@dataclass
class CheckpointConfig(ConfigModel):
    """Parity: ``checkpoint`` block (``runtime/config.py`` checkpoint section) +
    checkpoint-engine choice (``runtime/checkpoint_engine/``)."""

    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write_pipeline: bool = False
    engine: str = "native"  # native | async
    # writer threads for the async engine (ignored by the native engine)
    writers: int = 2
    # bounded retry budget per checkpoint file write (transient IO failures
    # recover; the budget exhausting surfaces the error at commit)
    writer_retries: int = 2
    writer_backoff_s: float = 0.05
    # checksum shards against the tag's manifest on every load (the
    # ``verify=True`` path; per-call override via load_checkpoint(verify=))
    verify_load: bool = False
    rolling: RollingCheckpointConfig = field(
        default_factory=RollingCheckpointConfig)


# --------------------------------------------------------------------------- #
# Top-level config
# --------------------------------------------------------------------------- #


@dataclass
class DeepSpeedTPUConfig(ConfigModel):
    """The full config tree. Parity: ``DeepSpeedConfig`` (``runtime/config.py:94``)."""

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    sparse_gradients: bool = False
    communication_data_type: Optional[str] = None
    seq_parallel_communication_data_type: str = "fp32"
    disable_allgather: bool = False
    dump_state: bool = False
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    seed: int = 42
    # The engine may alias (donate) the caller's model_parameters buffers into
    # its fp32 master state instead of copying — saves 4 bytes/param of HBM at
    # init for billion-parameter models, but the caller's tree is dead after
    # initialize(). Analog of the reference's ZeRO-3 taking ownership of module
    # params at zero.Init / engine wrap (partition_parameters.py).
    donate_model_parameters: bool = False

    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = field(default_factory=FP16Config)
    bf16: BF16Config = field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    activation_checkpointing: ActivationCheckpointingConfig = field(default_factory=ActivationCheckpointingConfig)
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)
    tensorboard: TensorBoardConfig = field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = field(default_factory=CSVConfig)
    prometheus: PrometheusConfig = field(default_factory=PrometheusConfig)
    monitor: MonitorConfig = field(default_factory=MonitorConfig)
    flops_profiler: FlopsProfilerConfig = field(default_factory=FlopsProfilerConfig)
    elasticity: ElasticityConfig = field(default_factory=ElasticityConfig)
    autotuning: AutotuningConfig = field(default_factory=AutotuningConfig)
    data_efficiency: DataEfficiencyConfig = field(default_factory=DataEfficiencyConfig)
    curriculum_learning: CurriculumLearningConfig = field(default_factory=CurriculumLearningConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    hybrid_engine: HybridEngineConfig = field(default_factory=HybridEngineConfig)
    progressive_layer_drop: ProgressiveLayerDropConfig = field(
        default_factory=ProgressiveLayerDropConfig)
    train_pipeline: TrainPipelineConfig = field(
        default_factory=TrainPipelineConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # precision of gradient accumulation buffer (parity: data_types.grad_accum_dtype)
    data_types: Dict[str, Any] = field(default_factory=dict)

    # compression (parity: compression_training block, compression/config.py) —
    # raw dict, parsed by deepspeed_tpu.compression (dict-schema like the reference)
    compression_training: Optional[Dict[str, Any]] = None

    # Extra XLA compile options for the jitted train step (merged OVER the
    # ZeRO-bucket-derived combiner thresholds; TPU backend only). The config-
    # driven analog of the reference's env-var XLA/NCCL tuning surface — lets
    # a user pin e.g. {"xla_tpu_scoped_vmem_limit_kib": 65536} per run.
    xla_compile_options: Dict[str, Any] = field(default_factory=dict)

    _migrations = {"fp16_enabled": ("fp16", lambda v: {"enabled": bool(v)})}

    # ------------------------------------------------------------------ #

    @classmethod
    def load(cls, config: Union[str, Dict[str, Any], "DeepSpeedTPUConfig", None]) -> "DeepSpeedTPUConfig":
        if config is None:
            config = {}
        if isinstance(config, DeepSpeedTPUConfig):
            return config
        if isinstance(config, (str, os.PathLike)):
            with open(config, "r") as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise ConfigError(f"config must be a dict or a path to a JSON file, got {type(config)}")
        return cls.from_dict(copy.deepcopy(config))  # type: ignore[return-value]

    # ------------------------------------------------------------------ #
    # Batch resolution. Parity: reference _configure_train_batch_size /
    # _batch_assertion (runtime/config.py).
    # ------------------------------------------------------------------ #

    def resolve_batch(self, dp_world_size: int) -> Tuple[int, int, int]:
        """Return (train_batch_size, micro_batch_per_replica, grad_accum_steps).

        Any two determine the third; exactly like the reference, all three set must
        satisfy train == micro * gas * dp_world_size.
        """
        tb, mb, gas = self.train_batch_size, self.train_micro_batch_size_per_gpu, self.gradient_accumulation_steps
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ConfigError(
                    f"train_batch_size({tb}) != micro_batch({mb}) * gradient_accumulation_steps({gas})"
                    f" * dp_world_size({dp_world_size})")
        elif tb is not None and mb is not None:
            if tb % (mb * dp_world_size) != 0:
                raise ConfigError(f"train_batch_size({tb}) not divisible by micro_batch({mb}) * dp({dp_world_size})")
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            if tb % (gas * dp_world_size) != 0:
                raise ConfigError(f"train_batch_size({tb}) not divisible by gas({gas}) * dp({dp_world_size})")
            mb = tb // (gas * dp_world_size)
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            gas = 1
            if tb % dp_world_size != 0:
                raise ConfigError(f"train_batch_size({tb}) not divisible by dp_world_size({dp_world_size})")
            mb = tb // dp_world_size
        else:
            raise ConfigError(
                "at least one of train_batch_size / train_micro_batch_size_per_gpu must be set")
        self.train_batch_size, self.train_micro_batch_size_per_gpu, self.gradient_accumulation_steps = tb, mb, gas
        return tb, mb, gas

    # ------------------------------------------------------------------ #

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    @property
    def grad_accum_dtype(self) -> torch.dtype:
        name = (self.data_types or {}).get("grad_accum_dtype")
        if name is None:
            return torch.float32
        return {"fp32": torch.float32, "fp16": torch.float16, "bf16": torch.bfloat16}[name]

    def __post_init__(self):
        if self.bf16.enabled and self.fp16.enabled:
            raise ConfigError("bf16 and fp16 cannot both be enabled")
        self.check_slice()

    def check_slice(self) -> None:
        """Refuse, by name, every switched-on section whose feature the port
        does not run yet."""
        z = self.zero_optimization
        off = [name for name, on in [
            # offload_param stays refused by name: the JAX engine accepts the
            # section and reads it nowhere, and a silent no-op would hide that
            ("zero_optimization.offload_param",
             z.offload_param is not None and z.offload_param.device != OffloadDeviceEnum.none),
            ("zero_optimization.stage3_prefetch_depth", z.stage3_prefetch_depth is not None),
            ("comms_logger", self.comms_logger.enabled),
            ("compression_training", self.compression_training is not None),
            (f"hybrid_engine.inference_tp_size = {self.hybrid_engine.inference_tp_size}",
             self.hybrid_engine.enabled and self.hybrid_engine.inference_tp_size > 1),
        ] if on]
        off += [f"mesh.{a} = {getattr(self.mesh, a)}"
                for a in ("pipe", "data", "fsdp", "fsdp_sub", "expert", "seq", "tensor")
                if getattr(self.mesh, a) > 1]
        if off:
            raise NotImplementedError(
                f"{', '.join(off)}: not ported to deepspeed_tpu_torch yet (it trains "
                "on one device, without parameter offload)")
