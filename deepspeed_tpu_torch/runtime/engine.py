"""The training engine on one device, as the JAX package's
``runtime/engine.py`` ``DeepSpeedTPUEngine``.

The state keeps the JAX engine's keys: ``master`` (fp32 weights), ``opt``
(the optimizer's state), ``step``, ``scaler`` (the loss-scaler state),
``skipped`` and, under mixed precision, ``params`` (the weights in the
compute dtype). ``params`` ARE the module's parameters, which autograd
differentiates; in fp32 the module's parameters are ``master`` itself, as
the JAX engine then uses ``master`` as its params. Every counter and scalar
of a step stays on the device:

- ``train_batch`` takes a global batch (given, from a ``data_iter``, or from
  the engine's own data pipeline over ``training_data``), stages it
  (``_prepare_batch``: curriculum seqlen truncation, progressive layer drop's
  inputs, the copy to the device; ahead of time on a producer thread under
  ``train_pipeline.prefetch``), splits it into ``gradient_accumulation_steps``
  micro-batches (a Python loop where the JAX engine scans), accumulates
  their gradients in ``grad_accum_dtype`` and divides by ``gas *
  loss_scale``;
- the forward/backward/step facade does the same a micro-batch at a time:
  ``forward`` returns the loss with its graph, ``backward(loss)`` runs
  autograd and accumulates (as DeepSpeed's own engine does; the JAX engine
  computes the gradient in ``forward``), ``step`` applies at the
  accumulation boundary; ``gas`` facade micro-steps give the bits of one
  ``train_batch``;
- ``_apply_grads`` takes the global norm, clips, runs the optimizer on the
  fp32 master, keeps the old state where the fp16 scaler saw an overflow
  (``torch.where``: no host sync decides a skip), updates the scaler,
  advances the step counter unless it overflowed, and casts back;
- metrics are queued and read ONE STEP LATE, and only when they are printed
  or a monitor sink is on; every device->host read goes through
  :func:`fetch_to_host`.

Observability follows the JAX engine: a ``MonitorMaster`` over the
``tensorboard`` / ``wandb`` / ``csv_monitor`` / ``prometheus`` sections gets
``Train/Samples/*`` every step and the pipeline, offload and checkpoint
counters at print boundaries; ``train_batch`` takes five ``perf_counter``
stamps a step that feed both ``train_stats`` and, when tracing
(``monitor.trace`` or ``DSTPU_TRACE``), the ``train/step/*`` spans; the
flops profiler runs at ``flops_profiler.profile_step``;
``wall_clock_breakdown`` syncs the ``fwd`` / ``bwd`` / ``step`` timers and
logs them; ``step.kill`` is the fault-injection site at the top of
``train_batch``.

Checkpoints follow JAX ``runtime/engine.py``'s ``save_checkpoint`` /
``load_checkpoint`` / ``destroy`` over ``deepspeed_tpu_torch.checkpoint``,
in the JAX package's file format (a tag moves both ways between the
packages):

- ``save_checkpoint`` drains the deferred metrics, snapshots the state in
  one policed device->host drain and writes through the configured
  checkpoint engine (``checkpoint.engine``: native, or async writer
  threads); ``latest`` flips after the manifest;
- ``load_checkpoint`` resumes from a tag (``tag=None``: the newest complete
  one, torn tags skipped) or, with ``checkpoint.load_universal``, from a
  universal directory, writing INTO the live tensors so the module's
  parameters stay the same objects, then restores the counters
  (``global_steps``, ``global_samples``, ``micro_steps``); the lr follows
  from the restored ``step``;
- ``checkpoint.rolling.every_n_steps > 0`` builds a ``RollingCheckpointer``
  whose ``maybe_save`` runs at the end of every step, after the counters;
- ``destroy`` closes the rolling committer, then the checkpoint engine,
  and re-raises a surfaced writer or commit error after the full teardown.

The engine calls ``activation_checkpointing.configure`` with its config
(``number_checkpoints``, the policy of ``partition_activations``) for the
model's checkpointed layers, and runs progressive layer drop (its theta
and per-row seeds, drawn from (``seed``, global step), go into each staged
batch) and the curriculum seqlen schedule.

ZeRO stages 0-3 are accepted and are the identity here: on a world of one
device there is nothing to partition, as in the JAX partitioner with
fsdp = 1.

ZeRO++ qwZ (``zero_optimization.zero_quantized_weights``) follows the JAX
engine on a world of one: ``state["params"]`` is
``runtime/zero/zeropp.py``'s ``quantize_param_tree`` of the fp32 master
(every leaf of two or more dims and at least ``QWZ_MIN_SIZE`` elements as
int8 ``{q, s}`` with a scale a row, the rest in the compute dtype). Between
steps the module's parameters for the quantized leaves hold no values (a
zero-stride stand-in of their shape); each step's forward first
dequantizes them (``(q.float() * s).to(compute dtype)``, the JAX engine's
``_current_params``) into the parameters autograd differentiates, the
gradient taken through them updates the fp32 master, and the step
requantizes the new master (the parameters are released before the
optimizer runs). A load rebuilds the params from the loaded master the
same way; tags hold the master, so a qwZ tag is the plain byte format.

A mesh, or a ``torch.distributed`` world of more than one rank, raises
``NotImplementedError``, as does a client optimizer that is not a
``TPUOptimizer``, which later slices port.

ZeRO-Offload (``zero_optimization.offload_optimizer``, ``device: cpu`` or
``nvme``) follows the JAX engine's offload state and step:

- ``state["params"]`` holds every leaf in the compute dtype (the module's
  parameters); ``state["master"]`` and ``state["opt"]`` hold only the
  device-flow leaves (twin flow, ``ratio < 1``); the host-flow leaves' fp32
  master and moments live in ``runtime/zero/offload.py``'s
  ``HostOffloadOptimizer`` (host RAM, or files through the NVMe swapper);
- the device step takes the norm, clips, updates the device-flow leaves
  and writes each host group's grads as one flat array in the compute
  dtype (the "wire"); each group's wire is copied into a pinned host
  buffer on a copy stream, a group or two ahead of the host kernel, with
  an event per group, so the host waits for that group only;
- the upload lane (a worker thread) casts each finished group's master to
  the compute dtype into a pinned buffer and copies it into the params on
  an upload stream ordered after the step's own kernels; the next step's
  kernels wait for it (``overlap_step: false`` runs fetch-all, step-all,
  upload-all in turn: the same bytes);
- ``delayed_param_update`` runs the host step on a worker thread while the
  next device step runs; its update lands in the params after that step's
  kernels, at the start of the step after it;
- checkpoints, ``rollout_source_params`` and ``destroy`` drain a pending
  host step first; tags hold the same flat keys as a plain engine's, so
  offload and plain tags load into each other, between the packages too.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint import (RollingCheckpointer, build_checkpoint_engine,
                                            load_engine_checkpoint,
                                            load_universal_into_engine,
                                            save_engine_checkpoint)
from deepspeed_tpu_torch.checkpoint.convert import params_from_flat
from deepspeed_tpu_torch.checkpoint.state import snapshot_state_flats
from deepspeed_tpu_torch.config import ConfigError, DeepSpeedTPUConfig, OffloadDeviceEnum
from deepspeed_tpu_torch.data.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.monitor import (CheckpointStats, MonitorMaster, OffloadPipelineStats,
                                         TrainPipelineStats)
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.ops.native import bf16_to_f32, f32_to_bf16
from deepspeed_tpu_torch.ops import TPUOptimizer, build_optimizer
from deepspeed_tpu_torch.runtime import activation_checkpointing
from deepspeed_tpu_torch.runtime.activation_checkpointing import mix_seed
from deepspeed_tpu_torch.runtime.data_pipeline import (PrefetchLoader, StagedBatch,
                                                       as_host_tree, inject_pld,
                                                       stage_tree, truncate_to_seqlen)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedTPUDataLoader, RepeatingLoader
from deepspeed_tpu_torch.runtime.loss_scaler import (has_overflow, make_loss_scale_state,
                                                     update_loss_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_schedule
from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer, partition_leaves
from deepspeed_tpu_torch.runtime.zero.zeropp import (_is_qleaf, dequantize_leaf,
                                                     dequantize_param_tree,
                                                     quantize_param_tree, requantize_into)
from deepspeed_tpu_torch.utils import fault_injection
from deepspeed_tpu_torch.utils import locksan as _locksan
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER, SynchronizedWallClockTimer,
                                             ThroughputTimer)
from deepspeed_tpu_torch.utils.tree import global_norm

logger = logging.getLogger("deepspeed_tpu_torch")

#: elements a group of the offload engine's device update holds at most
_DEVICE_UPDATE_ELEMS = 1 << 27
#: host groups whose grad copies are queued ahead of the host kernel
_FETCH_AHEAD = 2


def fetch_to_host(tree):
    """THE device->host read of the training engine: a tensor, or a dict of
    them, copied to the host (this blocks on the device). Nothing else in
    this module reads device values. Under tracing the read records a
    ``train/drain/fetch_to_host`` span, and with the lock-order sanitizer
    armed it notes a blocking call made while sanitized locks are held."""
    if _locksan.enabled():
        _locksan.note_blocking("fetch_to_host")
    if not _tracer.enabled:
        return _to_host(tree)
    t0 = time.perf_counter()
    out = _to_host(tree)
    _tracer.add("train/drain/fetch_to_host", t0, time.perf_counter(), lane="train/drain")
    return out


def _to_host(tree):
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().to("cpu")


def _unported(feature: str):
    return NotImplementedError(f"{feature}: not ported to deepspeed_tpu_torch yet")


class DeepSpeedTPUEngine:
    """See the module docstring. ``model`` is a module whose forward maps a
    batch to its scalar loss and which offers ``named_flat_parameters()``
    (flax name -> parameter), as ``models.gpt2.GPT2LMHead`` does.
    ``model_parameters`` is a flat tree of initial values (torch tensors or
    numpy arrays by flax name); None takes the module's own values."""

    def __init__(self, args=None, model=None, optimizer: Optional[TPUOptimizer] = None,
                 model_parameters: Optional[Mapping[str, Any]] = None,
                 training_data=None, lr_scheduler: Optional[Callable] = None,
                 mesh_topology=None, config=None, device=None, collate_fn=None):
        self.config = DeepSpeedTPUConfig.load(config)
        if mesh_topology is not None:
            raise _unported("mesh_topology (a device mesh)")
        if torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise _unported(f"a world of {torch.distributed.get_world_size()} ranks")
        if model is None:
            raise ValueError("initialize() requires a model")
        self.device = resolve_device(device)
        self.train_batch_size_, self.micro_batch_size_, self.gas_ = \
            self.config.resolve_batch(1)
        # the remat policy and number_checkpoints of every model built
        # under this engine
        activation_checkpointing.configure(self.config)
        self.module = model
        self.compute_dtype = self.config.compute_dtype
        self.mixed_precision = self.compute_dtype != torch.float32
        self.zero_stage = self.config.zero_optimization.stage

        if optimizer is not None:
            if not isinstance(optimizer, TPUOptimizer):
                raise _unported(f"client optimizer {type(optimizer).__name__}")
            self.optimizer = optimizer
        elif self.config.optimizer is not None:
            self.optimizer = build_optimizer(self.config.optimizer.type,
                                             self.config.optimizer.params)
        else:
            self.optimizer = build_optimizer("adamw", {"lr": 1e-3})
        base_lr = getattr(self.optimizer, "lr", 1e-3)
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self._lr_fn = lr_scheduler
        elif self.config.scheduler is not None and self.config.scheduler.type:
            self._lr_fn = build_lr_schedule(self.config.scheduler.type,
                                            self.config.scheduler.params, base_lr)
        else:
            self._lr_fn = build_lr_schedule(None, {}, base_lr)

        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._last_metrics: Dict[str, Any] = {}
        # deferred metric drain: (step, samples, device metrics) entries
        self._pending_metrics: deque = deque()
        self.monitor = MonitorMaster(self.config)
        self.train_stats = TrainPipelineStats()
        self.offload_stats = OffloadPipelineStats()
        self.flops_profiler = None
        # span tracing: the config's section reaches the tracer that
        # DSTPU_TRACE arms in initialize()
        tc = self.config.monitor.trace
        if tc.enabled or tc.dir:
            _tracer.configure(trace_dir=tc.dir, enabled=True, ring_size=tc.ring_size,
                              req_lane_window=tc.req_lane_window)
        # wall_clock_breakdown makes the timer group sync on the device, so
        # its numbers measure execution; otherwise the timers measure launch
        self.timers = SynchronizedWallClockTimer(sync=self.config.wall_clock_breakdown,
                                                 device=self.device)
        self.tput_timer = ThroughputTimer(batch_size=self.train_batch_size_,
                                          steps_per_output=self.config.steps_per_print,
                                          device=self.device)
        # ZeRO++ qwZ: the compute params are stored as int8 {q, s}
        self.quantized_weights = bool(self.config.zero_optimization.zero_quantized_weights)
        self._qwz_names: List[str] = []     # the quantized leaves
        self._qwz_live = False              # their parameters hold values now

        # ZeRO-Offload/Infinity: the host/NVMe optimizer step (the JAX
        # engine's checks, in its words)
        off = self.config.zero_optimization.offload_optimizer
        self._offload_cfg = None
        self._offload: Optional[HostOffloadOptimizer] = None
        self._offload_pending = None        # the in-flight delayed host step
        self._offload_executor = None       # its worker (built lazily)
        self._offload_upload_pool = None    # the upload lane (built lazily)
        self._offload_streams = None        # (copy, upload) streams on the card
        self._offload_nonfinite = False     # a loaded host master held NaN/inf
        self._offload_f32 = None            # the pipeline's fp32 grad buffers
        if off is not None and off.device != OffloadDeviceEnum.none:
            self._offload_cfg = off
            if self.zero_stage == 0:
                logger.warning("offload_optimizer with zero stage 0: optimizer "
                               "states go to host but grads stay replicated")
            if self.config.zero_optimization.zero_quantized_weights:
                raise ConfigError("zero_quantized_weights is not supported "
                                  "together with offload_optimizer")
        self._init_state(model_parameters)

        # progressive layer drop: its draws are seeded from (seed, step), so
        # staging ahead of the step counter draws what the sync path would
        self.progressive_layer_drop = None
        if self.config.progressive_layer_drop.enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=self.config.progressive_layer_drop.theta,
                gamma=self.config.progressive_layer_drop.gamma)
        self.curriculum_scheduler = None
        # (scheduled seqlen, widest leaf, needs truncation) of the last
        # staging: off bucket boundaries the tree walk is skipped
        self._curr_seqlen_state = None
        if self.config.curriculum_learning.enabled:
            self.curriculum_scheduler = CurriculumScheduler(self.config.curriculum_learning)

        # the data pipeline: the engine's loader over training_data, its
        # iterator (behind a PrefetchLoader when prefetching) and the
        # stream the host->device copies run on
        self._copy_stream = torch.cuda.Stream(device=self.device) \
            if self.device.type == "cuda" else None
        self._data_iterator = None
        self._prefetch_loader: Optional[PrefetchLoader] = None
        self._warned_stale_staging = False
        # the facade's accumulated gradients
        self._grad_buffer: Optional[List[torch.Tensor]] = None
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data, collate_fn=collate_fn)

        self.ckpt_stats = CheckpointStats()
        self._ckpt_engine = None
        # rolling checkpoints: the engine owns the cadence so saves
        # interleave correctly with the deferred metric drain
        self._rolling = None
        if self.config.checkpoint.rolling.every_n_steps > 0:
            self._rolling = RollingCheckpointer(
                self, self.config.checkpoint.rolling, stats=self.ckpt_stats)

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #

    def _init_state(self, model_parameters) -> None:
        named = self.module.named_flat_parameters()
        src = model_parameters
        if src is None:
            src = {n: p.detach() for n, p in named.items()}
        elif any(isinstance(v, np.ndarray) for v in src.values()):
            src = params_from_flat(src, device=self.device)
        if set(src) != set(named):
            raise KeyError(f"model_parameters names differ from the model's: missing "
                           f"{sorted(set(named) - set(src))[:4]}, unexpected "
                           f"{sorted(set(src) - set(named))[:4]}")
        self._module_params = dict(named)
        if self._offload_cfg is not None:
            return self._init_state_offload(named, src)
        if self.quantized_weights:
            return self._init_state_qwz(named, src)
        with torch.no_grad():
            master = {n: src[n].to(self.device, torch.float32).clone() for n in named}
            for n, p in named.items():
                # the module's parameters become the compute-dtype params (or,
                # in fp32, the master itself)
                p.data = master[n].to(self.compute_dtype) if self.mixed_precision \
                    else master[n]
                p.requires_grad_(True)
        if not self.mixed_precision:
            master = dict(named)
        self.state: Dict[str, Any] = {
            "master": master, "opt": self.optimizer.init(master),
            "step": torch.zeros((), dtype=torch.int32, device=self.device),
            "scaler": self._scaler_state(),
            "skipped": torch.zeros((), dtype=torch.int32, device=self.device)}
        if self.mixed_precision:
            self.state["params"] = dict(named)

    def _scaler_state(self) -> Dict[str, torch.Tensor]:
        fp16 = self.config.fp16
        scaler = make_loss_scale_state(fp16.enabled, fp16.loss_scale,
                                       fp16.initial_scale_power, fp16.hysteresis,
                                       device=self.device)
        self._scaler_dynamic = scaler.pop("dynamic")
        return scaler

    def _current_params(self) -> Dict[str, torch.Tensor]:
        """The weights the forward computes with, by flax name (under qwZ
        fresh dequantized tensors, as the JAX engine's ``_current_params``)."""
        if self.quantized_weights:
            return dequantize_param_tree(self.state["params"], self.compute_dtype)
        return self.state["params"] if "params" in self.state else self.state["master"]

    # ---- ZeRO++ qwZ state (the JAX engine's quantized params) ---- #

    def _init_state_qwz(self, named, src) -> None:
        """The qwZ layout (see the module docstring): an fp32 master of
        every leaf, ``state["params"]`` its ``quantize_param_tree``; the
        unquantized leaves' params are the module's parameters (in fp32 the
        master itself), the quantized leaves' parameters hold a stand-in
        until a forward dequantizes them."""
        with torch.no_grad():
            master = {n: src[n].to(self.device, torch.float32).clone() for n in named}
            params = quantize_param_tree(master, self.compute_dtype)
            self._qwz_names = [n for n in named if _is_qleaf(params[n])]
            for n, p in named.items():
                p.data = self._qwz_stand_in(p) if _is_qleaf(params[n]) else params[n]
                p.requires_grad_(True)
        self.state = {
            "master": master, "opt": self.optimizer.init(master),
            "step": torch.zeros((), dtype=torch.int32, device=self.device),
            "scaler": self._scaler_state(),
            "skipped": torch.zeros((), dtype=torch.int32, device=self.device),
            "params": {n: params[n] if _is_qleaf(params[n]) else named[n] for n in named}}

    def _qwz_stand_in(self, p: torch.Tensor) -> torch.Tensor:
        """A zero-stride tensor of ``p``'s shape in the compute dtype: the
        value a quantized leaf's parameter holds between forwards."""
        return torch.zeros((), dtype=self.compute_dtype, device=self.device).expand(p.shape)

    @torch.no_grad()
    def _qwz_dequantize(self) -> None:
        """Dequantize every quantized leaf into its module parameter (once
        a step: the micro-batches and the facade's forwards share them)."""
        if self._qwz_live or not self._qwz_names:
            return
        params = self.state["params"]
        for n in self._qwz_names:
            self._module_params[n].data = dequantize_leaf(params[n], self.compute_dtype)
        self._qwz_live = True

    def _qwz_release(self) -> None:
        """Drop the dequantized values (the grads are taken)."""
        if not self._qwz_live:
            return
        for n in self._qwz_names:
            p = self._module_params[n]
            p.data = self._qwz_stand_in(p)
        self._qwz_live = False

    @contextlib.contextmanager
    def _qwz_weights(self):
        """The quantized leaves' parameters hold values inside the block
        (and keep holding them after it if they already did)."""
        was = self._qwz_live
        self._qwz_dequantize()
        try:
            yield
        finally:
            if not was:
                self._qwz_release()

    # ---- ZeRO-Offload state (the JAX engine's _init_state_offload) ---- #

    def _init_state_offload(self, named, src) -> None:
        """The offload layout (see the module docstring): the module's
        parameters become the compute-dtype params of every leaf; the
        device-flow leaves keep an fp32 master (the params themselves in
        fp32) and device optimizer state; the host-flow leaves' fp32 master
        goes to the host optimizer. Host grads travel as one flat array a
        pipeline group (``_offload_group_meta``: (name, offset, count,
        shape) a leaf)."""
        cfg = self._offload_cfg
        shapes = {n: tuple(p.shape) for n, p in named.items()}
        # zero-stride stand-ins: partition_leaves reads shapes only
        host_names, dev_names = partition_leaves(
            {n: np.broadcast_to(np.float32(0), s) for n, s in shapes.items()}, cfg.ratio)
        self._offload_host_names, self._offload_dev_names = host_names, dev_names
        host_master = {}
        master = {}
        src = dict(src)   # popped leaf by leaf: a replaced parameter frees as we go
        with torch.no_grad():
            for n, p in named.items():
                v32 = src.pop(n).detach().to(self.device, torch.float32)
                if n in host_names:
                    host_master[n] = v32.to("cpu", copy=True).numpy()
                elif self.mixed_precision:
                    master[n] = v32.clone()
                p.data = v32.to(self.compute_dtype) if self.mixed_precision else v32.clone()
                p.requires_grad_(True)
                del v32
        if not self.mixed_precision:
            master = {n: named[n] for n in dev_names}
        self._offload = HostOffloadOptimizer(self.optimizer, host_master, cfg)
        del host_master
        self._offload_groups = self._offload.leaf_groups()
        self._offload_group_meta = []
        for names in self._offload_groups:
            meta, off = [], 0
            for k in names:
                n = int(np.prod(shapes[k]))
                meta.append((k, off, n, shapes[k]))
                off += n
            self._offload_group_meta.append(meta)
        opt = self.optimizer.init(master)
        # an empty device flow (ratio 1) still counts its steps on the device
        opt["step"] = opt["step"].to(self.device)
        self.state = {"params": dict(named), "master": master, "opt": opt,
                      "step": torch.zeros((), dtype=torch.int32, device=self.device),
                      "scaler": self._scaler_state(),
                      "skipped": torch.zeros((), dtype=torch.int32, device=self.device)}
        if self.device.type == "cuda":
            self._offload_streams = (torch.cuda.Stream(device=self.device),
                                     torch.cuda.Stream(device=self.device))
        logger.info("offload_optimizer[%s]: %d host leaves, %d device leaves",
                    cfg.device.value, len(host_names), len(dev_names))

    def rollout_source_params(self) -> Dict[str, torch.Tensor]:
        """The device-resident tree the colocated ``WeightBridge``
        (``runtime/colocated.py``) casts from, by flax name; nothing is
        copied:

        - a standard engine's ``state["master"]``, the fp32 master, exactly
          what ``ds_to_universal`` serialises (so the bridge is the
          universal checkpoint's path without the disk);
        - an offload engine's ``state["params"]`` (compute dtype), after an
          in-flight delayed host step drained: its master is split between
          the card and the host, and the params are the post-update view the
          next step and a checkpoint read.

        Quantized weights are refused in the JAX engine's words."""
        if self.quantized_weights:
            raise NotImplementedError(
                "colocated weight sync from a quantized-weight (ZeRO++ qwZ) "
                "engine is not wired — the bridge would have to dequantize "
                "per sync; train unquantized or sync via checkpoint")
        if self._offload is not None:
            self._drain_offload()
            return self.state["params"]
        return self.state["master"]

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #

    # ---- staging (the JAX engine's _prepare_batch) ---- #

    def _scheduled_seqlen(self, step: int) -> Optional[int]:
        """The curriculum seqlen of a global step: a pure read of the
        schedule, safe from the producer thread staging ahead."""
        if (self.curriculum_scheduler is None
                or self.config.curriculum_learning.curriculum_type != "seqlen"):
            return None
        return int(self.curriculum_scheduler.get_difficulty(step))

    def _staging_is_stale(self, staged_step: int) -> bool:
        """Would a batch staged for ``staged_step`` differ from one staged
        for the current step? PLD draws are per step; the curriculum only
        where its schedule moved between the two."""
        if self.progressive_layer_drop is not None:
            return True
        return self._scheduled_seqlen(staged_step) != self._scheduled_seqlen(self.global_steps)

    def _apply_curriculum(self, batch, seqlen: int):
        """The host batch truncated to ``seqlen`` (numpy views); the decision
        is cached on (seqlen, widest rank >= 2 leaf)."""
        width = max((int(np.shape(x)[1]) for x in batch.values() if np.ndim(x) >= 2),
                    default=0)
        if self._curr_seqlen_state == (seqlen, width, False):
            return batch
        need = width > seqlen
        self._curr_seqlen_state = (seqlen, width, need)
        return truncate_to_seqlen(batch, seqlen) if need else batch

    def _inject_pld(self, batch, leading: int, step: Optional[int] = None,
                    micro: Optional[int] = None):
        """PLD's theta and per-row seeds put in the batch, drawn from
        (seed, step[, micro]) so that prefetched and synchronous staging draw
        the same layers."""
        if self.progressive_layer_drop is None or not isinstance(batch, dict):
            return batch
        step = self.global_steps if step is None else step
        parts = (self.config.seed, step) if micro is None else (self.config.seed, step, micro)
        return inject_pld(batch, leading, self.progressive_layer_drop.theta_at(step),
                          mix_seed(*parts))

    def _stage(self, host: Mapping[str, np.ndarray]):
        """(device tree, copy event): the copy runs on the engine's own
        stream on the card."""
        return stage_tree(host, self.device, self._copy_stream)

    def _on_device(self, host: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch staged and ready on the current stream."""
        tree, ready = self._stage(host)
        return StagedBatch(tree, self.global_steps, ready=ready).wait()

    @staticmethod
    def _host_batch(batch) -> Dict[str, np.ndarray]:
        if not isinstance(batch, Mapping):
            raise TypeError(f"a batch is a dict of arrays (input_ids, ...), got {type(batch)}")
        return as_host_tree(batch)

    def _prepare_batch(self, batch, step: int) -> StagedBatch:
        """Stage a global batch for global step ``step``: curriculum
        truncation, PLD injection, the copy to the device. Runs on the
        caller's thread (prefetch 0, explicit batches) or on the
        PrefetchLoader's producer; everything schedule-dependent is keyed by
        ``step``, never read from the engine's counters."""
        host = self._host_batch(batch)
        for k, x in host.items():
            if np.shape(x)[:1] != (self.train_batch_size_,):
                raise ValueError(f"batch['{k}'] leading dim {np.shape(x)[:1]} != "
                                 f"train_batch_size {self.train_batch_size_}")
        seqlen = self._scheduled_seqlen(step)
        if seqlen is not None:
            host = self._apply_curriculum(host, seqlen)
        host = self._inject_pld(host, self.train_batch_size_, step=step)
        tree, ready = self._stage(host)
        return StagedBatch(tree, step, raw=batch, ready=ready)

    def _build_data_iterator(self):
        """The iterator over the engine's own loader: a RepeatingLoader
        (epochs bump and reshuffle), behind a PrefetchLoader staging on the
        device when ``train_pipeline.prefetch > 0``."""
        it = RepeatingLoader(self.training_dataloader)
        depth = self.config.train_pipeline.prefetch
        if depth > 0:
            it = PrefetchLoader(it, prepare=self._prepare_batch, prefetch=depth,
                                start_step=self.global_steps)
            self._prefetch_loader = it
        return iter(it)

    def _reset_data_iterator(self) -> None:
        """Drop the engine's iterator and stop its producer: staged batches
        are keyed to the step counter, which a checkpoint load moves."""
        if self._prefetch_loader is not None:
            self._prefetch_loader.close()
            self._prefetch_loader = None
        self._data_iterator = None

    # ---- gradients ---- #

    def _grad_fn(self, micro: Mapping[str, torch.Tensor], scale: torch.Tensor):
        """(loss, grads) of one micro-batch; grads of ``loss * scale``, in
        the parameters' order and dtype."""
        loss = self.module(micro)
        return loss.detach(), self._grads_of(loss * scale)

    def _grads_of(self, scaled: torch.Tensor) -> List[torch.Tensor]:
        """Gradients of ``scaled`` in the parameters' order; a parameter the
        forward did not use (a layer progressive layer drop skipped) gets
        zeros."""
        params = list(self._module_params.values())
        grads = torch.autograd.grad(scaled, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]

    def _accumulate(self, acc: Optional[List[torch.Tensor]], grads) -> List[torch.Tensor]:
        """``acc + grads`` in ``grad_accum_dtype`` (the first micro-batch's
        grads become the accumulator), a leaf at a time: each grad is
        dropped from ``grads`` once added, so no second full-width copy of
        the grads exists at once (an add promotes the compute dtype exactly,
        so the bits are those of adding the converted grads)."""
        dtype = self.config.grad_accum_dtype
        out = [] if acc is None else acc
        for i, g in enumerate(grads):
            if acc is None:
                out.append(g.to(dtype))
            else:
                out[i].add_(g)
            grads[i] = None
        return out

    def _mean_grads(self, acc: List[torch.Tensor], scale: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The accumulated grads as fp32, divided by ``gas * scale``."""
        grads = [g.float() for g in acc]
        torch._foreach_mul_(grads, 1.0 / (self.gas_ * scale))
        return dict(zip(self._module_params, grads))

    def _accumulate_grads(self, scale: torch.Tensor, batch: Mapping[str, torch.Tensor]):
        """Mean fp32 grads over the micro-batches (accumulated in
        ``grad_accum_dtype``) and the per-micro-batch losses."""
        acc, losses = None, []
        self._qwz_dequantize()
        for i in range(self.gas_):
            sl = slice(i * self.micro_batch_size_, (i + 1) * self.micro_batch_size_)
            loss, grads = self._grad_fn({k: v[sl] for k, v in batch.items()}, scale)
            acc = self._accumulate(acc, grads)
            del grads
            losses.append(loss)
        self._qwz_release()
        return self._mean_grads(acc, scale), torch.stack(losses)

    def _apply_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clip, check overflow, optimizer update on the fp32 master, cast
        back. Returns the step's device metrics. Under offload the
        host-flow grads leave as the wire (popped from ``grads`` as it is
        built, so their fp32 copies free before the device update) and the
        host step follows."""
        cfg, st = self.config, self.state
        fp16 = cfg.fp16
        gnorm = global_norm(grads)
        overflow = has_overflow(grads) if fp16.enabled else None
        if cfg.gradient_clipping > 0:
            # in place: the step's grads are its own fresh tensors, and a
            # second fp32 copy of them would sit under the optimizer's
            # temporaries at the step's memory peak
            cscale = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0)
            torch._foreach_mul_(list(grads.values()), cscale)
        lr = self._lr_fn(st["step"])
        wires = self._offload_wires(grads) if self._offload is not None else None
        with torch.no_grad():
            step = None
            for names in self._update_groups():
                step = self._update_leaves(grads, names, lr, overflow)
            st["opt"]["step"] = step
        overflowed = torch.zeros((), dtype=torch.bool, device=self.device) \
            if overflow is None else overflow
        scaler = update_loss_scale(
            dict(st["scaler"], dynamic=self._scaler_dynamic), overflowed,
            loss_scale_window=fp16.loss_scale_window, hysteresis=fp16.hysteresis,
            min_loss_scale=fp16.min_loss_scale)
        st["scaler"] = {k: scaler[k] for k in ("scale", "growth_tracker", "hysteresis")}
        st["step"] = st["step"] + (~overflowed).to(torch.int32)
        st["skipped"] = st["skipped"] + overflowed.to(torch.int32)
        metrics = {"grad_norm": gnorm, "lr": lr, "overflow": overflowed,
                   "loss_scale": st["scaler"]["scale"]}
        if wires is not None:
            self._offload_step(wires, metrics)
        return metrics

    def _update_groups(self) -> List[List[str]]:
        """The leaf groups the device update runs over, one after another:
        all of the master at once, or under offload groups of at most
        ``_DEVICE_UPDATE_ELEMS`` elements (a larger leaf alone), so the
        optimizer's temporaries stay one group's size. The update is
        elementwise within a leaf, so the groups give the same bits."""
        names = list(self.state["master"])
        if self._offload is None:
            return [names]
        groups, cur, size = [], [], 0
        for n in names:
            k = self.state["master"][n].numel()
            if cur and size + k > _DEVICE_UPDATE_ELEMS:
                groups.append(cur)
                cur, size = [], 0
            cur.append(n)
            size += k
        groups.append(cur)
        return groups

    def _update_leaves(self, grads, names: List[str], lr, overflow) -> torch.Tensor:
        """The optimizer update of the master leaves ``names``, written in
        place (the old state kept where the fp16 scaler saw an overflow:
        ``torch.where``, no host sync decides a skip) and cast into the
        params. Returns the optimizer's new step counter."""
        st = self.state
        if not names:
            # an empty device flow (offload ratio 1): only the counter steps
            step = st["opt"]["step"] + 1
            return step if overflow is None else torch.where(overflow, st["opt"]["step"], step)
        old_opt = {key: ({n: val[n] for n in names} if isinstance(val, dict) else val)
                   for key, val in st["opt"].items()}
        master = {n: st["master"][n] for n in names}
        new_master, new_opt = self.optimizer.update(grads, old_opt, master, lr=lr)
        if overflow is not None:
            # a skipped step keeps the old master and optimizer state
            keep = lambda old, new: torch.where(overflow, old, new)
            new_master = {n: keep(master[n], new_master[n]) for n in names}
            new_opt = {"step": keep(old_opt["step"], new_opt["step"]),
                       **{key: {n: keep(old_opt[key][n], new_opt[key][n]) for n in names}
                          for key in new_opt if key != "step"}}
        torch._foreach_copy_([master[n] for n in names], [new_master[n] for n in names])
        if self.quantized_weights:
            requantize_into(st["params"], master)
        elif self.mixed_precision:
            torch._foreach_copy_([st["params"][n] for n in names], [master[n] for n in names])
        for key, val in new_opt.items():
            if key != "step":
                st["opt"][key] = {**st["opt"][key], **val}
        return new_opt["step"]

    # ---- ZeRO-Offload step (the JAX engine's _offload_* methods) ---- #

    def _offload_wires(self, grads: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """The host-flow grads (already clipped) as one flat compute-dtype
        array a pipeline group, each leaf popped from ``grads`` as it lands
        (the JAX engine's "wire": half width under bf16; the host kernels
        upcast to fp32)."""
        wires = []
        for meta in self._offload_group_meta:
            flat = torch.empty((meta[-1][1] + meta[-1][2],), dtype=self.compute_dtype,
                               device=self.device)
            for k, off, n, _ in meta:
                flat[off:off + n].copy_(grads.pop(k).reshape(-1))
            wires.append(flat)
        return wires

    def _offload_step(self, wires: List[torch.Tensor], metrics) -> None:
        """Hand the step's wires to the host: the scalars the host needs
        (lr, grad norm, overflow) go down beside them. Synchronous, or under
        ``delayed_param_update`` on the worker while the next step runs."""
        scal = torch.stack([metrics["lr"].float().reshape(()), metrics["grad_norm"].float(),
                            metrics["overflow"].float()])
        job = {"wires": wires, "ready": None, "scalars": scal, "scalars_ready": None}
        if self._offload_streams is not None:
            copy_stream = self._offload_streams[0]
            ready = torch.cuda.Event()
            ready.record()
            copy_stream.wait_event(ready)
            with torch.cuda.stream(copy_stream):
                host = torch.empty(scal.shape, dtype=scal.dtype, pin_memory=True)
                host.copy_(scal, non_blocking=True)
                scal.record_stream(copy_stream)
                done = torch.cuda.Event()
                done.record(copy_stream)
            job.update(ready=ready, scalars=host, scalars_ready=done)
        if not self._offload_cfg.delayed_param_update:
            self._offload_host_step(job)
            return
        # Delayed Param Update: step N's host work runs while step N+1
        # computes; step N-1's update lands now, after this step's kernels
        self._drain_offload()
        if self._offload_executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._offload_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dstorch-offload")
        self._offload_pending = self._offload_executor.submit(self._offload_host_step, job)

    def _offload_host_step(self, job):
        """Run the host optimizer for one step. Pipelined (``overlap_step``,
        the default): each group's grad copy is queued ``_FETCH_AHEAD``
        groups ahead of its host kernel, and each finished group's master
        goes up on the upload lane while later groups step (on disk, the
        swapper double-buffers the state underneath). Serial
        (``overlap_step: false``): fetch every group, step every leaf,
        upload every group. The same bytes either way.

        Returns None once the params hold the update, or under
        ``delayed_param_update`` the staged (group, flat) uploads that
        :meth:`_drain_offload` copies in."""
        perf = time.perf_counter
        if job["scalars_ready"] is not None:
            job["scalars_ready"].synchronize()
        lr, gnorm, overflow = (float(x) for x in job["scalars"].tolist())
        if overflow:
            return None
        meta_groups = self._offload_group_meta
        if not meta_groups:
            return [] if self._offload_cfg.delayed_param_update else None
        delayed = self._offload_cfg.delayed_param_update
        canon_nan = not np.isfinite(gnorm) or self._offload_nonfinite
        fetch = self._offload_fetcher(job)
        stats = self.offload_stats

        if not self._offload_cfg.overlap_step:
            t0 = perf()
            host = [fetch(gi) for gi in range(len(meta_groups))]
            t1 = perf()
            views = {k: host[gi][off:off + n] for gi, meta in enumerate(meta_groups)
                     for k, off, n, _ in meta}
            updated = self._offload.step(views, lr)
            t2 = perf()
            staged = [(gi, self._offload_stage(gi, updated, canon_nan))
                      for gi in range(len(meta_groups))]
            if not delayed:
                for gi, flat in staged:
                    self._offload_apply(gi, flat)
            t3 = perf()
            stats.add("fetch", t1 - t0)
            stats.add("kernel", t2 - t1)
            stats.add("upload", t3 - t2)
            stats.record_step(groups=len(meta_groups), depth_sum=0)
            if _tracer.enabled:
                _tracer.add("train/offload/fetch", t0, t1, lane="train/offload")
                _tracer.add("train/offload/kernel", t1, t2, lane="train/offload")
                _tracer.add("train/offload/upload", t2, t3, lane="train/offload")
            return staged if delayed else None

        upload_stream = None if self._offload_streams is None else self._offload_streams[1]
        uploads: list = [None] * len(meta_groups)
        depth = {"sum": 0}

        def grad_views_for(gi):
            host = fetch(gi)
            return {k: host[off:off + n] for k, off, n, _ in meta_groups[gi]}

        def upload_group(gi, masters):
            t0 = perf()
            flat = self._offload_stage(gi, masters, canon_nan)
            if not delayed:
                if upload_stream is not None:
                    upload_stream.wait_event(job["ready"])
                self._offload_apply(gi, flat, upload_stream)
            t1 = perf()
            stats.add("upload", t1 - t0)
            if _tracer.enabled:
                _tracer.add("train/offload/upload", t0, t1, lane="train/offload/upload",
                            group=gi)
            # a copied group's pinned buffer goes back to the caching host
            # allocator now: only a delayed update keeps its staged groups
            return (gi, flat) if delayed else None

        def on_group_done(gi, masters):
            depth["sum"] += sum(1 for f in uploads if f is not None and not f.done())
            uploads[gi] = self._offload_uploader().submit(upload_group, gi, masters)

        self._offload.step_groups(grad_views_for, lr, on_group_done=on_group_done,
                                  record=stats.add)
        staged = [f.result() for f in uploads]
        stats.record_step(groups=len(meta_groups), depth_sum=depth["sum"])
        if delayed:
            return staged
        if upload_stream is not None:
            # the next step's kernels read the params the lane wrote
            torch.cuda.current_stream(self.device).wait_stream(upload_stream)
        return None

    def _offload_fetcher(self, job) -> Callable[[int], np.ndarray]:
        """``fetch(g)``: group g's grads as a flat fp32 host array. On the
        card each group's wire is copied into a pinned buffer on the copy
        stream (after the step's ``ready`` event), ``_FETCH_AHEAD`` groups
        ahead of the one asked for, with an event per group; ``fetch``
        waits for its own group's event only, and a group's device wire is
        released once its copy is queued."""
        wires = job["wires"]
        n_groups = len(wires)
        # the pipeline steps one group at a time, so two fp32 buffers taken
        # in turn hold every group's grads with no fresh pages a step (the
        # serial path holds all groups at once and allocates)
        bufs = self._offload_grad_buffers() if self._offload_cfg.overlap_step else None

        def to_f32(gi, host):
            return self._wire_to_f32(host, None if bufs is None else bufs[gi % 2])

        if self._offload_streams is None:
            return lambda gi: to_f32(gi, wires[gi])
        copy_stream = self._offload_streams[0]
        copy_stream.wait_event(job["ready"])
        pending: Dict[int, tuple] = {}

        def issue(gi):
            if gi >= n_groups or gi in pending or wires[gi] is None:
                return
            wire = wires[gi]
            with torch.cuda.stream(copy_stream):
                host = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
                host.copy_(wire, non_blocking=True)
                wire.record_stream(copy_stream)
                done = torch.cuda.Event()
                done.record(copy_stream)
            wires[gi] = None
            pending[gi] = (host, done)

        def fetch(gi):
            for j in range(gi, gi + 1 + _FETCH_AHEAD):
                issue(j)
            host, done = pending.pop(gi)
            done.synchronize()
            return to_f32(gi, host)

        return fetch

    def _offload_grad_buffers(self) -> List[np.ndarray]:
        """Two fp32 host buffers of the largest group's size, made once."""
        if self._offload_f32 is None:
            n = max(meta[-1][1] + meta[-1][2] for meta in self._offload_group_meta)
            self._offload_f32 = [np.empty((n,), np.float32) for _ in range(2)]
        return self._offload_f32

    @staticmethod
    def _wire_to_f32(host: torch.Tensor, buf: Optional[np.ndarray] = None) -> np.ndarray:
        """A host wire as fp32 numpy (bf16 through the native conversion),
        written into ``buf`` where one is given."""
        if host.dtype == torch.float32:
            return host.numpy()
        out = None if buf is None else buf[:host.numel()]
        if host.dtype == torch.bfloat16:
            return bf16_to_f32(host.view(torch.int16).numpy().view(np.uint16), out)
        if out is None:
            return host.float().numpy()
        torch.from_numpy(out).copy_(host)
        return out

    def _offload_stage(self, gi: int, masters: Mapping[str, np.ndarray],
                       canon_nan: bool) -> torch.Tensor:
        """Group ``gi``'s fp32 master cast to the compute dtype into one flat
        host buffer (pinned on the card), the JAX engine's ``astype``: bf16
        rounds to nearest even through the native conversion, and where a
        NaN can be present (``canon_nan``: a non-finite grad norm this step,
        or a loaded master that held one) NaNs become ml_dtypes' sign | 0x7FC0."""
        meta = self._offload_group_meta[gi]
        flat = torch.empty((meta[-1][1] + meta[-1][2],), dtype=self.compute_dtype,
                           pin_memory=self._offload_streams is not None)
        if self.compute_dtype == torch.bfloat16:
            bits = flat.view(torch.int16).numpy().view(np.uint16)
            for k, off, n, _ in meta:
                f32_to_bf16(np.asarray(masters[k], np.float32).reshape(-1), bits[off:off + n])
            if canon_nan:
                t = flat.view(torch.int16)
                nan = (t & 0x7FFF) > 0x7F80
                if bool(nan.any()):
                    t[nan] = (t[nan] & -0x8000) | 0x7FC0
        else:
            for k, off, n, _ in meta:
                flat[off:off + n].copy_(torch.from_numpy(
                    np.asarray(masters[k], np.float32).reshape(-1)))
        return flat

    def _offload_apply(self, gi: int, flat: torch.Tensor, stream=None) -> None:
        """Copy a staged group into the params, in place, on ``stream`` (the
        current stream by default)."""
        params = self.state["params"]
        with torch.no_grad(), torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext():
            for k, off, n, _ in self._offload_group_meta[gi]:
                params[k].view(-1).copy_(flat[off:off + n], non_blocking=flat.is_pinned())

    def _offload_uploader(self):
        """The upload lane: one worker thread."""
        if self._offload_upload_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._offload_upload_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dstorch-offload-upload")
        return self._offload_upload_pool

    def _drain_offload(self) -> None:
        """Wait for an in-flight delayed host step and copy its update into
        the params on the current stream (after every kernel queued so far).
        Called before the next step's host work, checkpoints, the bridge and
        destroy(): anything that must see the post-update params."""
        pending, self._offload_pending = self._offload_pending, None
        if pending is None:
            return
        staged = pending.result()
        for gi, flat in staged or ():
            self._offload_apply(gi, flat)

    def _loss_scale(self) -> torch.Tensor:
        return self.state["scaler"]["scale"] if self.config.fp16.enabled \
            else torch.ones((), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def train_batch(self, batch=None, data_iter: Optional[Iterator] = None) -> torch.Tensor:
        """One training step over a global batch of ``train_batch_size``
        rows: ``batch``, else the next of ``data_iter`` (host batches or a
        PrefetchLoader's staged ones), else the next of the engine's own
        data pipeline. Returns the mean loss as a 0-d DEVICE tensor; the
        previous step's metrics are drained while this one runs."""
        # mid-run preemption point: a DSTPU_FAULTS plan kills here
        fault_injection.maybe_fail("step.kill")
        perf = time.perf_counter
        t0 = perf()
        queue_depth = 0
        if batch is None:
            if data_iter is None:
                if self.training_dataloader is None:
                    raise ValueError("train_batch() needs a batch, a data_iter, or "
                                     "training_data passed to initialize()")
                if self._data_iterator is None:
                    self._data_iterator = self._build_data_iterator()
                data_iter = self._data_iterator
            batch = next(data_iter)
            if self._prefetch_loader is not None and data_iter is self._data_iterator:
                queue_depth = self._prefetch_loader.depth
        prefetched = isinstance(batch, StagedBatch)
        if prefetched and batch.step != self.global_steps \
                and self._staging_is_stale(batch.step):
            # the step counter moved outside the pipeline that staged this
            # batch (an explicit train_batch(batch), the facade, another
            # data_iter): restage its raw view for the current step
            if not self._warned_stale_staging:
                self._warned_stale_staging = True
                logger.warning("prefetched batch staged for step %d consumed at step %d: "
                               "restaging inline", batch.step, self.global_steps)
            batch, prefetched = batch.raw, False
        t1 = perf()
        if self.curriculum_scheduler is not None:
            self.curriculum_scheduler.update_difficulty(self.global_steps)
        fp_cfg = self.config.flops_profiler
        if fp_cfg.enabled and self.global_steps + 1 == fp_cfg.profile_step:
            raw = batch.raw if prefetched else batch
            if raw is not None:
                self._run_flops_profile(raw)
        self.tput_timer.start()
        self.timers(STEP_GLOBAL_TIMER).start()
        step_no = self.global_steps   # _after_step bumps it before t4
        staged = batch if prefetched else self._prepare_batch(batch, self.global_steps)
        tree = staged.wait()
        t2 = perf()
        scale = self._loss_scale()
        grads, losses = self._accumulate_grads(scale, tree)
        metrics = self._apply_grads(grads)
        metrics["loss"] = losses.mean()
        t3 = perf()
        # only wall_clock_breakdown syncs: otherwise the loop stays one step
        # ahead of the device
        sync = metrics["loss"] if self.config.wall_clock_breakdown else None
        self.timers(STEP_GLOBAL_TIMER).stop(sync_obj=sync)
        self.tput_timer.stop(sync_obj=sync)
        self._after_step(metrics)   # enqueue + one-step-late drain
        t4 = perf()
        self.train_stats.record_step(
            wait_s=(t1 - t0) if prefetched else 0.0,
            build_s=(t2 - t1) + (0.0 if prefetched else (t1 - t0)),
            dispatch_s=t3 - t2, drain_s=t4 - t3, wall_s=t4 - t0,
            queue_depth=queue_depth, prefetched=prefetched)
        if _tracer.enabled:
            # the same stamps as the stats, as spans nested under one
            # train/step span (inline staging counts t0..t1 into build)
            if prefetched:
                _tracer.add("train/step/dequeue_wait", t0, t1, lane="train/step",
                            step=step_no)
            _tracer.add("train/step/host_build", t1 if prefetched else t0, t2,
                        lane="train/step", step=step_no)
            _tracer.add("train/step/dispatch", t2, t3, lane="train/step", step=step_no)
            _tracer.add("train/step/drain", t3, t4, lane="train/step", step=step_no)
            _tracer.add("train/step", t0, t4, lane="train/step", step=step_no,
                        prefetched=prefetched)
            if queue_depth:
                _tracer.counter("train/prefetch/queue_depth", queue_depth, lane="train/step")
        return metrics["loss"]

    def train_steps(self, n_steps: int, data_iter: Optional[Iterator] = None) -> np.ndarray:
        """``n_steps`` steps back to back, then one drain; the per-step loss
        stream as a float32 ``[n_steps]`` array, read at the END."""
        losses = [self.train_batch(data_iter=data_iter) for _ in range(int(n_steps))]
        self.drain_metrics()
        if not losses:
            return np.zeros((0,), np.float32)
        return fetch_to_host(torch.stack(losses)).numpy().astype(np.float32)

    def _after_step(self, metrics: Dict[str, torch.Tensor],
                    count_micro_steps: bool = True) -> None:
        """Counters, PLD's theta and the metric ENQUEUE; the previous step's
        entry is drained now (``wall_clock_breakdown`` drains this one
        too). The facade counts its micro-steps in ``backward``."""
        self.global_steps += 1
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        self.global_samples += self.train_batch_size_
        if count_micro_steps:
            self.micro_steps += self.gas_
        self._last_metrics = metrics
        self._pending_metrics.append((self.global_steps, self.global_samples, metrics))
        self._drain_metric_queue(0 if self.config.wall_clock_breakdown else 1)
        if self._rolling is not None:
            # after the counters: a tag named rolling_step{N} holds the state
            # AFTER step N; save() drains the metric queue first
            self._rolling.maybe_save()

    def drain_metrics(self) -> None:
        """Flush every deferred metric entry (reading only those printed)."""
        self._drain_metric_queue(0)

    def _drain_metric_queue(self, leave: int) -> None:
        while len(self._pending_metrics) > leave:
            self._emit_metrics(*self._pending_metrics.popleft())

    def _run_flops_profile(self, batch) -> None:
        """Profile the model forward on the first micro-batch of ``batch``
        at ``profile_step`` (parity: the flops profiler's engine hooks):
        the per-module table, the counted flops and the latency, printed
        and, with a monitor sink on, written as ``train/flops/*``."""
        from deepspeed_tpu_torch.profiling import FlopsProfiler
        fp_cfg = self.config.flops_profiler
        prof = FlopsProfiler(fp_cfg)
        host = self._host_batch(batch)
        micro = self._on_device({k: v[:max(1, self.micro_batch_size_)]
                                 for k, v in host.items()})
        with self._qwz_weights():
            prof.start_profile(self.module, micro)
            prof.measure(self.module, micro)
        prof.print_model_profile(profile_step=fp_cfg.profile_step,
                                 module_depth=fp_cfg.module_depth,
                                 top_modules=fp_cfg.top_modules,
                                 detailed=fp_cfg.detailed,
                                 output_file=fp_cfg.output_file)
        if self.monitor.enabled:
            self.monitor.write_events(prof.events(step=self.global_samples,
                                                  top_modules=max(1, fp_cfg.top_modules)))
        self.flops_profiler = prof

    def _emit_metrics(self, step: int, samples: int, metrics) -> None:
        """Read one step's metrics on the host (one fetch through the drain
        point) and route them to the monitor and the ``steps_per_print``
        log; when neither reads them, the entry is dropped unread."""
        every = self.config.steps_per_print
        printing = bool(every and step % every == 0)
        if not (printing or self.monitor.enabled):
            return
        vals = fetch_to_host(metrics)
        if self.monitor.enabled:
            # the facade's step metrics carry no loss
            events = [("Train/Samples/lr", float(vals["lr"]), samples),
                      ("Train/Samples/grad_norm", float(vals["grad_norm"]), samples)]
            if "loss" in vals:
                events.insert(0, ("Train/Samples/train_loss", float(vals["loss"]), samples))
            if self.config.fp16.enabled:
                events.append(("Train/Samples/loss_scale", float(vals["loss_scale"]), samples))
            self.monitor.write_events(events)
            if printing:
                self.monitor.write_events(self.train_stats.events(samples))
                if self._offload is not None and self.offload_stats.steps:
                    self.monitor.write_events(self.offload_stats.events(samples))
                if self.ckpt_stats.saves:
                    self.monitor.write_events(self.ckpt_stats.events(samples))
        if printing:
            # the facade's step metrics carry no loss
            loss = float(vals["loss"]) if "loss" in vals else float("nan")
            logger.info("step=%d loss=%.4f lr=%.3e gnorm=%.3f", step, loss,
                        float(vals["lr"]), float(vals["grad_norm"]))
            if self.config.wall_clock_breakdown:
                self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER,
                                 STEP_GLOBAL_TIMER])

    @torch.no_grad()
    def eval_loss(self, batch) -> float:
        """Forward-only loss on a global batch (no state change)."""
        with self._qwz_weights():
            loss = self.module(self._on_device(self._host_batch(batch)))
        return float(fetch_to_host(loss))

    # ---- the forward/backward/step facade (JAX engine.py :1451-1500) ---- #

    def forward(self, batch) -> torch.Tensor:
        """One micro-batch's loss, with its autograd graph (the micro-batch
        is staged as ``train_batch`` stages its rows; PLD draws from (seed,
        global step, micro step), as in the JAX facade)."""
        host = self._host_batch(batch)
        leading = int(np.shape(next(iter(host.values())))[0])
        micro = self._on_device(self._inject_pld(host, leading, micro=self.micro_steps))
        sync = self.config.wall_clock_breakdown
        self.timers(FORWARD_GLOBAL_TIMER).start()
        self._qwz_dequantize()      # released by step()
        loss = self.module(micro)
        self.timers(FORWARD_GLOBAL_TIMER).stop(sync_obj=loss if sync else None)
        return loss

    __call__ = forward

    def backward(self, loss: torch.Tensor, **kwargs) -> torch.Tensor:
        """Gradients of ``loss * loss_scale`` accumulated into the buffer
        (in ``grad_accum_dtype``); one micro-step, timed as ``bwd`` (here
        backward runs autograd, as in DeepSpeed's engine)."""
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        grads = self._grads_of(loss * self._loss_scale())
        self._grad_buffer = self._accumulate(self._grad_buffer, grads)
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gas_ == 0

    def step(self) -> None:
        """Apply the accumulated gradients at an accumulation boundary
        (a no-op elsewhere)."""
        if not self.is_gradient_accumulation_boundary() or self._grad_buffer is None:
            return
        self.timers(STEP_GLOBAL_TIMER).start()
        grads = self._mean_grads(self._grad_buffer, self._loss_scale())
        self._grad_buffer = None
        self._qwz_release()
        metrics = self._apply_grads(grads)
        self.timers(STEP_GLOBAL_TIMER).stop()
        self._after_step(metrics, count_micro_steps=False)

    # ---- the data pipeline ---- #

    def deepspeed_io(self, dataset, batch_size: Optional[int] = None, collate_fn=None,
                     shuffle: bool = True, drop_last: bool = True) -> DeepSpeedTPUDataLoader:
        """A loader of global batches over ``dataset`` (shuffled from the
        config's ``seed``), as the JAX engine's."""
        return DeepSpeedTPUDataLoader(dataset, batch_size=batch_size or self.train_batch_size_,
                                      collate_fn=collate_fn, shuffle=shuffle,
                                      seed=self.config.seed, drop_last=drop_last)

    # ------------------------------------------------------------------ #
    # checkpoints (the JAX engine's save_checkpoint / load_checkpoint)
    # ------------------------------------------------------------------ #

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None, save_latest: bool = True):
        """Save the state under ``save_dir/tag`` (default tag:
        ``global_step<N>``) with the counters and ``client_state`` in its
        ``client_state.json``; ``latest`` flips after the commit."""
        self.drain_metrics()   # checkpoint boundary flushes deferred metrics
        tag = tag or f"global_step{self.global_steps}"
        client_state = dict(client_state or {})
        client_state.update({
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.get_skipped_steps(),
        })
        with _tracer.span("ckpt/save", lane="ckpt", tag=tag):
            save_engine_checkpoint(save_dir, tag, self.state, client_state,
                                   save_latest=save_latest,
                                   ckpt_engine=self._checkpoint_engine(),
                                   stats=self.ckpt_stats, snapshot=self.checkpoint_flats)
        return True

    def checkpoint_flats(self):
        """(model_flat, optim_flat): fresh host copies of the state under
        the checkpoint's flat keys. An offload engine drains its delayed
        host step first and adds the host-flow master and moments, so its
        tags hold the keys a plain engine's do (the JAX engine's
        ``_offload_ckpt_state``)."""
        model_flat, optim_flat = snapshot_state_flats(self.state)
        if self._offload is None:
            return model_flat, optim_flat
        self._drain_offload()
        host_master, moments = self._offload.state_leaves()
        model_flat.update(host_master)
        for key, leaves in moments.items():
            optim_flat.update({f"opt/{key}/{k}": v for k, v in leaves.items()})
        return model_flat, optim_flat

    def _offload_load_host(self, model_flat, optim_flat=None) -> None:
        """Load the host-flow leaves of a checkpoint (``optim_flat`` None:
        the master only) and recast their params from it, as the step's
        upload does (the JAX engine's ``_load_checkpoint_offload``)."""
        from deepspeed_tpu_torch.runtime.zero.offload import _STATE_KEYS
        host = self._offload_host_names
        master = {k: np.asarray(model_flat[k], np.float32) for k in host}
        moments, step_num = {}, None
        if optim_flat is not None:
            moments = {sk: {k: optim_flat[f"opt/{sk}/{k}"] for k in host}
                       for sk in _STATE_KEYS[self._offload.kind]
                       if all(f"opt/{sk}/{k}" in optim_flat for k in host)}
            step_num = int(optim_flat.get("opt/step", optim_flat.get("step", 0)))
        self._offload.load_master_leaves(master)
        if optim_flat is not None:
            self._offload.load_moment_leaves(moments, step_num=step_num)
        self._offload_nonfinite = not all(np.isfinite(v).all() for v in master.values())
        for gi in range(len(self._offload_group_meta)):
            self._offload_apply(gi, self._offload_stage(gi, master, self._offload_nonfinite))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _checkpoint_engine(self):
        """The configured checkpoint engine, built once."""
        if self._ckpt_engine is None:
            ck = self.config.checkpoint
            self._ckpt_engine = build_checkpoint_engine(
                ck.engine,
                config_params={"writers": ck.writers,
                               "writer_retries": ck.writer_retries,
                               "writer_backoff_s": ck.writer_backoff_s})
        return self._ckpt_engine

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False,
                        verify: Optional[bool] = None):
        """``verify=True`` checksums every loaded file against the tag's
        manifest (default: ``config.checkpoint.verify_load``). ``tag=None``
        resumes from the newest COMPLETE tag, skipping torn ones.
        ``load_lr_scheduler_states`` is accepted for DeepSpeed's signature
        and ignored: the lr schedule has no state of its own, it is a
        function of the restored ``step``. Returns
        ``(load_dir, client_state)``."""
        if verify is None:
            verify = self.config.checkpoint.verify_load
        # a pending delayed host step writes the state the load replaces
        self._drain_offload()
        self._qwz_release()     # a facade forward's values are stale after it
        self.drain_metrics()   # the pre-load stream's metrics land first
        # staged batches are keyed to the step counter the load moves
        self._reset_data_iterator()
        if self.config.checkpoint.load_universal:
            if tag is not None:
                logger.warning("load_universal: universal checkpoints are "
                               f"untagged directories; ignoring tag={tag!r}")
            client_state = load_universal_into_engine(
                self, load_dir, load_optimizer_states=load_optimizer_states,
                load_module_only=load_module_only)
            return load_dir, client_state
        _, client_state = load_engine_checkpoint(
            load_dir, tag, self.state, load_optimizer_states=load_optimizer_states,
            load_module_only=load_module_only, ckpt_engine=self._checkpoint_engine(),
            verify=verify, stats=self.ckpt_stats,
            host_loader=self._offload_load_host if self._offload is not None else None)
        self.global_steps = int(client_state.get("global_steps", 0))
        self.global_samples = int(client_state.get("global_samples", 0))
        self.micro_steps = int(client_state.get("micro_steps", 0))
        return load_dir, client_state

    def destroy(self):
        """Release host-side resources: the deferred metrics, an offload
        engine's pending host step, its worker and upload lane and its host
        optimizer (the kernel pool, the AIO handles), the rolling committer,
        the checkpoint engine's writers, then the monitor sinks; the trace
        exports last. A surfaced commit or writer error re-raises only after
        the whole teardown ran (with a crash dump of the trace). Idempotent."""
        self._reset_data_iterator()
        self.drain_metrics()
        err = None
        try:
            self._drain_offload()
        except BaseException as e:
            err = e
        for attr in ("_offload_executor", "_offload_upload_pool"):
            pool = getattr(self, attr)
            setattr(self, attr, None)
            if pool is not None:
                pool.shutdown(wait=True)
        if self._offload is not None:
            self._offload.close()
        if self._rolling is not None:
            # BEFORE the checkpoint engine closes: queued rolling commits
            # need live writer threads to drain against
            try:
                self._rolling.close()
            except BaseException as e:
                err = e
        close = getattr(self._ckpt_engine, "close", None)
        if close is not None:
            try:
                close()
            except BaseException as e:
                if err is None:
                    err = e
        # after the last drain: the final step's events reach the sinks
        self.monitor.close()
        if err is not None:
            # the timeline that led to a surfaced teardown error
            _tracer.crash_dump(f"engine destroy: {type(err).__name__}")
            raise err
        _tracer.export()

    # ------------------------------------------------------------------ #
    # getters
    # ------------------------------------------------------------------ #

    def train_batch_size(self) -> int:
        return self.train_batch_size_

    def gradient_accumulation_steps(self) -> int:
        return self.gas_

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def get_lr(self):
        return [float(fetch_to_host(self._lr_fn(self.state["step"])))]

    def get_global_grad_norm(self) -> Optional[float]:
        m = self._last_metrics.get("grad_norm")
        return float(fetch_to_host(m)) if m is not None else None

    def get_skipped_steps(self) -> int:
        return int(fetch_to_host(self.state["skipped"]))
