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
- metrics are queued and read ONE STEP LATE, and only when they are printed;
  every device->host read goes through :func:`fetch_to_host`.

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
fsdp = 1. A mesh, or a ``torch.distributed`` world of more than one rank,
raises ``NotImplementedError``, as do offload and a client optimizer that
is not a ``TPUOptimizer``, which later slices port.
"""

from __future__ import annotations

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
from deepspeed_tpu_torch.config import DeepSpeedTPUConfig
from deepspeed_tpu_torch.data.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.monitor import CheckpointStats, TrainPipelineStats
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
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.tree import global_norm

logger = logging.getLogger("deepspeed_tpu_torch")


def fetch_to_host(tree):
    """THE device->host read of the training engine: a tensor, or a dict of
    them, copied to the host (this blocks on the device). Nothing else in
    this module reads device values."""
    if isinstance(tree, Mapping):
        return {k: fetch_to_host(v) for k, v in tree.items()}
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
        # deferred metric drain: (step, device metrics) entries
        self._pending_metrics: deque = deque()
        self.train_stats = TrainPipelineStats()
        # ZeRO++ qwZ's int8 parameter storage is not ported: the params are
        # always full width here (the flag keeps the JAX engine's name)
        self.quantized_weights = False
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
        fp16 = self.config.fp16
        scaler = make_loss_scale_state(fp16.enabled, fp16.loss_scale,
                                       fp16.initial_scale_power, fp16.hysteresis,
                                       device=self.device)
        self._scaler_dynamic = scaler.pop("dynamic")
        self.state: Dict[str, Any] = {
            "master": master, "opt": self.optimizer.init(master),
            "step": torch.zeros((), dtype=torch.int32, device=self.device),
            "scaler": scaler,
            "skipped": torch.zeros((), dtype=torch.int32, device=self.device)}
        if self.mixed_precision:
            self.state["params"] = dict(named)

    def _current_params(self) -> Dict[str, torch.Tensor]:
        return self.state["params"] if self.mixed_precision else self.state["master"]

    def rollout_source_params(self) -> Dict[str, torch.Tensor]:
        """The device-resident tree the colocated ``WeightBridge``
        (``runtime/colocated.py``) casts from: ``state["master"]``, the fp32
        master by flax name, exactly what ``ds_to_universal`` serialises
        (so the bridge is the universal checkpoint's path without the
        disk). Nothing is copied. Quantized weights are refused in the JAX
        engine's words; its other branch, the merged params of a cpu-offload
        engine, waits for offload's port (the config refuses offload by
        name)."""
        if self.quantized_weights:
            raise NotImplementedError(
                "colocated weight sync from a quantized-weight (ZeRO++ qwZ) "
                "engine is not wired — the bridge would have to dequantize "
                "per sync; train unquantized or sync via checkpoint")
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
        params = list(self._current_params().values())
        grads = torch.autograd.grad(scaled, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]

    def _accumulate(self, acc: Optional[List[torch.Tensor]], grads) -> List[torch.Tensor]:
        """``acc + grads`` in ``grad_accum_dtype`` (the first micro-batch's
        grads become the accumulator)."""
        grads = [g.to(self.config.grad_accum_dtype) for g in grads]
        if acc is None:
            return grads
        torch._foreach_add_(acc, grads)
        return acc

    def _mean_grads(self, acc: List[torch.Tensor], scale: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The accumulated grads as fp32, divided by ``gas * scale``."""
        grads = [g.float() for g in acc]
        torch._foreach_mul_(grads, 1.0 / (self.gas_ * scale))
        return dict(zip(self._current_params(), grads))

    def _accumulate_grads(self, scale: torch.Tensor, batch: Mapping[str, torch.Tensor]):
        """Mean fp32 grads over the micro-batches (accumulated in
        ``grad_accum_dtype``) and the per-micro-batch losses."""
        acc, losses = None, []
        for i in range(self.gas_):
            sl = slice(i * self.micro_batch_size_, (i + 1) * self.micro_batch_size_)
            loss, grads = self._grad_fn({k: v[sl] for k, v in batch.items()}, scale)
            acc = self._accumulate(acc, grads)
            del grads
            losses.append(loss)
        return self._mean_grads(acc, scale), torch.stack(losses)

    def _apply_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clip, check overflow, optimizer update on the fp32 master, cast
        back. Returns the step's device metrics."""
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
        names = list(st["master"])
        with torch.no_grad():
            new_master, new_opt = self.optimizer.update(grads, st["opt"], st["master"],
                                                        lr=lr)
            if overflow is not None:
                # a skipped step keeps the old master and optimizer state
                keep = lambda old, new: torch.where(overflow, old, new)
                new_master = {n: keep(st["master"][n], new_master[n]) for n in names}
                new_opt = {"step": keep(st["opt"]["step"], new_opt["step"]),
                           **{key: {n: keep(st["opt"][key][n], new_opt[key][n])
                                    for n in names}
                              for key in new_opt if key != "step"}}
            torch._foreach_copy_([st["master"][n] for n in names],
                                 [new_master[n] for n in names])
            if self.mixed_precision:
                torch._foreach_copy_([st["params"][n] for n in names],
                                     [st["master"][n] for n in names])
        st["opt"] = new_opt
        overflowed = torch.zeros((), dtype=torch.bool, device=self.device) \
            if overflow is None else overflow
        scaler = update_loss_scale(
            dict(st["scaler"], dynamic=self._scaler_dynamic), overflowed,
            loss_scale_window=fp16.loss_scale_window, hysteresis=fp16.hysteresis,
            min_loss_scale=fp16.min_loss_scale)
        st["scaler"] = {k: scaler[k] for k in ("scale", "growth_tracker", "hysteresis")}
        st["step"] = st["step"] + (~overflowed).to(torch.int32)
        st["skipped"] = st["skipped"] + overflowed.to(torch.int32)
        return {"grad_norm": gnorm, "lr": lr, "overflow": overflowed,
                "loss_scale": st["scaler"]["scale"]}

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
        t0 = time.perf_counter()
        if batch is None:
            if data_iter is None:
                if self.training_dataloader is None:
                    raise ValueError("train_batch() needs a batch, a data_iter, or "
                                     "training_data passed to initialize()")
                if self._data_iterator is None:
                    self._data_iterator = self._build_data_iterator()
                data_iter = self._data_iterator
            batch = next(data_iter)
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
        wait_s = time.perf_counter() - t0
        if self.curriculum_scheduler is not None:
            self.curriculum_scheduler.update_difficulty(self.global_steps)
        staged = batch if prefetched else self._prepare_batch(batch, self.global_steps)
        tree = staged.wait()
        scale = self._loss_scale()
        grads, losses = self._accumulate_grads(scale, tree)
        metrics = self._apply_grads(grads)
        metrics["loss"] = losses.mean()
        self._after_step(metrics)
        self.train_stats.record_step(wait_s if prefetched else 0.0, prefetched)
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
        self._pending_metrics.append((self.global_steps, metrics))
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

    def _emit_metrics(self, step: int, metrics) -> None:
        """Read one step's metrics on the host, only when printed."""
        every = self.config.steps_per_print
        if not (every and step % every == 0):
            return
        vals = fetch_to_host(metrics)
        # the facade's step metrics carry no loss
        loss = float(vals["loss"]) if "loss" in vals else float("nan")
        logger.info("step=%d loss=%.4f lr=%.3e gnorm=%.3f", step, loss,
                    float(vals["lr"]), float(vals["grad_norm"]))

    @torch.no_grad()
    def eval_loss(self, batch) -> float:
        """Forward-only loss on a global batch (no state change)."""
        return float(fetch_to_host(self.module(self._on_device(self._host_batch(batch)))))

    # ---- the forward/backward/step facade (JAX engine.py :1451-1500) ---- #

    def forward(self, batch) -> torch.Tensor:
        """One micro-batch's loss, with its autograd graph (the micro-batch
        is staged as ``train_batch`` stages its rows; PLD draws from (seed,
        global step, micro step), as in the JAX facade)."""
        host = self._host_batch(batch)
        leading = int(np.shape(next(iter(host.values())))[0])
        return self.module(self._on_device(
            self._inject_pld(host, leading, micro=self.micro_steps)))

    __call__ = forward

    def backward(self, loss: torch.Tensor, **kwargs) -> torch.Tensor:
        """Gradients of ``loss * loss_scale`` accumulated into the buffer
        (in ``grad_accum_dtype``); one micro-step."""
        grads = self._grads_of(loss * self._loss_scale())
        self._grad_buffer = self._accumulate(self._grad_buffer, grads)
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps % self.gas_ == 0

    def step(self) -> None:
        """Apply the accumulated gradients at an accumulation boundary
        (a no-op elsewhere)."""
        if not self.is_gradient_accumulation_boundary() or self._grad_buffer is None:
            return
        grads = self._mean_grads(self._grad_buffer, self._loss_scale())
        self._grad_buffer = None
        self._after_step(self._apply_grads(grads), count_micro_steps=False)

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
        save_engine_checkpoint(save_dir, tag, self.state, client_state,
                               save_latest=save_latest,
                               ckpt_engine=self._checkpoint_engine(),
                               stats=self.ckpt_stats)
        return True

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
            verify=verify, stats=self.ckpt_stats)
        self.global_steps = int(client_state.get("global_steps", 0))
        self.global_samples = int(client_state.get("global_samples", 0))
        self.micro_steps = int(client_state.get("micro_steps", 0))
        return load_dir, client_state

    def destroy(self):
        """Release host-side resources: the deferred metrics, the rolling
        committer, then the checkpoint engine's writers. A surfaced commit
        or writer error re-raises only after the whole teardown ran.
        Idempotent."""
        self._reset_data_iterator()
        self.drain_metrics()
        err = None
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
        if err is not None:
            raise err

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
