"""The training engine on one device, as the JAX package's
``runtime/engine.py`` ``DeepSpeedTPUEngine``.

The state keeps the JAX engine's keys: ``master`` (fp32 weights), ``opt``
(the optimizer's state), ``step``, ``scaler`` (the loss-scaler state),
``skipped`` and, under mixed precision, ``params`` (the weights in the
compute dtype). ``params`` ARE the module's parameters, which autograd
differentiates; in fp32 the module's parameters are ``master`` itself, as
the JAX engine then uses ``master`` as its params. Every counter and scalar
of a step stays on the device:

- ``train_batch`` splits the global batch into ``gradient_accumulation_steps``
  micro-batches (a Python loop where the JAX engine scans), accumulates their
  gradients in ``grad_accum_dtype`` and divides by ``gas * loss_scale``;
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

ZeRO stages 0-3 are accepted and are the identity here: on a world of one
device there is nothing to partition, as in the JAX partitioner with
fsdp = 1. A mesh, or a ``torch.distributed`` world of more than one rank,
raises ``NotImplementedError``, as do the forward/backward/step facade,
``training_data`` (the data pipeline) and offload, which later slices
port.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint import (RollingCheckpointer, build_checkpoint_engine,
                                            load_engine_checkpoint,
                                            load_universal_into_engine,
                                            save_engine_checkpoint)
from deepspeed_tpu_torch.checkpoint.convert import params_from_flat
from deepspeed_tpu_torch.config import DeepSpeedTPUConfig
from deepspeed_tpu_torch.monitor import CheckpointStats
from deepspeed_tpu_torch.ops import TPUOptimizer, build_optimizer
from deepspeed_tpu_torch.runtime.loss_scaler import (has_overflow, make_loss_scale_state,
                                                     update_loss_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import build_lr_schedule
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
                 mesh_topology=None, config=None, device=None):
        self.config = DeepSpeedTPUConfig.load(config)
        if mesh_topology is not None:
            raise _unported("mesh_topology (a device mesh)")
        if torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise _unported(f"a world of {torch.distributed.get_world_size()} ranks")
        if training_data is not None:
            raise _unported("training_data (the engine's data pipeline)")
        if model is None:
            raise ValueError("initialize() requires a model")
        self.device = resolve_device(device)
        self.train_batch_size_, self.micro_batch_size_, self.gas_ = \
            self.config.resolve_batch(1)
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
        self._init_state(model_parameters)

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

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        if not isinstance(batch, Mapping):
            raise TypeError(f"a batch is a dict of arrays (input_ids, ...), got {type(batch)}")
        out = {}
        for k, x in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) \
                else torch.as_tensor(x)
            out[k] = t.to(self.device)
        return out

    def _grad_fn(self, micro: Mapping[str, torch.Tensor], scale: torch.Tensor):
        """(loss, grads) of one micro-batch; grads of ``loss * scale``, in
        the parameters' order and dtype."""
        params = list(self._current_params().values())
        scaled = self.module(micro) * scale
        grads = torch.autograd.grad(scaled, params)
        return scaled.detach() / scale, grads

    def _accumulate_grads(self, scale: torch.Tensor, batch: Mapping[str, torch.Tensor]):
        """Mean fp32 grads over the micro-batches (accumulated in
        ``grad_accum_dtype``) and the per-micro-batch losses."""
        accum_dtype = self.config.grad_accum_dtype
        acc, losses = None, []
        for i in range(self.gas_):
            sl = slice(i * self.micro_batch_size_, (i + 1) * self.micro_batch_size_)
            loss, grads = self._grad_fn({k: v[sl] for k, v in batch.items()}, scale)
            grads = [g.to(accum_dtype) for g in grads]
            acc = grads if acc is None else torch._foreach_add(acc, grads)
            losses.append(loss)
        inv = 1.0 / (self.gas_ * scale)
        grads = torch._foreach_mul([g.float() for g in acc], inv)
        return dict(zip(self._current_params(), grads)), torch.stack(losses)

    def _apply_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Clip, check overflow, optimizer update on the fp32 master, cast
        back. Returns the step's device metrics."""
        cfg, st = self.config, self.state
        fp16 = cfg.fp16
        gnorm = global_norm(grads)
        overflow = has_overflow(grads) if fp16.enabled else None
        if cfg.gradient_clipping > 0:
            cscale = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0)
            grads = dict(zip(grads, torch._foreach_mul(list(grads.values()), cscale)))
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

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def train_batch(self, batch=None, data_iter: Optional[Iterator] = None) -> torch.Tensor:
        """One training step over a global batch of ``train_batch_size``
        rows (or the next batch of ``data_iter``). Returns the mean loss as
        a 0-d DEVICE tensor; the previous step's metrics are drained while
        this one runs."""
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch() needs a batch or a data_iter")
            batch = next(data_iter)
        batch = self._to_device(batch)
        for k, v in batch.items():
            if v.shape[0] != self.train_batch_size_:
                raise ValueError(f"batch['{k}'] leading dim {v.shape[0]} != "
                                 f"train_batch_size {self.train_batch_size_}")
        scale = self.state["scaler"]["scale"] if self.config.fp16.enabled \
            else torch.ones((), dtype=torch.float32, device=self.device)
        grads, losses = self._accumulate_grads(scale, batch)
        metrics = self._apply_grads(grads)
        metrics["loss"] = losses.mean()
        self._after_step(metrics)
        return metrics["loss"]

    def train_steps(self, n_steps: int, data_iter: Optional[Iterator] = None) -> np.ndarray:
        """``n_steps`` steps back to back, then one drain; the per-step loss
        stream as a float32 ``[n_steps]`` array, read at the END."""
        losses = [self.train_batch(data_iter=data_iter) for _ in range(int(n_steps))]
        self.drain_metrics()
        if not losses:
            return np.zeros((0,), np.float32)
        return fetch_to_host(torch.stack(losses)).numpy().astype(np.float32)

    def _after_step(self, metrics: Dict[str, torch.Tensor]) -> None:
        """Counters and the metric ENQUEUE; the previous step's entry is
        drained now (``wall_clock_breakdown`` drains this one too)."""
        self.global_steps += 1
        self.global_samples += self.train_batch_size_
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
        logger.info("step=%d loss=%.4f lr=%.3e gnorm=%.3f", step, float(vals["loss"]),
                    float(vals["lr"]), float(vals["grad_norm"]))

    @torch.no_grad()
    def eval_loss(self, batch) -> float:
        """Forward-only loss on a global batch (no state change)."""
        return float(fetch_to_host(self.module(self._to_device(batch))))

    def forward(self, batch):
        raise _unported("the forward/backward/step facade (use train_batch)")

    backward = step = forward

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
