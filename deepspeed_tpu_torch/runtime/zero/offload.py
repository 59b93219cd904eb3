"""ZeRO-Offload / ZeRO-Infinity host-side optimizer (the JAX package's
``runtime/zero/offload.py``).

The fp32 master and the optimizer's moments of the host-flow leaves live
in host RAM (``device: cpu``) or in files on disk (``device: nvme``), and
the host steps them with the OpenMP kernels of ``ops/native``
(``HostAdam``/``HostLion``/``HostAdagrad`` over ``csrc/ds_native.cpp``);
the card keeps the compute-dtype params. On disk the state is stepped in
sub-groups through ``PipelinedOptimizerSwapper`` (double-buffered
read/step/write). ``ratio < 1.0`` is ZeRO-Offload++'s twin flow: the
largest leaves (a ``1 - ratio`` share of the elements) keep their state on
the card and step there (``partition_leaves``).

Leaves are addressed by ``/``-joined flax names, the checkpoint layer's
keys, so the state round-trips through save/load unchanged.

The steady-state step is a three-stage group pipeline: the host-flow
leaves are chunked into groups (``leaf_groups()``, the sub-group sizing the
NVMe swapper uses) and ``step_groups`` walks them so that while group *g*
runs its host kernel, group *g+1*'s grads are still coming down (the
engine queues each group's copy ahead) and group *g-1*'s updated master is
already going up on the engine's upload lane; on disk the swapper
double-buffers the state reads and writes underneath. By default the host
kernel runs on the stepping thread with an OpenMP team of every core;
``host_workers > 1`` fans leaf chunks across a worker pool instead (the
native kernels run under ctypes, which releases the GIL), each worker's
team sized to its share of the cores. One worker is the default where
JAX's is up to four: on an 8-core H100 host the two read the same memory
bandwidth (``chip_smoke.py`` phase 24), and spinning teams beside the
engine's own threads oversubscribe the cores on small leaves. Every
kernel is elementwise, so the chunked walk is bit-identical to the
serial one. This module touches numpy arrays only; the engine owns every
device copy.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.config import OffloadDeviceEnum, OffloadOptimizerConfig
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.ops.native.builder import load_native
from deepspeed_tpu_torch.ops.native.cpu_optimizer import HostAdagrad, HostAdam, HostLion
from deepspeed_tpu_torch.runtime.swap_tensor import PipelinedOptimizerSwapper
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.threads import make_lock


def _host_kernel(optimizer, backend: str = "openmp") -> Tuple[str, Any]:
    """The host step kernel of an engine optimizer: Adam/AdamW, Lion or
    Adagrad (their host-offloaded names included); LAMB and SGD are refused
    in the JAX package's words."""
    from deepspeed_tpu_torch.ops.adagrad import Adagrad
    from deepspeed_tpu_torch.ops.adam import FusedAdam
    from deepspeed_tpu_torch.ops.lion import FusedLion
    if isinstance(optimizer, FusedAdam):
        return "adam", HostAdam(lr=optimizer.lr, betas=optimizer.betas,
                                eps=optimizer.eps,
                                weight_decay=optimizer.weight_decay,
                                adamw_mode=optimizer.adam_w_mode,
                                bias_correction=optimizer.bias_correction,
                                backend=backend)
    if isinstance(optimizer, FusedLion):
        return "lion", HostLion(lr=optimizer.lr, betas=optimizer.betas,
                                weight_decay=optimizer.weight_decay, backend=backend)
    if isinstance(optimizer, Adagrad):
        return "adagrad", HostAdagrad(lr=optimizer.lr, eps=optimizer.eps,
                                      weight_decay=optimizer.weight_decay,
                                      backend=backend)
    raise ValueError(
        f"offload_optimizer does not support {type(optimizer).__name__}; "
        "use adam/adamw/adagrad/lion")


def omp_team(workers: int) -> int:
    """OpenMP threads for each of ``workers`` host-kernel workers: the
    cores shared out, so ``workers`` parallel regions at once do not
    oversubscribe the host."""
    return max(1, (os.cpu_count() or 1) // max(1, workers))


def _set_omp_team(n: int) -> None:
    """Size the calling thread's OpenMP team (``omp_set_num_threads`` of
    the OpenMP runtime the native library links)."""
    fn = getattr(load_native(), "omp_set_num_threads", None)
    if fn is not None:
        fn(int(n))


#: state-tree keys per kernel kind (torch-compatible naming, as the device
#: optimizers use)
_STATE_KEYS = {"adam": ("exp_avg", "exp_avg_sq"), "lion": ("exp_avg",),
               "adagrad": ("exp_avg_sq",)}

#: leaves larger than this are split into contiguous chunks across the worker
#: pool; the host kernels are elementwise, so chunking never changes a byte
_CHUNK_ELEMS = 1 << 21


class HostOffloadOptimizer:
    """Owns host-resident master fp32 + optimizer moments for a subset of leaves.

    ``host_names`` (chosen by ``partition_leaves``) step here; the remaining
    leaves keep device state and step in the engine's device update.
    """

    def __init__(self, optimizer, master_leaves: Dict[str, np.ndarray],
                 offload_cfg: OffloadOptimizerConfig, backend: str = "openmp"):
        self.kind, self.kernel = _host_kernel(optimizer, backend)
        self.cfg = offload_cfg
        # bumped by step()/step_groups() — the serial caller-thread path
        # and the engine's single-worker offload lane are exclusive by
        # engine mode (overlap_step), never concurrent
        self.step_num = 0  # threadlint: guarded-by=none
        self.nvme = offload_cfg.device == OffloadDeviceEnum.nvme
        self._names: List[str] = list(master_leaves)
        self._shapes = {k: v.shape for k, v in master_leaves.items()}
        self.swapper: Optional[PipelinedOptimizerSwapper] = None
        # pipeline groups: buffer_count leaves per group unless group_size
        # overrides — the SAME chunks _nvme_groups expands into swap names,
        # so grad fetch, kernel, and state swap move in lock-step
        per_group = max(1, int(getattr(offload_cfg, "group_size", 0)
                               or offload_cfg.buffer_count))
        self._groups: List[List[str]] = [
            self._names[i:i + per_group]
            for i in range(0, len(self._names), per_group)]
        workers = int(getattr(offload_cfg, "host_workers", 0)) or 1
        self._workers = max(1, workers)
        self._kernel_pool = None   # lazy ThreadPoolExecutor
        self._pool_lock = make_lock("offload.pool.create")

        state_keys = _STATE_KEYS[self.kind]
        if not self.nvme:
            # np.array copies: the host kernels mutate the master in place
            self.master = {k: np.array(v, np.float32) for k, v in master_leaves.items()}
            self.moments = {sk: {k: np.zeros(v.shape, np.float32)
                                 for k, v in master_leaves.items()}
                            for sk in state_keys}
            return

        if not offload_cfg.nvme_path:
            raise ValueError("offload_optimizer.device=nvme requires nvme_path")
        swap_dir = os.path.join(offload_cfg.nvme_path, "zero_stage_offload")
        self.swapper = PipelinedOptimizerSwapper(
            swap_dir,
            pipeline_read=offload_cfg.pipeline_read,
            pipeline_write=offload_cfg.pipeline_write,
            max_pooled_buffers=max(4, 2 * offload_cfg.buffer_count * (1 + len(state_keys))),
            io_retries=offload_cfg.io_retries,
            io_timeout_s=offload_cfg.io_timeout_s)
        self.master = None
        self.moments = None
        for k, v in master_leaves.items():
            self.swapper.register(f"master/{k}", np.ascontiguousarray(v, np.float32))
            for sk in state_keys:
                self.swapper.register(f"{sk}/{k}", np.zeros(v.shape, np.float32))
        logger.info(f"NVMe offload: {len(self._names)} leaves -> {swap_dir}")

    # ------------------------------------------------------------------ #
    # step
    # ------------------------------------------------------------------ #

    def step(self, grads: Dict[str, np.ndarray], lr: float,
             grad_scale: float = 1.0) -> Dict[str, np.ndarray]:
        """SERIAL in-place optimizer step on host leaves; returns updated
        master views. This is the pre-pipeline baseline path
        (``overlap_step: false``): every leaf steps on the caller's thread,
        one after another. ``step_groups`` runs the identical math through
        the overlapped group pipeline.

        ``grad_scale`` folds gradient clipping (and any loss-scale remainder)
        into the host step without an extra pass.
        """
        self.step_num += 1
        state_keys = _STATE_KEYS[self.kind]
        updated: Dict[str, np.ndarray] = {}

        def step_leaf(name: str, p: np.ndarray, moment_arrays: Sequence[np.ndarray]):
            g = np.ascontiguousarray(grads[name].reshape(-1), np.float32)
            if grad_scale != 1.0:
                g = g * np.float32(grad_scale)
            flat = p.reshape(-1)
            self.kernel.step(self.step_num, flat, g,
                             *[m.reshape(-1) for m in moment_arrays], lr=lr)

        if not self.nvme:
            for name in self._names:
                step_leaf(name, self.master[name],
                          [self.moments[sk][name] for sk in state_keys])
                updated[name] = self.master[name]
            return updated

        groups = self._nvme_groups()

        def group_step(views: Dict[str, np.ndarray]):
            for name in {n.split("/", 1)[1] for n in views}:
                p = views[f"master/{name}"]
                step_leaf(name, p, [views[f"{sk}/{name}"] for sk in state_keys])
                updated[name] = np.array(p, np.float32)  # copy before buffer reuse

        self.swapper.run(groups, group_step)
        return updated

    # -- the pipelined step ------------------------------------------------ #

    def leaf_groups(self) -> List[List[str]]:
        """The pipeline's leaf-group partition (host-flow names, in step
        order). The engine derives its per-group flat grad layout from this,
        and ``_nvme_groups`` expands the SAME chunks into swap names."""
        return [list(g) for g in self._groups]

    def _pool(self):
        # double-checked: the serial path and the offload lane can both
        # reach first use — an unguarded lazy init could build two pools
        # and leak the loser's threads
        if self._kernel_pool is None:
            with self._pool_lock:
                if self._kernel_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    init = None
                    if self.kernel.backend == "openmp":
                        init = functools.partial(_set_omp_team, omp_team(self._workers))
                    self._kernel_pool = ThreadPoolExecutor(
                        max_workers=self._workers,
                        thread_name_prefix="dstpu-hostopt", initializer=init)
        return self._kernel_pool

    def _leaf_tasks(self, p: np.ndarray, g: np.ndarray,
                    moments: Sequence[np.ndarray], lr: float):
        """Zero-arg callables stepping contiguous chunks of one flat leaf.
        The kernels are elementwise, so chunk boundaries never change a
        byte vs the serial step."""
        step_num = self.step_num
        n = p.size
        if n <= _CHUNK_ELEMS or self._workers <= 1:
            yield lambda: self.kernel.step(step_num, p, g, *moments, lr=lr)
            return
        for lo in range(0, n, _CHUNK_ELEMS):
            hi = min(n, lo + _CHUNK_ELEMS)
            yield (lambda lo=lo, hi=hi:
                   self.kernel.step(step_num, p[lo:hi], g[lo:hi],
                                    *[m[lo:hi] for m in moments], lr=lr))

    def _run_group_kernel(self, items, lr: float) -> None:
        """Step every leaf of one group; ``items`` is a list of
        ``(p_flat, g_flat, moment_flats)``. Chunks fan across the worker
        pool (ctypes/OpenMP and numpy inner loops both release the GIL).
        Each chunk records a span on ITS worker's track (threads
        ``dstpu-hostopt_*``), so the fan-out is visible on the timeline."""
        tasks = [t for p, g, ms in items for t in self._leaf_tasks(p, g, ms, lr)]
        if self._workers <= 1 or len(tasks) <= 1:
            for t in tasks:
                t()
            return
        futs = [self._pool().submit(self._traced_task, t) for t in tasks]
        for f in futs:
            f.result()

    @staticmethod
    def _traced_task(task) -> None:
        with _tracer.span("train/offload/kernel_chunk"):
            task()

    def step_groups(self, grad_views_for: Callable[[int], Dict[str, np.ndarray]],
                    lr: float, grad_scale: float = 1.0,
                    on_group_done: Optional[Callable] = None,
                    record: Optional[Callable] = None) -> None:
        """Pipelined host step over ``leaf_groups()``.

        ``grad_views_for(g)`` returns ``{leaf name: fp32 1-D grad}`` for
        group *g*, blocking only until THAT group's grads are host-resident
        (the engine queues each group's copy ahead, so group g+1's fetch is
        in flight while group g's kernel runs). ``on_group_done(g, masters)``
        fires the moment group *g*'s update lands; ``masters`` maps leaf name
        -> fp32 array safe to hand to the upload thread (RAM mode: the stable
        master storage; NVMe mode: a copy made before the pooled swap buffer
        is recycled). ``record(phase, seconds)`` accumulates 'fetch' /
        'kernel' / 'swap' phase timings.

        Identical math to :meth:`step` — the kernels are elementwise and the
        group/chunk walk covers the same leaves with the same ``step_num``.
        """
        perf = time.perf_counter
        rec = record if record is not None else (lambda phase, s: None)
        done = on_group_done if on_group_done is not None else (lambda g, m: None)
        if not self._groups:
            return
        self.step_num += 1
        state_keys = _STATE_KEYS[self.kind]

        def leaf_item(p, moments, g):
            g = np.ascontiguousarray(g.reshape(-1), np.float32)
            if grad_scale != 1.0:
                g = g * np.float32(grad_scale)
            return (p.reshape(-1), g, [m.reshape(-1) for m in moments])

        if not self.nvme:
            for gi, names in enumerate(self._groups):
                t0 = perf()
                grads = grad_views_for(gi)
                t1 = perf()
                self._run_group_kernel(
                    [leaf_item(self.master[n],
                               [self.moments[sk][n] for sk in state_keys],
                               grads[n]) for n in names], lr)
                t2 = perf()
                rec("fetch", t1 - t0)
                rec("kernel", t2 - t1)
                if _tracer.enabled:
                    _tracer.add("train/offload/fetch", t0, t1,
                                lane="train/offload", group=gi)
                    _tracer.add("train/offload/kernel", t1, t2,
                                lane="train/offload", group=gi)
                done(gi, {n: self.master[n] for n in names})
            return

        # NVMe: the double-buffered state swapper composes underneath: its
        # sub-groups are the SAME leaf groups, so while group g's kernel
        # runs, g+1's state read and grad copy are both in flight and g-1's
        # state write drains on the third AIO handle.
        counter = {"g": 0, "inside": 0.0}
        t_run0 = perf()

        def step_fn(views: Dict[str, np.ndarray]):
            gi = counter["g"]
            counter["g"] += 1
            names = self._groups[gi]
            t0 = perf()
            grads = grad_views_for(gi)
            t1 = perf()
            self._run_group_kernel(
                [leaf_item(views[f"master/{n}"],
                           [views[f"{sk}/{n}"] for sk in state_keys],
                           grads[n]) for n in names], lr)
            # copy out before the pooled swap buffer is reused downstream
            masters = {n: np.array(views[f"master/{n}"], np.float32)
                       for n in names}
            t2 = perf()
            rec("fetch", t1 - t0)
            rec("kernel", t2 - t1)
            if _tracer.enabled:
                _tracer.add("train/offload/fetch", t0, t1,
                            lane="train/offload", group=gi)
                _tracer.add("train/offload/kernel", t1, t2,
                            lane="train/offload", group=gi)
            counter["inside"] += t2 - t0
            done(gi, masters)

        self.swapper.run(self._nvme_groups(), step_fn)
        rec("swap", (perf() - t_run0) - counter["inside"])

    def _nvme_groups(self) -> List[List[str]]:
        """Sub-groups of swap names — the pipeline's ``leaf_groups()``
        expanded to master+moment keys (parity: stage3 sub_group_size
        slicing for the optimizer swapper)."""
        state_keys = _STATE_KEYS[self.kind]
        groups = []
        for chunk in self._groups:
            group = []
            for name in chunk:
                group.append(f"master/{name}")
                group.extend(f"{sk}/{name}" for sk in state_keys)
            groups.append(group)
        return groups

    # ------------------------------------------------------------------ #
    # state materialisation (checkpoint save/load)
    # ------------------------------------------------------------------ #

    def state_leaves(self) -> Tuple[Dict[str, np.ndarray],
                                    Dict[str, Dict[str, np.ndarray]]]:
        """(master, moments) in one pass — one NVMe read of the swap state."""
        state_keys = _STATE_KEYS[self.kind]
        if not self.nvme:
            # frozen COPIES, not the live arrays: host Adam mutates master/
            # moments in place, and callers hand these leaves to background
            # checkpoint writers (or bench snapshot/restore) that must not
            # observe the next step's values
            return ({k: np.array(v, np.float32) for k, v in self.master.items()},
                    {sk: {k: np.array(v, np.float32)
                          for k, v in self.moments[sk].items()}
                     for sk in state_keys})
        all_t = self.swapper.read_all()
        master = {k[len("master/"):]: v for k, v in all_t.items()
                  if k.startswith("master/")}
        moments = {sk: {k[len(sk) + 1:]: v for k, v in all_t.items()
                        if k.startswith(sk + "/")} for sk in state_keys}
        return master, moments

    def master_leaves(self) -> Dict[str, np.ndarray]:
        return self.state_leaves()[0]

    def moment_leaves(self) -> Dict[str, Dict[str, np.ndarray]]:
        return self.state_leaves()[1]

    def load_master_leaves(self, leaves: Dict[str, np.ndarray]) -> None:
        for k, v in leaves.items():
            if k not in self._names:
                continue
            if self.nvme:
                self.swapper.write(f"master/{k}", np.asarray(v, np.float32))
            else:
                self.master[k][...] = np.asarray(v, np.float32).reshape(self._shapes[k])

    def load_moment_leaves(self, moments: Dict[str, Dict[str, np.ndarray]],
                           step_num: Optional[int] = None) -> None:
        for sk, leaves in moments.items():
            if sk not in _STATE_KEYS[self.kind]:
                continue
            for k, v in leaves.items():
                if k not in self._names:
                    continue
                if self.nvme:
                    self.swapper.write(f"{sk}/{k}", np.asarray(v, np.float32))
                else:
                    self.moments[sk][k][...] = np.asarray(v, np.float32).reshape(self._shapes[k])
        if step_num is not None:
            self.step_num = int(step_num)

    def close(self):
        with self._pool_lock:
            pool, self._kernel_pool = self._kernel_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if self.swapper is not None:
            self.swapper.close()


def partition_leaves(leaves: Dict[str, np.ndarray], ratio: float
                     ) -> Tuple[List[str], List[str]]:
    """Split leaf names into (host, device) sets by element count.

    ``ratio`` is the fraction of optimizer elements stepped on host
    (``offload_optimizer.ratio``, the ZeRO-Offload++ twin-flow knob). Largest
    leaves stay on device first.
    """
    if ratio >= 1.0:
        return list(leaves), []
    if ratio <= 0.0:
        return [], list(leaves)
    total = sum(int(np.prod(v.shape)) for v in leaves.values())
    budget = ratio * total
    # smallest-first go to host until the budget is filled
    order = sorted(leaves, key=lambda k: int(np.prod(leaves[k].shape)))
    host, device, used = [], [], 0
    for name in order:
        n = int(np.prod(leaves[name].shape))
        if used + n <= budget or not host:
            host.append(name)
            used += n
        else:
            device.append(name)
    return host, device
