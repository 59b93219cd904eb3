"""Flops profiler: per-module flops/MACs breakdown + end-to-end numbers (the
JAX package's ``profiling/flops_profiler.py``).

Parity: ``deepspeed/profiling/flops_profiler/profiler.py:28 FlopsProfiler``.

- **per-module attribution**: forward hooks on every submodule during one
  forward under ``torch.no_grad()``, with the JAX package's analytic MAC
  formulas per layer type (its flax layer names: ``Dense``, ``Embed``,
  ``LayerNorm``, ``RMSNorm``; the port's models carry the same class names
  and call them as the flax models do, but for the flax Llama's one-row
  ``lm_head`` call that only makes its kernel: the port's chunked loss
  reads the head's weight without calling the module). Paths are
  ``named_modules()`` names with ``.`` -> ``/``, the flax module paths;
  counts roll up the tree by path, as in the JAX package.
- **end-to-end flops**: ``torch.utils.flop_counter.FlopCounterMode`` over
  one forward (every matmul, the chunked LM head included, and K1's
  forward through its registered formula). The JAX package reads XLA's
  ``cost_analysis()`` here, which also counts elementwise work, so the two
  end-to-end counts differ; the events name this one ``flops_counted``.
- **latency**: ``measure()`` times ``n_iters`` forwards between device
  synchronizations.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.utils.logging import logger


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _shape_of(x):
    return tuple(getattr(x, "shape", ()))


# --------------------------------------------------------------------------- #
# Analytic MACs per layer type (the JAX package's table, by flax class name)
# --------------------------------------------------------------------------- #

def _dense_macs(mod, args, out) -> int:
    return _numel(_shape_of(out)) * int(args[0].shape[-1])


def _norm_flops(mod, args, out) -> int:
    return 5 * _numel(_shape_of(args[0]))


def _embed_macs(mod, args, out) -> int:
    return 0  # gather only


_MAC_FNS: Dict[str, Callable] = {
    "Dense": _dense_macs,
    "Embed": _embed_macs,
}
_FLOP_FNS: Dict[str, Callable] = {
    "LayerNorm": _norm_flops,
    "RMSNorm": _norm_flops,
}


@dataclass
class ModuleProfile:
    path: str
    type_name: str
    macs: int = 0
    flops: int = 0
    params: int = 0
    calls: int = 0
    children: List[str] = field(default_factory=list)


def _sync(out) -> None:
    """Wait for the device a forward's output (the loss, or the logits) is
    on."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


class FlopsProfiler:
    """Parity: ``FlopsProfiler`` (``profiling/flops_profiler/profiler.py:28``).

    Usage (the reference's start/stop/print discipline)::

        prof = FlopsProfiler(config=cfg.flops_profiler)
        prof.start_profile(module, batch)   # one hooked forward
        prof.measure(fn, *args)             # optional: counted + timed forwards
        prof.print_model_profile()
        prof.end_profile()
    """

    def __init__(self, config=None):
        self.config = config
        self.modules: Dict[str, ModuleProfile] = {}
        self.total_macs = 0
        self.total_flops_analytic = 0
        self.total_params = 0
        self.counted_flops: Optional[float] = None
        self.latency_s: Optional[float] = None
        self.started = False

    # -------------------------------------------------------------- #
    # per-module attribution
    # -------------------------------------------------------------- #

    def start_profile(self, module=None, batch=None, **forward_kwargs):
        """Run ``module(batch)`` once under ``torch.no_grad()`` with a
        forward hook on every submodule, attributing MACs to each (parity:
        start_profile + module hooks). The hooks are removed afterwards."""
        self.modules = {}
        self.total_macs = 0
        self.total_flops_analytic = 0
        self.total_params = 0
        self.started = True
        if module is None:
            return
        profiles = self.modules

        def hook_for(path: str):
            def hook(mod, args, out):
                tname = type(mod).__name__
                prof = profiles.get(path)
                if prof is None:
                    prof = profiles[path] = ModuleProfile(path=path, type_name=tname)
                    parent = "/".join(path.split("/")[:-1]) or "<root>"
                    if parent != path and parent in profiles:
                        profiles[parent].children.append(path)
                prof.calls += 1
                try:
                    if tname in _MAC_FNS:
                        macs = int(_MAC_FNS[tname](mod, args, out))
                        prof.macs += macs
                        prof.flops += 2 * macs
                    elif tname in _FLOP_FNS:
                        prof.flops += int(_FLOP_FNS[tname](mod, args, out))
                except Exception:  # defensive: unknown arg structures
                    pass
            return hook

        handles = [mod.register_forward_hook(hook_for(name.replace(".", "/") or "<root>"))
                   for name, mod in module.named_modules()]
        try:
            with torch.no_grad():
                out = module(batch, **forward_kwargs)
            _sync(out)
        finally:
            for h in handles:
                h.remove()

        # roll leaf counts up the tree and count params
        for path, prof in sorted(self.modules.items(), key=lambda kv: -kv[0].count("/")):
            parent = "/".join(path.split("/")[:-1]) or "<root>"
            if parent != path and parent in self.modules:
                self.modules[parent].macs += prof.macs
                self.modules[parent].flops += prof.flops
        root = self.modules.get("<root>")
        if root is not None:
            self.total_macs = root.macs
            self.total_flops_analytic = root.flops
        else:
            self.total_macs = sum(p.macs for p in self.modules.values() if "/" not in p.path)
            self.total_flops_analytic = sum(p.flops for p in self.modules.values()
                                            if "/" not in p.path)
        self.total_params = sum(p.numel() for p in module.parameters())

    # -------------------------------------------------------------- #
    # end-to-end measurement
    # -------------------------------------------------------------- #

    def measure(self, fn: Callable, *args, n_iters: int = 3) -> Dict[str, float]:
        """Count ``fn(*args)``'s flops with ``FlopCounterMode`` (one call,
        under ``torch.no_grad()``), then time ``n_iters`` calls between
        device synchronizations (parity: the reference's latency hooks and
        ``get_total_duration``)."""
        from torch.utils.flop_counter import FlopCounterMode
        with torch.no_grad():
            counter = FlopCounterMode(display=False)
            with counter:
                out = fn(*args)
            _sync(out)
            self.counted_flops = float(counter.get_total_flops())
            t0 = time.perf_counter()
            for _ in range(n_iters):
                out = fn(*args)
            _sync(out)
        self.latency_s = (time.perf_counter() - t0) / n_iters
        return {"flops": self.counted_flops, "latency_s": self.latency_s}

    # -------------------------------------------------------------- #
    # accessors (API parity)
    # -------------------------------------------------------------- #

    def get_total_flops(self, as_string: bool = False):
        total = self.counted_flops if self.counted_flops else self.total_flops_analytic
        return _num_to_string(total) if as_string else total

    def get_total_macs(self, as_string: bool = False):
        return _num_to_string(self.total_macs) if as_string else self.total_macs

    def get_total_params(self, as_string: bool = False):
        return _num_to_string(self.total_params) if as_string else self.total_params

    def get_total_duration(self, as_string: bool = False):
        d = self.latency_s or 0.0
        return f"{d * 1e3:.2f} ms" if as_string else d

    def stop_profile(self):
        self.started = False

    def end_profile(self):
        self.modules = {}
        self.started = False

    # -------------------------------------------------------------- #
    # monitor events (train/flops/* beside train/pipeline/*)
    # -------------------------------------------------------------- #

    def events(self, step: int = 0, top_modules: int = 8):
        """Monitor-ready ``(name, value, step)`` tuples: end-to-end totals
        plus the ``top_modules`` heaviest modules by MACs. Call BEFORE
        ``end_profile`` (which drops the per-module tree)."""
        ev = [
            ("train/flops/params", float(self.total_params), step),
            ("train/flops/macs", float(self.total_macs), step),
            ("train/flops/flops", float(self.get_total_flops()), step),
        ]
        if self.counted_flops is not None:
            ev.append(("train/flops/flops_counted", float(self.counted_flops), step))
        if self.latency_s:
            ev.append(("train/flops/latency_ms", self.latency_s * 1e3, step))
            flops = self.counted_flops or self.total_flops_analytic
            if flops:
                ev.append(("train/flops/achieved_tflops", flops / self.latency_s / 1e12, step))
        ranked = sorted((p for p in self.modules.values()
                         if p.path != "<root>" and (p.macs or p.flops)),
                        key=lambda p: (-p.macs, -p.flops, p.path))
        for prof in ranked[:max(0, int(top_modules))]:
            ev.append((f"train/flops/module/{prof.path}", float(prof.flops), step))
        return ev

    # -------------------------------------------------------------- #
    # report
    # -------------------------------------------------------------- #

    def print_model_profile(self, profile_step: int = 1, module_depth: int = -1,
                            top_modules: int = 1, detailed: bool = True,
                            output_file: Optional[str] = None):
        """Parity: ``print_model_profile``: summary block + per-module tree."""
        lines = []
        lines.append("-" * 72)
        lines.append("DeepSpeed-TPU Flops Profiler")
        lines.append("-" * 72)
        lines.append(f"profile step:                   {profile_step}")
        lines.append(f"params:                         {self.get_total_params(True)}")
        lines.append(f"MACs (analytic):                {self.get_total_macs(True)}")
        lines.append(f"flops (analytic):               {_num_to_string(self.total_flops_analytic)}")
        if self.counted_flops is not None:
            lines.append(f"flops (FlopCounterMode):        {_num_to_string(self.counted_flops)}")
        if self.latency_s:
            lines.append(f"latency:                        {self.latency_s * 1e3:.2f} ms")
            flops = self.counted_flops or self.total_flops_analytic
            if flops:
                lines.append(f"achieved:                       "
                             f"{flops / self.latency_s / 1e12:.2f} TFLOPS")
        if detailed and self.modules:
            lines.append("")
            lines.append(f"{'module':<44} {'params':>9} {'MACs':>9} {'flops':>9}")
            for path in sorted(self.modules):
                depth = path.count("/") + 1
                if module_depth >= 0 and depth > module_depth:
                    continue
                p = self.modules[path]
                indent = "  " * (depth - 1)
                name = f"{indent}{path.split('/')[-1]} ({p.type_name})"
                lines.append(f"{name:<44} {_num_to_string(p.params):>9} "
                             f"{_num_to_string(p.macs):>9} {_num_to_string(p.flops):>9}")
        lines.append("-" * 72)
        report = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(report + "\n")
        else:
            logger.info("\n" + report)
        return report


def _num_to_string(num) -> str:
    num = float(num)
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(num) >= div:
            return f"{num / div:.2f} {unit}"
    return f"{num:.0f}"


def get_model_profile(module, batch, measure: bool = False) -> Tuple[float, int, int]:
    """One-shot convenience (parity: ``get_model_profile``): ``(flops, macs,
    params)`` for ``module`` applied to ``batch``."""
    prof = FlopsProfiler()
    prof.start_profile(module, batch)
    if measure:
        prof.measure(module, batch)
    return prof.get_total_flops(), prof.get_total_macs(), prof.get_total_params()
