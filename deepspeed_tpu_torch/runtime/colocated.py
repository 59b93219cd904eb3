"""Colocated rollout: the train->serve weight sync on one card (the JAX
package's ``runtime/colocated.py``).

RLHF-style loops interleave training with generation from the freshly
updated policy. The portable way to move weights between the two engines
is the universal checkpoint (``save_checkpoint`` -> ``ds_to_universal`` ->
``load_universal``): every tensor crosses to the host, hits the disk and is
uploaded again. When the trainer and the server share the card, both
layouts already live there, and the train->serve mapping (cast to the
serving dtype, then the family adapter that places each tensor) is work
the card does where the data is.

:class:`WeightBridge` runs that mapping from the trainer's fp32 master
(``rollout_source_params``) with the serving engine's own adapter
(``ragged_model.adapt_model``, the one its constructor runs), so the bridge
adds no layout code of its own and its bytes are a fresh engine's. No
weight byte crosses to the host. ``donate=False`` returns a fresh tree for
``swap_weights`` to rebind; ``donate=True`` (the port's form of the JAX
bridge's buffer donation) writes every serving tensor in place, each a
``copy_`` of its source slice cast on the way, so a sync needs no new
device memory, and refuses to run while the engine holds live sequences
(their KV would meet the new weights).

:class:`RolloutLoop` drives the cycle on top: ``generate`` (the serving
frontend produces the rollouts) -> train (they feed the trainer through
the same ``PrefetchLoader`` staging ordinary data takes) -> ``sync`` ->
``swap`` (the rebind at a run boundary, the prefix cache flushed by
weight version, no new step-cache entry). Every phase is stamped once; the
same stamps feed the ``train/rollout/{sync,swap,generate}`` tracer spans
and :class:`~deepspeed_tpu_torch.monitor.training.RolloutStats`.
"""

from __future__ import annotations

import logging
import queue
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.checkpoint.state import flatten_tree
from deepspeed_tpu_torch.inference.v2.ragged_model import adapt_model
from deepspeed_tpu_torch.monitor.trace import tracer as _tracer
from deepspeed_tpu_torch.monitor.training import RolloutStats
from deepspeed_tpu_torch.runtime.data_pipeline import PrefetchLoader

__all__ = ["WeightBridge", "RolloutLoop"]

logger = logging.getLogger("deepspeed_tpu_torch")

#: serving leaves an adapter derives from another leaf of the tree rather
#: than reading a parameter (``ragged_model._tie_head``): a donating sync
#: writes them from their landed source
_DERIVED = {"embed_f32": "embed"}


class _CastParams(Mapping):
    """A flat parameter tree read as fresh copies in ``dtype``, name by
    name (a copy even where the dtype already matches, so the serving tree
    never aliases the trainer's master)."""

    def __init__(self, src: Mapping[str, torch.Tensor], dtype: torch.dtype):
        self.src, self.dtype = src, dtype

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.src[name].detach().to(dtype=self.dtype, copy=True)

    def __contains__(self, name) -> bool:
        return name in self.src

    def __iter__(self):
        return iter(self.src)

    def __len__(self) -> int:
        return len(self.src)


def _nbytes(tree) -> int:
    """Bytes of a tree's distinct tensors (a view that repeats another
    leaf, as a tied head's f32 embedding in an f32 tree, counts once)."""
    seen = {(t.data_ptr(), tuple(t.shape), t.stride()): t.nbytes
            for t in flatten_tree(tree).values()}
    return sum(seen.values())


class WeightBridge:
    """The cast + adapter from a training engine's master into a serving
    engine's weight layout, on the card (see the module docstring).

    The first :meth:`sync` checks the layout once: the adapter runs over
    ``meta`` tensors of the master's shapes, and its names, shapes and
    dtypes must be the live serving tree's. ``compiles`` counts these
    builds (1 after any number of syncs). :meth:`manifest` gives the
    universal checkpoint's flat names; ``nbytes`` is the serving tree's
    size."""

    def __init__(self, train_engine, serve_engine, *, donate: bool = True):
        cfg = serve_engine.config
        if cfg.quantization.weight_bits in (4, 8):
            raise NotImplementedError(
                "colocated weight sync into a weight-quantized serving "
                "engine is not wired: the bridge emits the adapter's "
                "unquantized layout, but this engine serves "
                f"int{cfg.quantization.weight_bits} packed weights — "
                "requantization is future work")
        self.train = train_engine
        self.serve = serve_engine
        self.donate = bool(donate)
        self.compiles = 0
        self.stats = RolloutStats()
        self.nbytes = _nbytes(serve_engine.weights)
        self._built = False

    def manifest(self) -> List[str]:
        """Source tensor names, as the universal checkpoint files them."""
        return sorted(flatten_tree(self.train.rollout_source_params()).keys())

    def _adapt(self, params: Mapping[str, torch.Tensor]) -> Dict:
        serve = self.serve
        _, w = adapt_model(serve.family, params, serve.model_config,
                           max_context=serve.config.state_manager.max_context)
        return w

    def _build(self, src: Mapping[str, torch.Tensor]) -> None:
        """Fail at build time, with the serving tree's names, rather than
        deep inside the first step: the adapter over ``meta`` tensors of
        the source's shapes must reproduce the live serving layout."""
        serve = self.serve
        want = flatten_tree(serve.weights)
        where = next(iter(want.values())).device
        off = sorted({str(t.device) for t in src.values() if t.device != where})
        if off:
            raise ValueError(
                f"train->serve sync: the training master lives on {off}, the "
                f"serving engine on {where} — the colocated bridge casts "
                "where both engines' weights live")
        meta = {k: torch.empty(t.shape, dtype=t.dtype, device="meta") for k, t in src.items()}
        got = flatten_tree(self._adapt(_CastParams(meta, serve.config.dtype)))
        bad = [k for k in want
               if k not in got
               or tuple(got[k].shape) != tuple(want[k].shape)
               or got[k].dtype != want[k].dtype]
        if bad or set(got) != set(want):
            raise ValueError(
                "train->serve reshard does not reproduce the serving "
                f"layout; mismatched tensors: {sorted(set(bad) | (set(got) ^ set(want)))[:8]}"
                " — the training module and the serving model_config "
                "disagree about the architecture")
        self._built = True
        self.compiles += 1
        logger.info("colocated: train->serve layout checked (%.1f MiB serving layout)",
                    self.nbytes / 2 ** 20)

    @torch.no_grad()
    def _write_in_place(self, src: Mapping[str, torch.Tensor]) -> Dict:
        """Every serving tensor overwritten by its source slice, cast in the
        copy (the adapter over the uncast master gives views of it and
        allocates nothing); derived leaves are rewritten from their landed
        source. Returns the serving tree itself."""
        weights = self.serve.weights
        dst = flatten_tree(weights)
        views = flatten_tree(self._adapt(src))
        for path, d in dst.items():
            if path.rpartition("/")[2] not in _DERIVED:
                d.copy_(views[path])
        for path, d in dst.items():
            head, _, leaf = path.rpartition("/")
            if leaf in _DERIVED:
                s = dst[f"{head}/{_DERIVED[leaf]}" if head else _DERIVED[leaf]]
                if d.data_ptr() != s.data_ptr():
                    d.copy_(s)
        return weights

    def sync(self, *, wait: bool = True):
        """Run the cast + adapter; returns the serving-layout weight tree.

        The caller hands the result to ``swap_weights`` (or use
        :meth:`sync_and_swap`). ``wait`` waits on the card before the span
        closes; ``wait=False`` returns with the copies queued."""
        serve = self.serve
        if self.donate and serve.scheduler.seqs:
            raise RuntimeError(
                "donating sync with live sequences on the serving engine — "
                "the old weights are forfeit once the program runs, so the "
                "engine must be quiesced (drain or preempt) first; use "
                "ServingFrontend.swap_weights for the full quiesce+swap, "
                "or WeightBridge(donate=False)")
        t0 = time.perf_counter()
        src = self.train.rollout_source_params()
        if not self._built:
            self._build(src)
        if self.donate:
            new_w = self._write_in_place(src)
        else:
            with torch.no_grad():
                new_w = self._adapt(_CastParams(src, serve.config.dtype))
        if wait and serve.device.type == "cuda":
            torch.cuda.synchronize(serve.device)
        t1 = time.perf_counter()
        if _tracer.enabled:
            _tracer.add("train/rollout/sync", t0, t1, lane="train/rollout",
                        nbytes=self.nbytes, donate=self.donate)
        self.stats.record_sync(t1 - t0, nbytes=self.nbytes)
        return new_w

    def sync_and_swap(self, frontend=None, *, version: Optional[int] = None,
                      timeout: Optional[float] = None) -> int:
        """``sync`` then swap into the live engine; returns the new weight
        version. With a frontend the swap runs on the serving thread at a
        run boundary (in-flight decode quiesced as preemption quiesces it);
        a bare-engine swap needs the engine idle."""
        new_w = self.sync()
        fstats = getattr(frontend, "stats", None)
        pre = (fstats.recompute_preemptions, fstats.forced_sheds) \
            if fstats is not None else (0, 0)
        t0 = time.perf_counter()
        if frontend is not None:
            ver = frontend.swap_weights(new_w, version=version, timeout=timeout)
        else:
            ver = self.serve.swap_weights(new_w, version=version)
        t1 = time.perf_counter()
        post = (fstats.recompute_preemptions, fstats.forced_sheds) \
            if fstats is not None else (0, 0)
        preempted, shed = post[0] - pre[0], post[1] - pre[1]
        if _tracer.enabled:
            _tracer.add("train/rollout/swap", t0, t1, lane="train/rollout",
                        version=ver, preempted=preempted, shed=shed)
        self.stats.record_swap(t1 - t0, version=ver, preempted=preempted, shed=shed)
        return ver


_CLOSE = object()


class RolloutLoop:
    """Interleaved train + generate loop on one card.

    Per round: the serving frontend generates rollouts from the current
    policy (``generate``), ``collate_fn`` turns them into a host batch that
    feeds the training engine through the same ``PrefetchLoader`` staging
    path ordinary data takes, the engine trains ``steps_per_round`` steps,
    and the bridge syncs and swaps the updated weights into the live
    frontend, so the NEXT round generates on-policy. The serving engine is
    never rebuilt.

    ``prompt_fn(round) -> list of token-id sequences`` supplies the prompts;
    ``collate_fn(rollouts) -> host batch`` maps the finished ``(prompt,
    tokens)`` pairs to the batch the training module eats.
    """

    def __init__(self, train_engine, frontend, *,
                 prompt_fn: Callable[[int], Sequence[Sequence[int]]],
                 collate_fn: Callable[[List[Tuple[List[int], List[int]]]], Any],
                 bridge: Optional[WeightBridge] = None,
                 steps_per_round: int = 1,
                 max_new_tokens: int = 16,
                 prefetch: int = 1,
                 request_timeout: float = 120.0):
        self.engine = train_engine
        self.frontend = frontend
        self.bridge = bridge or WeightBridge(train_engine, frontend.engine)
        self.stats = self.bridge.stats
        self.prompt_fn = prompt_fn
        self.collate_fn = collate_fn
        self.steps_per_round = int(steps_per_round)
        self.max_new_tokens = int(max_new_tokens)
        self.request_timeout = float(request_timeout)
        self._queue: "queue.Queue" = queue.Queue()
        self._loader = PrefetchLoader(self._feed(), prefetch=int(prefetch),
                                      prepare=train_engine._prepare_batch,
                                      start_step=train_engine.global_steps)
        self._closed = False

    def _feed(self):
        while True:
            item = self._queue.get()
            if item is _CLOSE:
                return
            yield item

    def _generate(self, rnd: int) -> List[Tuple[List[int], List[int]]]:
        t0 = time.perf_counter()
        prompts = [list(p) for p in self.prompt_fn(rnd)]
        handles = [self.frontend.submit(p, max_new_tokens=self.max_new_tokens)
                   for p in prompts]
        outs = [h.result(timeout=self.request_timeout) for h in handles]
        t1 = time.perf_counter()
        tokens = sum(len(o) for o in outs)
        if _tracer.enabled:
            _tracer.add("train/rollout/generate", t0, t1, lane="train/rollout",
                        requests=len(outs), tokens=tokens)
        self.stats.record_generate(t1 - t0, requests=len(outs), tokens=tokens)
        return list(zip(prompts, outs))

    def run(self, rounds: int, *, align: bool = True) -> List[Any]:
        """Drive ``rounds`` full cycles; returns the per-round loss arrays.

        ``align=True`` first syncs and swaps once before any generation, so
        round 0 is already on-policy (the serving engine may have been
        built from stale initial parameters)."""
        if self._closed:
            raise RuntimeError("rollout loop is closed")
        if self.frontend._thread is None or not self.frontend._thread.is_alive():
            self.frontend.start()
        if align:
            self.bridge.sync_and_swap(self.frontend)
        losses: List[Any] = []
        for rnd in range(int(rounds)):
            rollouts = self._generate(rnd)
            self._queue.put(self.collate_fn(rollouts))
            losses.append(self.engine.train_steps(self.steps_per_round,
                                                  data_iter=self._loader))
            self.bridge.sync_and_swap(self.frontend)
        return losses

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._queue.put(_CLOSE)
        self._loader.close()
