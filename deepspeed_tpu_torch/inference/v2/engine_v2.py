"""Inference engine v2 — continuous batching over a paged KV cache, in PyTorch.

``put(uids, tokens) -> logits``, ``query``, ``can_schedule``, ``flush``, plus
``generate`` driving continuous batching, as in the JAX package's engine.

Per pass:

    host: DynamicSplitFuseScheduler builds RaggedBatch descriptor arrays
      |                                   (``scheduler.py``)
    device: ragged forward — loop over layers; in-place paged KV write +
      chunk/decode attention kernels      (``ragged_model.py``)
    host: keep the logits rows on the device until a caller asks for them

Steady-state decode runs through ``DecodePipeline`` (``pipeline.py``): one
decode step per token with on-device sampling, and one int32 row per step
crossing back to the host, drained one step late.

Memory-lean serving, as in the JAX package: ``quantization.weight_bits = 8``
quantizes the weight tree at build (the caller's bf16 tensors are dropped
by the engine; free them by dropping the caller's references too);
``kv_quant`` keeps the pool int8 with its scale tiles; and
``attention.decode_splits`` builds one pass and one decode step per rung of
the pow2 split ladder, the rung picked every step from the longest live
context (:meth:`InferenceEngineV2._attn_rung`).

Model families resolve as in the JAX package (``model.config.family``, else
the model's class name) and adapt through ``ragged_model.adapt_model``:
Llama/Mistral, GPT-2 and the generic decoder (OPT, Falcon, Phi, GPT-NeoX,
GPT-J, BLOOM). An ALiBi model (BLOOM) binds its bias into every paged
kernel and never takes the packed prefill pass: its pure-prefill passes run
the paged pass at the current rung, as in the JAX package.

Sliding-window serving (Mistral, ``LlamaConfig.sliding_window``) binds the
window into every attention kernel, and the scheduler keeps each
sequence's KV in a page ring of ``scheduler.ring_pages`` blocks, as in the
JAX package. A ``max_context`` at or below the window drops it (full
attention is then the same function). The split rung still follows the
longest live context, not the window.

The engine runs on the card unless the caller asks for the CPU:
``device=None`` means ``cuda``, and on a machine without CUDA the
constructor raises. On the CPU every kernel wrapper runs its plain PyTorch
version.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache, KVCacheConfig
from deepspeed_tpu_torch.inference.v2.ragged_model import (
    PAGED_PASS_KEYS, PREFILL_PASS_KEYS, _sample_logits, adapt_model,
    build_decode_step, build_prefill_forward, build_ragged_forward,
    quantize_weights_int8)
from deepspeed_tpu_torch.inference.v2.scheduler import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.utils.caching import next_pow2
from deepspeed_tpu_torch.utils.device import resolve_device


@dataclass
class AttnSplitStats:
    """How many passes and decode steps each split rung served (``rungs``:
    rung -> count), pinned choices (``attn_rung_override``) included."""
    rungs: Dict[int, int] = field(default_factory=dict)

    def record(self, rung: int) -> None:
        self.rungs[rung] = self.rungs.get(rung, 0) + 1

    def reset(self) -> None:
        self.rungs.clear()


class InferenceEngineV2:

    def __init__(self,
                 model: Any = None,
                 config: Optional[RaggedInferenceEngineConfig] = None,
                 model_parameters: Optional[Dict[str, torch.Tensor]] = None,
                 family: Optional[str] = None,
                 device=None):
        """``model``: anything with ``.config`` (a ``LlamaConfig``,
        ``DecoderConfig`` or ``GPT2Config``); ``model_parameters``: its
        flax-named tensor tree (``model.flat_params()`` or
        ``checkpoint.params_from_flat``), moved to ``device`` and cast to
        ``config.dtype`` (no copy when they already match); ``family``
        overrides the one guessed from the model."""
        self.device = resolve_device(device)
        self.config = RaggedInferenceEngineConfig.load(config)
        cfg = self.config
        model_config = getattr(model, "config", None)
        if model_config is None:
            raise ValueError("InferenceEngineV2 needs a model with .config")
        self.family = family = family or _guess_family(model)
        self.model_config = model_config
        if model_parameters is None:
            raise ValueError("InferenceEngineV2 needs model_parameters")
        params = {k: v.to(device=self.device, dtype=cfg.dtype)
                  for k, v in model_parameters.items()}
        self.spec, self.weights = adapt_model(
            family, params, model_config, max_context=cfg.state_manager.max_context)
        del params
        self.spec.dtype = cfg.dtype
        AttentionKernelSpec.validate_engine_build(self.spec, cfg)
        if cfg.quantization.weight_bits == 8:
            # build in the model dtype, then quantize (the JAX order)
            quantize_weights_int8(self.weights)

        sm = cfg.state_manager
        nb = cfg.kv_cache.num_blocks
        if nb is None:
            # pool sized to hold max_tracked_sequences at max_context; a
            # model at full size needs an explicit num_blocks
            nb = -(-sm.max_context // cfg.kv_cache.block_size) * sm.max_tracked_sequences
        # ONE page beyond the allocator's reach: the scratch page backing the
        # decode batch's padding rows (they read and write only it). Outside
        # the allocator on purpose: it can never be handed to a sequence.
        kv_cfg = KVCacheConfig(
            num_layers=self.spec.num_layers,
            num_kv_heads=self.spec.num_kv_heads,
            head_dim=self.spec.head_dim,
            block_size=cfg.kv_cache.block_size,
            num_blocks=nb + 1,
            dtype=cfg.dtype,
            quantized=cfg.kv_quant.enabled)
        self.scratch_block = nb
        self.kv = BlockedKVCache(kv_cfg, self.device)
        self.allocator = BlockedAllocator(nb)
        self.scheduler = DynamicSplitFuseScheduler(sm, self.kv, self.allocator)
        # sliding-window serving (Mistral): the scheduler ring-reuses each
        # sequence's pages beyond the window, so its KV stays bounded
        self.scheduler.window = self.spec.window

        # one paged pass and one decode step per rung of the split ladder
        self._pass_rungs = {r: build_ragged_forward(self.spec, n_splits=r)
                            for r in self.attn_split_ladder}
        ring_ok = self.scheduler.ring_covers(2)
        self._step_rungs = {r: build_decode_step(self.spec, n_splits=r,
                                                 window_ring_ok=ring_ok)
                            for r in self.attn_split_ladder}
        # ALiBi models never take the packed prefill pass (no position bias)
        self._pass_prefill = None if self.spec.alibi else build_prefill_forward(self.spec)
        # pin the dispatched rung (None = picked from the live context)
        self.attn_rung_override: Optional[int] = None
        self.attn_stats = AttnSplitStats()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self._last_logits: Dict[int, np.ndarray] = {}
        # device-resident logits refs: uid -> (tensor [P, V], row)
        self._last_ref: Dict[int, Tuple[torch.Tensor, int]] = {}

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def put(self, uids: Sequence[int], tokens_list: Sequence[np.ndarray],
            do_checks: bool = True) -> np.ndarray:
        """Schedule these tokens and run passes until all are consumed.
        Returns next-token logits [len(uids), vocab] in the order given."""
        uids = [int(u) for u in uids]
        if do_checks and not self.scheduler.can_schedule(
                uids, [len(t) for t in tokens_list]):
            raise RuntimeError("cannot schedule: insufficient KV blocks or "
                               "sequence slots (check can_schedule first)")
        self._put_nofetch(uids, tokens_list)
        self._materialize(set(uids))
        missing = set(uids) - set(self._last_logits)
        if missing:
            raise RuntimeError(f"no logits produced for uids {sorted(missing)}")
        return np.stack([self._last_logits[u] for u in uids])

    def _put_nofetch(self, uids: Sequence[int],
                     tokens_list: Sequence[np.ndarray]) -> None:
        """Like put(), but leaves the logits on the device."""
        for uid, toks in zip(uids, tokens_list):
            self.scheduler.add_tokens(int(uid), np.asarray(toks, np.int32))
        while self.scheduler.has_pending():
            self._run_pass()

    def _materialize(self, uids) -> None:
        """Fetch pending device logits to numpy, one transfer per pass."""
        by_array: Dict[int, Tuple[torch.Tensor, list]] = {}
        for uid in uids:
            ref = self._last_ref.pop(uid, None)
            if ref is None:
                continue
            arr, row = ref
            by_array.setdefault(id(arr), (arr, []))[1].append((uid, row))
        for arr, pairs in by_array.values():
            host = arr.cpu().numpy()
            for uid, row in pairs:
                self._last_logits[uid] = host[row]

    def _run_pass(self) -> None:
        batch = self.scheduler.schedule_pass()
        if batch is None:
            return
        # prefill-from-zero passes need no paged reads: packed fast path
        # (not for ALiBi models: the paged pass carries their bias)
        if batch.pure_prefill and self._pass_prefill is not None:
            arrays = batch.device_arrays(self.device, PREFILL_PASS_KEYS)
            chunk_logits, decode_logits = self._pass_prefill(
                self.weights, self.kv.kv, arrays, self.kv.scales)
        else:
            arrays = batch.device_arrays(self.device, PAGED_PASS_KEYS)
            chunk_logits, decode_logits = self._pass_rungs[self._attn_rung()](
                self.weights, self.kv.kv, arrays, self.kv.scales)
        finished = self.scheduler.complete_pass(batch)
        for uid in finished:
            if uid in batch.slot_uid:
                # a prompt may span several slots; its next-token logits sit
                # in the LAST slot it filled
                row = len(batch.slot_uid) - 1 - batch.slot_uid[::-1].index(uid)
                self._last_ref[uid] = (chunk_logits, row)
            else:
                self._last_ref[uid] = (decode_logits,
                                       batch.decode_uids.index(uid))

    def query(self, uid: int, max_request_tokens: int) -> Tuple[int, int]:
        return self.scheduler.query(uid, max_request_tokens)

    def can_schedule(self, uids: Sequence[int], lengths: Sequence[int]) -> bool:
        return self.scheduler.can_schedule([int(u) for u in uids], list(lengths))

    def flush(self, uids: Sequence[int]) -> None:
        for uid in uids:
            self.scheduler.flush(int(uid))
            self._last_logits.pop(int(uid), None)
            self._last_ref.pop(int(uid), None)

    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    # ------------------------------------------------------------------ #
    # flash-decoding split ladder
    # ------------------------------------------------------------------ #

    @property
    def attn_split_ladder(self) -> List[int]:
        """The pow2 rungs paged attention dispatches over: ``[1, 2, 4, ...,
        config.attention.decode_splits]``. Rung 1 is the base decode and
        chunk kernels; a higher rung cuts every sequence's pages into that
        many split-K partials."""
        top = self.config.attention.decode_splits
        return [1 << i for i in range(top.bit_length())]

    def _attn_rung(self) -> int:
        """The rung for THIS dispatch: the largest pow2 rung such that the
        longest live context keeps ``min_ctx_per_split`` tokens per split,
        clamped to the ladder; ``attn_rung_override`` pins it (clamped the
        same way). Each choice is counted in ``attn_stats``."""
        top = self.config.attention.decode_splits
        if top <= 1:
            return 1
        if self.attn_rung_override is not None:
            rung = max(1, min(int(self.attn_rung_override), top))
        else:
            live = max((s.seen_tokens for s in self.scheduler.seqs.values()), default=0)
            want = max(1, live // self.config.attention.min_ctx_per_split)
            rung = min(top, 1 << (want.bit_length() - 1))
        self.attn_stats.record(rung)
        return rung

    def _decode_step_fn(self):
        """The decode step at this step's rung (the pipeline asks every
        step)."""
        return self._step_rungs[self._attn_rung()]

    # ------------------------------------------------------------------ #
    # decode support
    # ------------------------------------------------------------------ #

    def _sample_device_padded(self, uids: Sequence[int], do_sample: bool,
                              temperature: float, top_k: int) -> torch.Tensor:
        """Next tokens sampled on the device from each uid's last logits, as
        int32 [next_pow2(len(uids))]: pad entries repeat row 0 (the decode
        batch runs them on the scratch page)."""
        rows = []
        for uid in uids:
            ref = self._last_ref.get(int(uid))
            if ref is None:
                # logits were materialised to host (a prior put()); re-upload
                rows.append(torch.from_numpy(self._last_logits[int(uid)])
                            .to(self.device)[None])
            else:
                arr, row = ref
                rows.append(arr[row:row + 1])
        rows += rows[:1] * (next_pow2(len(uids)) - len(uids))
        return _sample_logits(torch.cat(rows), self.generator, do_sample, top_k,
                              temperature)

    def decode_pipeline(self, uids: Sequence[int], do_sample: bool = False,
                        temperature: float = 1.0, top_k: int = 0):
        """The steady-state decode pipeline over ``uids`` (all in steady
        decode state): while the device runs step N, the host drains step
        N-1's token row; the only per-step transfer is one int32 row."""
        from deepspeed_tpu_torch.inference.v2.pipeline import DecodePipeline
        return DecodePipeline(self, uids, do_sample=do_sample,
                              temperature=temperature, top_k=top_k)

    # ------------------------------------------------------------------ #
    # continuous-batching generation loop
    # ------------------------------------------------------------------ #

    def generate(self,
                 prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 do_sample: bool = False,
                 temperature: float = 1.0,
                 top_k: int = 0,
                 eos_token_id: Optional[int] = None) -> List[List[int]]:
        """Generate continuations for a batch of prompts with continuous
        batching: prefill through ``put`` passes, then ``decode_pipeline``
        in runs of up to 32 steps, retiring EOS'd or budget-complete
        sequences at each drained step and recycling their blocks. Returns
        full token lists (prompt + generation)."""
        uids: List[int] = []
        nxt = 0
        while len(uids) < len(prompts):
            if nxt not in self.scheduler.seqs:
                uids.append(nxt)
            nxt += 1
        idx_of = {u: i for i, u in enumerate(uids)}
        outs: List[List[int]] = [list(map(int, p)) for p in prompts]
        if not self.can_schedule(uids, [len(p) for p in prompts]):
            raise RuntimeError("cannot schedule: insufficient KV blocks or "
                               "sequence slots")
        self._put_nofetch(uids, [np.asarray(p, np.int32) for p in prompts])
        pipe = self.decode_pipeline(uids, do_sample=do_sample,
                                    temperature=temperature, top_k=top_k)
        live = set(uids)
        budget = {u: max_new_tokens for u in uids}

        def on_tokens(j, run_uids, row):
            stop = []
            for i, u in enumerate(run_uids):
                if u not in live:
                    continue        # retired earlier this run: padding noise
                t = int(row[i])
                outs[idx_of[u]].append(t)
                budget[u] -= 1
                if budget[u] <= 0 or (eos_token_id is not None
                                      and t == eos_token_id):
                    live.discard(u)
                    stop.append(u)
            return stop

        if max_new_tokens <= 0:
            self.flush(pipe.uids)
            return outs
        CHUNK = 32
        while pipe.uids:
            n = min(CHUNK, max(budget[u] for u in pipe.uids))
            before = set(pipe.uids)
            pipe.run(n, on_tokens=on_tokens)
            for u in before - set(pipe.uids):
                self.flush([u])     # retired mid-run: recycle KV blocks now
        self.flush(pipe.uids)
        return outs


def _guess_family(model) -> str:
    """``model.config.family``, else a family named in the model's class
    name (the JAX package's rule)."""
    fam = getattr(getattr(model, "config", None), "family", None)
    if fam:
        return fam
    name = type(model).__name__.lower()
    for fam in ("mixtral", "mistral", "llama", "gpt2", "opt", "falcon", "phi"):
        if fam in name:
            return fam
    raise ValueError(f"cannot infer model family from {type(model).__name__}; "
                     f"pass family=")
