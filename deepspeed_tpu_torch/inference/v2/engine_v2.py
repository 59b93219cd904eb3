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
crossing back to the host, drained one step late. ``decode_steps`` runs a
burst of steps with no host sync between them (the side-buffer schedule of
``ragged_model.build_multistep_decode``), and ``sample_next`` samples one
token from each sequence's last logits on the device.

The page fabric moves KV pages to the host and back (``fetch_pages`` /
``put_pages``, bucketed to powers of two) and hands a sequence to another
engine (``export_kv`` / ``import_kv``); its payload
(``page_payload_spec``) is the JAX package's, byte for byte (a bf16 page
as uint16 bytes).

Memory-lean serving, as in the JAX package: ``quantization.weight_bits = 8``
(int8) or ``4`` (int4, packed two per byte) quantizes the weight tree at
build. The build is refused before any tensor is read; then the
parameters land on the device one tensor at a time
(``ragged_model.LandingParams``) and every family's projections, expert
stacks and head quantize as they land (``ragged_model.adapt_model``), so
Mixtral-8x7B builds in its int8 size plus one bf16 expert stack. The bytes
are the JAX engine's, which quantizes after its build. The caller's
tensors are not kept: pass a mapping that makes each tensor when it is
read, or drop the caller's references. ``kv_quant`` keeps the pool int8
with its scale tiles, under a sliding window and ALiBi too; and
``attention.decode_splits`` builds one pass and one decode step per rung of
the pow2 split ladder, the rung picked every step from the longest live
context (:meth:`InferenceEngineV2._attn_rung`).

Model families resolve as in the JAX package (``model.config.family``, else
the model's class name) and adapt through ``ragged_model.adapt_model``:
the Llama lineage (Llama, Mistral, Mixtral's MoE, Qwen2 and Gemma through
their config flags), GPT-2 and the generic decoder (OPT, Falcon, Phi,
GPT-NeoX, GPT-J, BLOOM). An ALiBi model (BLOOM) binds its bias into every paged
kernel and never takes the packed prefill pass: its pure-prefill passes run
the paged pass at the current rung, as in the JAX package.

The prefix cache (``prefix_cache.enabled``, as in the JAX package) keeps
completed sequences' pages in a radix tree (``prefix_cache.py``): a new
prompt adopts every cached whole-block prefix, and its uncached tail runs
as a continuation pass through the chunk kernel; a partial cached page is
adopted copy-on-write (``BlockedKVCache.copy_page``). Speculative decoding
(``spec_decode.enabled``) gives greedy requests the ``SpecDecodePipeline``
(``spec/``), whose verify step (``ragged_model.build_verify_step``) scores
n-gram drafts through the chunk kernel; one verify function is built per
draft length of :attr:`InferenceEngineV2.spec_k_ladder`. Neither runs
with a sliding window (refused at build, in the JAX package's words).

Multi-tenant LoRA (``lora.enabled``, as in the JAX package): ``engine.lora``
is the adapter registry (``lora/registry.py``) over a paged adapter-weight
pool (``lora/pool.py``); ``module_inject.load_lora_adapter`` registers an
adapter, ``engine.lora.acquire(uid, name)`` binds a request to it before
its prompt is put and ``release(uid)`` unbinds it. Decode and verify steps
then run at the rank bucket (``lora_rank_bucket``, fixed by the registered
ranks) with each row's delta on the targeted projections; prefill is
base-only, and ``decode_steps`` refuses bound rows.

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

import warnings

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import BlockedKVCache, KVCacheConfig
from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import host_to_device, to_device
from deepspeed_tpu_torch.inference.v2.prefix_cache import Event, RadixPrefixCache
from deepspeed_tpu_torch.inference.v2.ragged_model import (
    PAGED_PASS_KEYS, PREFILL_PASS_KEYS, LandingParams, _sample_logits, adapt_model,
    build_decode_step, build_multistep_decode, build_prefill_forward, build_ragged_forward,
    build_verify_step, quantize_weight_int4, quantize_weight_int8)
from deepspeed_tpu_torch.inference.v2.scheduler import DynamicSplitFuseScheduler
from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_scale_tiles_shape
from deepspeed_tpu_torch.utils.caching import LRUCache, next_pow2
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


@dataclass
class SpecDecodeStats:
    """Counters of one engine's speculative-decode pipelines (the JAX
    package's ``monitor/serving.py`` :115; cumulative across runs,
    ``reset()`` between measurement windows). Per verify step:
    ``proposed`` draft tokens offered, ``accepted`` the ones the verify
    forward confirmed, ``tokens`` those emitted (accepted + one bonus a live
    row); ``draft_ms`` is host time in the proposer, ``verify_ms`` the
    launch plus the blocking drain of the accept row."""

    steps: int = 0
    rows: int = 0                    # live rows scored across steps
    proposed: int = 0
    accepted: int = 0
    tokens: int = 0                  # emitted (accepted + bonus) tokens
    draft_ms: float = 0.0
    verify_ms: float = 0.0
    fetch_bytes: int = 0

    def record_step(self, rows: int, proposed: int, accepted: int,
                    tokens: int, draft_s: float, verify_s: float,
                    fetch_bytes: int) -> None:
        self.steps += 1
        self.rows += rows
        self.proposed += proposed
        self.accepted += accepted
        self.tokens += tokens
        self.draft_ms += 1e3 * draft_s
        self.verify_ms += 1e3 * verify_s
        self.fetch_bytes += int(fetch_bytes)

    def reset(self) -> None:
        self.steps = self.rows = self.proposed = self.accepted = self.tokens = 0
        self.draft_ms = self.verify_ms = 0.0
        self.fetch_bytes = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_step(self) -> float:
        return self.tokens / self.steps if self.steps else 0.0

    def events(self, step: int = 0) -> List[Event]:
        """``serve/spec/*`` monitor events ``(name, value, step)``."""
        n = max(1, self.steps)
        pre = "serve/spec"
        return [
            (f"{pre}/steps", float(self.steps), step),
            (f"{pre}/proposed", float(self.proposed), step),
            (f"{pre}/accepted", float(self.accepted), step),
            (f"{pre}/tokens", float(self.tokens), step),
            (f"{pre}/acceptance_rate", self.acceptance_rate, step),
            (f"{pre}/tokens_per_step", self.tokens_per_step, step),
            (f"{pre}/draft_ms_per_step", self.draft_ms / n, step),
            (f"{pre}/verify_ms_per_step", self.verify_ms / n, step),
            (f"{pre}/fetch_bytes_per_step", self.fetch_bytes / n, step),
        ]


class _AdapterCounters:
    """Per-adapter LoRA serving counters (one per registered adapter)."""

    __slots__ = ("active", "resident", "evictions", "faults", "acquires",
                 "hits", "swap_in_bytes", "swap_out_bytes")

    def __init__(self):
        self.active = 0            # gauge: in-flight requests bound to it
        self.resident = 0          # gauge: 0/1 device residency
        self.evictions = 0
        self.faults = 0            # device fault-ins (from host or master)
        self.acquires = 0
        self.hits = 0              # acquires served without a fault
        self.swap_in_bytes = 0     # host -> device (fault-in, restore)
        self.swap_out_bytes = 0    # device -> host (evict)


class LoraStats:
    """Counters of one engine's LoRA adapter registry (the JAX package's
    ``monitor/serving.py`` :582), the ``serve/lora/*`` monitor events.
    ``fault_ms`` and ``swap_ms`` sum the fault-in and eviction wall times,
    each from one ``perf_counter`` pair that ends after the device copy.
    Mutated only on the registry's thread; ``events()`` snapshots the dict
    before iterating."""

    def __init__(self):
        self.adapters: Dict[str, _AdapterCounters] = {}
        self.fault_ms = 0.0
        self.swap_ms = 0.0

    def _c(self, name: str) -> _AdapterCounters:
        return self.adapters.setdefault(name, _AdapterCounters())

    def record_acquire(self, name: str, hit: bool) -> None:
        c = self._c(name)
        c.acquires += 1
        c.hits += bool(hit)
        c.active += 1

    def record_release(self, name: str) -> None:
        self._c(name).active -= 1

    def record_fault(self, name: str, nbytes: int, dt_s: float) -> None:
        c = self._c(name)
        c.faults += 1
        c.swap_in_bytes += int(nbytes)
        c.resident = 1
        self.fault_ms += 1e3 * dt_s

    def record_evict(self, name: str, nbytes: int, dt_s: float) -> None:
        c = self._c(name)
        c.evictions += 1
        c.swap_out_bytes += int(nbytes)
        c.resident = 0
        self.swap_ms += 1e3 * dt_s

    def set_resident(self, name: str, resident: bool) -> None:
        self._c(name).resident = int(bool(resident))

    def drop(self, name: str) -> None:
        """Forget an unregistered adapter's counters."""
        self.adapters.pop(name, None)

    @property
    def hit_fraction(self) -> float:
        acq = sum(c.acquires for c in self.adapters.values())
        hits = sum(c.hits for c in self.adapters.values())
        return hits / acq if acq else 0.0

    def events(self, step: int = 0) -> List[Event]:
        """``serve/lora/*`` monitor events ``(name, value, step)``: the
        registry's totals, then each adapter's."""
        adapters = dict(self.adapters)

        def total(field_name):
            return float(sum(getattr(c, field_name) for c in adapters.values()))

        out: List[Event] = [
            ("serve/lora/registered", float(len(adapters)), step),
            ("serve/lora/resident", total("resident"), step),
            ("serve/lora/active", total("active"), step),
            ("serve/lora/faults", total("faults"), step),
            ("serve/lora/evictions", total("evictions"), step),
            ("serve/lora/swap_in_bytes", total("swap_in_bytes"), step),
            ("serve/lora/swap_out_bytes", total("swap_out_bytes"), step),
            ("serve/lora/hit_fraction", self.hit_fraction, step),
            ("serve/lora/fault_ms", self.fault_ms, step),
            ("serve/lora/swap_ms", self.swap_ms, step),
        ]
        for name, c in sorted(adapters.items()):
            pre = f"serve/lora/{name}"
            out += [
                (f"{pre}/active", float(c.active), step),
                (f"{pre}/resident", float(c.resident), step),
                (f"{pre}/evictions", float(c.evictions), step),
                (f"{pre}/faults", float(c.faults), step),
                (f"{pre}/swap_bytes", float(c.swap_in_bytes + c.swap_out_bytes), step),
                (f"{pre}/hit_fraction", c.hits / c.acquires if c.acquires else 0.0, step),
            ]
        return out


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
        quantize = {8: quantize_weight_int8, 4: quantize_weight_int4}.get(
            cfg.quantization.weight_bits)

        def check(spec):
            spec.dtype = cfg.dtype
            AttentionKernelSpec.validate_engine_build(spec, cfg)

        # refused before any tensor lands; then tensors land on the device
        # one at a time as the adapter reads them, projections, expert
        # stacks and the head quantizing as they land, so the model-dtype
        # tree never exists whole
        self.spec, self.weights = adapt_model(
            family, LandingParams(model_parameters, self.device, cfg.dtype), model_config,
            max_context=cfg.state_manager.max_context, quantize=quantize, check=check)

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
        # (a window with either feature was refused by validate_engine_build)
        self.prefix_cache: Optional[RadixPrefixCache] = None
        if cfg.prefix_cache.enabled:
            self.prefix_cache = RadixPrefixCache(
                self.allocator, kv_cfg.block_size,
                max_cached_blocks=cfg.prefix_cache.max_cached_blocks,
                cow_fn=self.kv.copy_page)
        self.scheduler = DynamicSplitFuseScheduler(sm, self.kv, self.allocator,
                                                   prefix_cache=self.prefix_cache)
        # sliding-window serving (Mistral): the scheduler ring-reuses each
        # sequence's pages beyond the window, so its KV stays bounded
        self.scheduler.window = self.spec.window
        # the n-gram proposer drafts from each sequence's history: record
        # it even without a prefix cache
        self.scheduler.record_history_always = cfg.spec_decode.enabled

        # one paged pass and one decode step per rung of the split ladder
        self._pass_rungs = {r: build_ragged_forward(self.spec, n_splits=r)
                            for r in self.attn_split_ladder}
        ring_ok = self.scheduler.ring_covers(2)
        self._step_rungs = {r: build_decode_step(self.spec, n_splits=r,
                                                 window_ring_ok=ring_ok)
                            for r in self.attn_split_ladder}
        # ALiBi models never take the packed prefill pass (no position bias)
        self._pass_prefill = None if self.spec.alibi else build_prefill_forward(self.spec)
        # decode_steps bursts: (n_steps, bucket, do_sample, top_k, rung) -> fn
        self._multistep: LRUCache = LRUCache(maxsize=8)
        # pin the dispatched rung (None = picked from the live context)
        self.attn_rung_override: Optional[int] = None
        self.attn_stats = AttnSplitStats()
        # speculative decoding: one verify function per draft length (the
        # chunk kernel serves every split rung, so the rung is no key)
        self._verify_fns: LRUCache = LRUCache(maxsize=16)
        self.spec_stats = SpecDecodeStats()
        # multi-tenant LoRA: the adapter registry over its paged weight pool
        # (inference/v2/lora/); LoRA decode steps by (rung, rank bucket)
        self.lora = None
        self._lora_steps: LRUCache = LRUCache(maxsize=16)
        if cfg.lora.enabled:
            from deepspeed_tpu_torch.inference.v2.lora import (LoraAdapterRegistry,
                                                               LoraPagePool)
            self.lora = LoraAdapterRegistry(
                LoraPagePool(self.spec, cfg.lora.targets, cfg.lora.pool_pages, self.device),
                swap_buffers=cfg.lora.swap_buffers, max_rank=cfg.lora.max_rank)
        self._spec_warned_sampling = False
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

    def _decode_step_fn(self, rb: int = 0):
        """The decode step at this step's rung (the pipeline asks every
        step); ``rb > 0``, a LoRA rank bucket, gives the LoRA step at that
        bucket, built once per (rung, rb) and cached. Rank bucket 0 is
        exactly the base step."""
        rung = self._attn_rung()
        if rb == 0:
            return self._step_rungs[rung]
        return self._lora_steps.get_or_create((rung, int(rb)), lambda: build_decode_step(
            self.spec, n_splits=rung, window_ring_ok=self.scheduler.ring_covers(2),
            lora_targets=self._lora_targets(rb)))

    def _lora_targets(self, rb: int):
        """The builders' ``lora_targets`` at rank bucket ``rb``: the
        configured projections when rb > 0, None (the base step) at 0."""
        if rb == 0:
            return None
        assert self.lora is not None, "rank-bucketed step without LoRA"
        return self.config.lora.targets

    @property
    def lora_rank_bucket(self) -> int:
        """The rank bucket decode runs at: the registry's ``rank_bucket``
        (0 with LoRA off or only rank-0 adapters: the base steps)."""
        return self.lora.rank_bucket if self.lora is not None else 0

    def _lora_operands(self, uids: Sequence[int], bucket: int,
                       rb: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The keyword LoRA operands of a rank-bucketed step: the pool and
        these rows' page table ``[bucket, rb]`` on the device, uploaded once
        a run (bindings hold for the run, like block tables). Empty at rb =
        0, so callers splat it unconditionally."""
        rb = self.lora_rank_bucket if rb is None else rb
        if rb == 0:
            return {}
        pt = self.lora.page_table(uids, bucket, rb)
        return {"lora_pool": self.lora.pool.pool, "adapter_pt": to_device(pt, self.device)}

    @property
    def spec_k_ladder(self) -> List[int]:
        """The draft lengths speculation dispatches over, as in the JAX
        package: 1, 3, 7, ... (k + 1 a power of two) below
        ``config.spec_decode.k``, then k itself. Each step runs the smallest
        one covering its longest draft, so a mostly unrepetitive batch
        verifies 2 rows a sequence, not k + 1."""
        k = self.config.spec_decode.k
        ks, v = [], 1
        while v < k:
            ks.append(v)
            v = 2 * v + 1
        ks.append(k)
        return sorted(set(ks))

    def _verify_fn(self, k: int, rb: int = 0):
        """The verify step for draft length ``k`` at LoRA rank bucket ``rb``
        (:func:`build_verify_step`), built once and cached."""
        return self._verify_fns.get_or_create((int(k), int(rb)), lambda: build_verify_step(
            self.spec, int(k), lora_targets=self._lora_targets(rb)))

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
                rows.append(host_to_device(torch.from_numpy(
                    np.array(self._last_logits[int(uid)], np.float32)), self.device)[None])
            else:
                arr, row = ref
                rows.append(arr[row:row + 1])
        rows += rows[:1] * (next_pow2(len(uids)) - len(uids))
        return _sample_logits(torch.cat(rows), self.generator, do_sample, top_k,
                              temperature)

    def sample_next(self, uids: Sequence[int], do_sample: bool = False,
                    temperature: float = 1.0, top_k: int = 0) -> np.ndarray:
        """The next token of each uid, sampled on the device from its last
        logits; only the int32 ids cross to the host."""
        uids = [int(u) for u in uids]
        if not uids:
            return np.zeros((0,), np.int32)
        ids = self._sample_device_padded(uids, do_sample, temperature, top_k)
        return ids.cpu().numpy()[:len(uids)]

    def decode_steps(self, uids: Sequence[int], n_steps: int, do_sample: bool = False,
                     temperature: float = 1.0, top_k: int = 0, fetch: bool = True):
        """Generate ``n_steps`` tokens for every uid in one burst
        (:func:`build_multistep_decode`: the sample -> forward -> sample
        loop stays on the device, with no host sync between its steps).
        Every uid must be in steady decode state (no pending tokens, last
        logits available). Returns the generated ids ``[len(uids),
        n_steps]``; ``fetch=False`` returns them as the device tensor, so
        bursts chain without a host round trip. The engine's last-logits
        refs advance, so ``put``, ``sample_next``, the pipeline or another
        burst carry on.

        The burst runs at ``next_pow2(len(uids))`` rows (pad rows decode on
        the scratch page) and at this dispatch's split rung; its function
        is cached per ``(n_steps, bucket, do_sample, top_k, rung)``, as the
        JAX package's compiled programs are."""
        uids = [int(u) for u in uids]
        S = len(uids)
        if n_steps < 1:
            raise ValueError(f"decode_steps needs n_steps >= 1, got {n_steps}")
        if self.lora is not None:
            bound = {u: self.lora.binding(u) for u in uids}
            bound = {u: n for u, n in bound.items() if n is not None and self.lora.rank(n)}
            if bound:
                # the JAX package's bursts take no LoRA operands and would
                # decode these rows as the base model
                raise NotImplementedError(
                    f"decode_steps runs the base model only: uids {sorted(bound)} are "
                    f"bound to LoRA adapters {sorted(set(bound.values()))} — decode "
                    "them through decode_pipeline")
        if self.scheduler.has_pending():
            raise RuntimeError("decode_steps requires a drained scheduler")
        db = self.scheduler.decode_batch(uids, n_steps + 1, self.scratch_block)
        sp = self._attn_rung()
        fn = self._multistep.get_or_create(
            (n_steps, db.bucket, bool(do_sample), int(top_k), sp),
            lambda: self._build_multistep(n_steps, do_sample, top_k, sp))
        # bucket-padded: pad entries re-sample row 0's logits but decode on
        # the scratch page, so they cannot touch live KV
        ids0 = self._sample_device_padded(uids, do_sample, temperature, top_k)
        block_tables = to_device(db.block_tables, self.device)
        positions = to_device(db.positions, self.device)
        out_ids, final_logits = fn(self.weights, self.kv.kv, ids0, positions, block_tables,
                                   positions + 1, self.generator, float(temperature),
                                   kv_scales=self.kv.scales)
        for i, u in enumerate(uids):
            self.scheduler.advance(u, n_steps)
            self._last_ref[u] = (final_logits, i)
            self._last_logits.pop(u, None)
        ids = out_ids.t()[:S]                          # [S, n_steps]
        return ids if not fetch else ids.cpu().numpy()

    def _build_multistep(self, n_steps: int, do_sample: bool, top_k: int, sp: int,
                         max_side_bytes: Optional[int] = None):
        """One burst function at split rung ``sp``, the function
        ``decode_steps`` caches; ``max_side_bytes`` as
        :func:`build_multistep_decode`'s."""
        return build_multistep_decode(
            self.spec, n_steps, do_sample=do_sample, top_k=top_k,
            window_ring_ok=self.scheduler.ring_covers(n_steps + 1),
            max_side_bytes=max_side_bytes, n_splits=sp)

    def decode_pipeline(self, uids: Sequence[int], do_sample: bool = False,
                        temperature: float = 1.0, top_k: int = 0):
        """The steady-state decode pipeline over ``uids`` (all in steady
        decode state): while the device runs step N, the host drains step
        N-1's token row; the only per-step transfer is one int32 row.

        With ``config.spec_decode.enabled``, greedy requests get the
        ``spec.SpecDecodePipeline`` (draft and verify, a variable advance a
        step; callers branch their ``on_tokens`` shape on ``pipe.spec``).
        Speculation is greedy-only: ``do_sample`` bypasses it with a
        one-time warning."""
        from deepspeed_tpu_torch.inference.v2.pipeline import DecodePipeline
        if self.config.spec_decode.enabled:
            if not do_sample:
                from deepspeed_tpu_torch.inference.v2.spec import SpecDecodePipeline
                return SpecDecodePipeline(self, uids)
            if not self._spec_warned_sampling:
                self._spec_warned_sampling = True
                warnings.warn(
                    "spec_decode is greedy-only for now: "
                    "do_sample=True bypasses speculation and runs the "
                    "plain DecodePipeline (warned once)", stacklevel=2)
        return DecodePipeline(self, uids, do_sample=do_sample,
                              temperature=temperature, top_k=top_k)

    def write_monitor_events(self, monitor, step: int = 0) -> None:
        """Write the serving counters to ``monitor`` (anything with
        ``write_events(list of (name, value, step))``): the prefix cache's
        when it is on, the spec pipelines' once one has run, and the LoRA
        registry's once an adapter is registered."""
        if self.prefix_cache is not None:
            monitor.write_events(self.prefix_cache.stats.events(step))
        if self.spec_stats.steps:
            monitor.write_events(self.spec_stats.events(step))
        if self.lora is not None and self.lora.stats.adapters:
            monitor.write_events(self.lora.stats.events(step))

    # ------------------------------------------------------------------ #
    # KV page fabric: pages to the host and back, and page handoffs
    # ------------------------------------------------------------------ #

    @property
    def page_payload_spec(self) -> Tuple[Tuple[int, ...], Any]:
        """(shape, numpy dtype) of ONE page as it travels the host fabric, as
        in the JAX package: a plain pool ships the page itself ``[L, 2,
        Hkv, bs, D]`` (f32 as float32; bf16 as uint16 holding the same
        bytes, numpy having no bfloat16); an int8 pool ships one flat byte
        row per page, the int8 values then the f32 scale tiles
        (``bytes_per_block`` bytes)."""
        cfg = self.kv.config
        if cfg.quantized:
            return (cfg.bytes_per_block(),), np.uint8
        return ((cfg.num_layers, 2, cfg.num_kv_heads, cfg.block_size, cfg.head_dim),
                _PAYLOAD_DTYPES[cfg.dtype])

    def _pack_pages(self, vals: np.ndarray, scales: np.ndarray) -> np.ndarray:
        """(int8 values [n, L, 2, Hkv, bs, D], f32 scale tiles [n, L, R8,
        128]) -> packed [n, bytes_per_block] uint8 rows."""
        n = vals.shape[0]
        return np.concatenate(
            [np.ascontiguousarray(vals).reshape(n, -1).view(np.uint8),
             np.ascontiguousarray(scales).reshape(n, -1).view(np.uint8)], axis=1)

    def _unpack_pages(self, pages: np.ndarray):
        """Inverse of :meth:`_pack_pages`: packed uint8 rows -> (int8 values,
        f32 scale tiles)."""
        cfg = self.kv.config
        n = pages.shape[0]
        L, Hkv, bs, D = cfg.num_layers, cfg.num_kv_heads, cfg.block_size, cfg.head_dim
        vbytes = L * 2 * Hkv * bs * D
        vals = np.ascontiguousarray(pages[:, :vbytes]).view(np.int8)
        scales = np.ascontiguousarray(pages[:, vbytes:]).view(np.float32)
        _, r8, lanes = kv_scale_tiles_shape(1, Hkv, bs)
        return vals.reshape(n, L, 2, Hkv, bs, D), scales.reshape(n, L, r8, lanes)

    def _page_index(self, ids: List[int]) -> torch.Tensor:
        """Page ids padded to a power of two with the scratch page, on the
        device."""
        idx = np.full((next_pow2(len(ids)),), self.scratch_block, np.int32)
        idx[:len(ids)] = ids
        return to_device(idx, self.device).long()

    def fetch_pages(self, blocks: Sequence[int]) -> np.ndarray:
        """KV pages to the host in one bucketed gather (pad slots read the
        scratch page): ``[n, L, 2, Hkv, bs, D]`` for a plain pool (bf16 as
        uint16 bytes), packed ``[n, bytes_per_block]`` uint8 rows for an
        int8 one (:attr:`page_payload_spec`)."""
        ids = [int(b) for b in blocks]
        n = len(ids)
        idx = self._page_index(ids)
        vals = self.kv.kv.index_select(1, idx).transpose(0, 1)[:n]
        if self.kv.config.quantized:
            scales = self.kv.scales.index_select(1, idx).transpose(0, 1)[:n]
            return self._pack_pages(vals.cpu().numpy(), scales.cpu().numpy())
        return _to_payload(vals)

    def put_pages(self, pages: np.ndarray, blocks: Sequence[int]) -> None:
        """Scatter host pages ``[n, ...]`` (:attr:`page_payload_spec`) into
        pool slots ``blocks`` in one bucketed dispatch, byte-exact with
        :meth:`fetch_pages`; pad slots write zeros into the scratch page."""
        ids = [int(b) for b in blocks]
        if not ids:
            return
        pages = self._payload_array(pages)
        n, bucket = len(ids), next_pow2(len(ids))
        if bucket != n:
            pages = np.concatenate(
                [pages, np.zeros((bucket - n,) + pages.shape[1:], pages.dtype)])
        idx = self._page_index(ids)
        if self.kv.config.quantized:
            vals, scales = self._unpack_pages(pages)
            self.kv.kv.index_copy_(1, idx, _from_host(vals, self.device).transpose(0, 1))
            self.kv.scales.index_copy_(1, idx,
                                       _from_host(scales, self.device).transpose(0, 1))
            return
        t = _from_host(pages, self.device)
        if self.kv.kv.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        self.kv.kv.index_copy_(1, idx, t.transpose(0, 1))

    def _payload_array(self, pages) -> np.ndarray:
        """A host payload as this pool's payload dtype; a bf16 pool takes
        uint16 or bfloat16 arrays (the JAX package's) by their bytes."""
        _, dtype = self.page_payload_spec
        pages = np.asarray(pages)
        if dtype is np.uint16 and pages.dtype != np.uint16:
            if pages.dtype.name != "bfloat16":
                raise TypeError(f"a bf16 pool's pages travel as uint16 or bfloat16 "
                                f"bytes, got {pages.dtype}")
            return pages.view(np.uint16)
        return np.asarray(pages, dtype)

    def export_kv(self, uid: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(pages, logits)``: the whole logical KV of a drained sequence
        fetched to the host in one bucketed gather, and its last logits row;
        then the sequence is flushed here. The export half of a page
        handoff: :meth:`import_kv` on another engine (or under another uid)
        restores it."""
        uid = int(uid)
        seq = self.scheduler.seqs.get(uid)
        if seq is None:
            raise KeyError(f"sequence {uid} is not tracked")
        if len(seq.pending):
            raise RuntimeError(f"sequence {uid} still has pending prefill "
                               "tokens — export_kv needs a drained sequence")
        self._materialize([uid])
        logits = self._last_logits.pop(uid)
        pages = self.fetch_pages(list(seq.blocks))
        self.flush([uid])
        return pages, logits

    def import_kv(self, uid: int, tokens: Sequence[int], pages: np.ndarray,
                  logits: np.ndarray) -> List[int]:
        """Adopt a sequence whose KV ``pages`` were computed elsewhere (this
        package's or the JAX package's ``export_kv``): allocate fresh pages
        (``scheduler.adopt_sequence``), scatter the content in with
        :meth:`put_pages` (byte-exact), and seed its last logits row. The
        sequence is then in steady decode state. Returns the allocated
        block ids."""
        uid = int(uid)
        page_shape, _ = self.page_payload_spec
        pages = self._payload_array(pages)
        if tuple(pages.shape[1:]) != page_shape:
            raise ValueError(
                f"handoff page shape {tuple(pages.shape[1:])} does not match "
                f"this engine's KV page layout {page_shape} — cross-engine "
                "handoff needs an identical model + block_size")
        ids = self.scheduler.adopt_sequence(uid, tokens, len(pages))
        if ids:
            self.put_pages(pages, ids)
        self._last_logits[uid] = np.array(logits, np.float32)
        return ids

    def fetch_page(self, block: int) -> np.ndarray:
        """One KV page (``page_payload_spec``-shaped) to the host."""
        return self.fetch_pages([block])[0]

    def put_page(self, page: np.ndarray, block: int) -> None:
        """Scatter one host page into pool slot ``block``."""
        self.put_pages(np.asarray(page)[None], [block])

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
        in runs of up to 32 steps (32 // (k + 1) verify steps with spec
        decode), retiring EOS'd or budget-complete sequences at each drained
        step and recycling their blocks. Returns full token lists (prompt +
        generation). With spec decode, a run is clamped to the rows'
        ``max_context`` headroom (a verify step reserves k + 1 positions),
        and once not one verify step fits the tail runs on the plain
        pipeline, as in the JAX package."""
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
        is_spec = getattr(pipe, "spec", False)
        live = set(uids)
        budget = {u: max_new_tokens for u in uids}

        def on_tokens(j, run_uids, row):
            stop = []
            for i, u in enumerate(run_uids):
                if u not in live:
                    continue        # retired earlier this run: padding noise
                # a spec step emits a token batch a row, a plain step one
                # token; tokens past the budget (a spec step's overshoot)
                # are dropped, their KV past the flush below
                for t in (row[i] if is_spec else row[i:i + 1]):
                    t = int(t)
                    outs[idx_of[u]].append(t)
                    budget[u] -= 1
                    if budget[u] <= 0 or (eos_token_id is not None
                                          and t == eos_token_id):
                        live.discard(u)
                        stop.append(u)
                        break
            return stop

        if max_new_tokens <= 0:
            self.flush(pipe.uids)
            return outs
        CHUNK = 32
        K1 = self.config.spec_decode.k + 1
        steps = max(1, CHUNK // K1) if is_spec else CHUNK
        max_ctx = self.config.state_manager.max_context
        while pipe.uids:
            if is_spec:
                rem = max(budget[u] for u in pipe.uids)
                cap = min((max_ctx - self.scheduler.seqs[u].seen_tokens - 1) // K1
                          for u in pipe.uids)
                n = min(steps, -(-rem // K1), cap)
                if n < 1:
                    # not one verify step fits under max_context: the tail
                    # runs on the plain pipeline
                    from deepspeed_tpu_torch.inference.v2.pipeline import DecodePipeline
                    uids_left = list(pipe.uids)
                    pipe.retire(uids_left)
                    pipe = DecodePipeline(self, uids_left)
                    is_spec = False
                    continue
            else:
                n = min(steps, max(budget[u] for u in pipe.uids))
            before = set(pipe.uids)
            pipe.run(n, on_tokens=on_tokens)
            for u in before - set(pipe.uids):
                self.flush([u])     # retired mid-run: recycle KV blocks now
        self.flush(pipe.uids)
        return outs


# a plain pool's page payload dtype on the host (numpy has no bfloat16)
_PAYLOAD_DTYPES = {torch.float32: np.float32, torch.bfloat16: np.uint16,
                   torch.float16: np.float16}


def _to_payload(t: torch.Tensor) -> np.ndarray:
    """Pool values -> host payload array; bf16 as its uint16 bytes."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
    return t.contiguous().cpu().numpy()


def _from_host(a: np.ndarray, device) -> torch.Tensor:
    """Host payload array -> tensor on ``device`` (uint16 bytes as int16,
    which the caller views as bf16)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    if not a.flags.writeable:
        a = a.copy()
    return host_to_device(torch.from_numpy(a), device)


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
