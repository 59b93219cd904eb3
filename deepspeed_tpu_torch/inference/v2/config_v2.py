"""Inference v2 engine configuration.

Same keys and defaults as the JAX package's ``RaggedInferenceEngineConfig``:
the state manager (tracked-sequence capacity, ragged token budget), KV pool
sizing, and the feature sections, with the JAX package's validation
messages. Carried: int8 and packed int4 weights (``quantization.weight_bits
= 8`` or ``4``), int8 KV pages (``kv_quant``, under a sliding window and
ALiBi too), the flash-decoding split ladder (``attention.decode_splits``),
the prefix cache (``prefix_cache``), speculative decoding
(``spec_decode``) and multi-tenant LoRA (``lora``), each validated in the
JAX package's words. Sections whose feature the port does not carry yet
(``tensor_parallel > 1``, a non-empty ``serving`` section) parse with their
usual keys and raise ``NotImplementedError`` naming the feature when it is
switched on.

The ``compile`` section configures XLA's compile cache and AOT warmup in the
JAX package. PyTorch runs eagerly here: it is validated as in the JAX
package, and ``compile.warmup`` runs ``engine.warmup()`` at build (over
``warmup_buckets`` and ``warmup_decode_steps``), as the JAX engine does; the
cache keys have no effect.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.utils.caching import next_pow2


@dataclass
class DSStateManagerConfig:
    max_tracked_sequences: int = 64          # sequences with live KV state
    max_ragged_sequence_count: int = 32      # decode rows per pass
    max_ragged_batch_size: int = 768         # token budget per pass (chunks + decode)
    max_context: int = 8192                  # per-sequence KV capacity
    prefill_chunk_size: int = 128            # tokens per prompt-chunk slot

    @property
    def chunk_budget(self) -> int:
        return self.max_ragged_batch_size - self.max_ragged_sequence_count

    @property
    def chunk_slot_size(self) -> int:
        """Static tokens per slot: exactly ``prefill_chunk_size`` unless the
        budget is smaller."""
        return min(self.prefill_chunk_size, max(1, self.chunk_budget))

    @property
    def num_chunk_slots(self) -> int:
        """Prompt-chunk slots per pass: the budget rounded to the NEAREST
        slot multiple, so realised chunk capacity is within half a slot of
        ``chunk_budget``."""
        cs = self.chunk_slot_size
        return max(1, (self.chunk_budget + cs // 2) // cs)


@dataclass
class KVCacheSizingConfig:
    block_size: int = 128
    num_blocks: Optional[int] = None         # explicit pool size
    memory_fraction: float = 0.8             # not read yet: size explicitly


@dataclass
class QuantizationConfig:
    """Weight-only quantization of the serving weights: 8 stores every
    projection and the LM head int8 with per-output-column f32 scales, 4
    stores them int4 in [-7, 7], packed two per byte along the input axis."""
    weight_bits: Optional[int] = None

    def __post_init__(self):
        if self.weight_bits not in (None, 4, 8):
            raise ValueError("quantization.weight_bits must be None, 4 or 8, "
                             f"got {self.weight_bits!r}")


@dataclass
class KVQuantConfig:
    """int8 KV pages with one f32 scale per (token, kv head) row. Needs
    head_dim % 128 == 0 and num_kv_heads * block_size % 128 == 0 (checked
    at engine build)."""
    enabled: bool = False
    bits: int = 8

    def __post_init__(self):
        if self.bits != 8:
            raise ValueError(f"kv_quant.bits must be 8, got {self.bits!r}")


@dataclass
class PrefixCacheConfig:
    """Automatic prefix caching (``prefix_cache.py``): completed sequences'
    KV pages stay in a radix tree keyed on token blocks, and new prompts
    reuse every cached whole-block prefix. ``max_cached_blocks`` caps the
    pages the tree may hold (None: bounded by the pool; idle cached pages
    are evicted LRU when an allocation would fail); ``eviction`` must be
    ``"lru"``."""
    enabled: bool = False
    max_cached_blocks: Optional[int] = None
    eviction: str = "lru"

    def __post_init__(self):
        if self.eviction != "lru":
            raise ValueError(
                f"prefix_cache.eviction must be 'lru', got {self.eviction!r}")
        if self.max_cached_blocks is not None and self.max_cached_blocks < 1:
            raise ValueError("prefix_cache.max_cached_blocks must be >= 1 "
                             f"(or None), got {self.max_cached_blocks}")


@dataclass
class CompileConfig:
    """XLA compile cache and AOT warmup in the JAX package. Here ``warmup``
    runs ``engine.warmup(warmup_buckets, warmup_decode_steps)`` at build;
    the cache keys have no effect. The values are validated and normalised
    as the JAX package does:
    ``warmup_buckets`` must be ints >= 1 and is rounded up to the pow2 grid
    (sorted, without repeats), ``warmup_decode_steps`` must be ints >= 1."""
    cache_dir: Optional[str] = None
    min_compile_time_secs: float = 2.0
    warmup: bool = False
    warmup_buckets: Optional[Any] = None
    warmup_decode_steps: Any = ()

    def __post_init__(self):
        if self.warmup_buckets is not None:
            if any(not isinstance(b, int) or b < 1 for b in self.warmup_buckets):
                raise ValueError("compile.warmup_buckets must be ints >= 1, "
                                 f"got {self.warmup_buckets!r}")
            self.warmup_buckets = sorted({next_pow2(b) for b in self.warmup_buckets})
        if any(not isinstance(n, int) or n < 1 for n in self.warmup_decode_steps):
            raise ValueError("compile.warmup_decode_steps must be ints >= 1, "
                             f"got {self.warmup_decode_steps!r}")


@dataclass
class SpecDecodeConfig:
    """Speculative decoding (``spec/``): ``engine.decode_pipeline`` returns
    a ``SpecDecodePipeline`` for greedy requests, which drafts up to ``k``
    tokens a sequence from its own history (n-gram matching of a suffix of
    ``min_match`` to ``max_ngram`` tokens), verifies them in one ragged
    forward (``ragged_model.build_verify_step``) and emits the accepted
    prefix plus one greedy token. ``adaptive``: a reject drops a row's
    draft budget to accepted + 1, a full accept doubles it back toward
    ``k``. The JAX package also warns when ``k + 1`` is not a power of two
    (its TPU kernel's q-block); the port's chunk kernel packs a slot's
    (row, head) pairs into blocks of 64 whatever ``k`` is, so the port has
    no such warning."""
    enabled: bool = False
    k: int = 3
    min_match: int = 2
    max_ngram: int = 4
    adaptive: bool = True

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec_decode.k must be >= 1, got {self.k}")
        if self.min_match < 1:
            raise ValueError("spec_decode.min_match must be >= 1, got "
                             f"{self.min_match}")
        if self.max_ngram < self.min_match:
            raise ValueError(
                f"spec_decode.max_ngram ({self.max_ngram}) must be >= "
                f"min_match ({self.min_match})")


@dataclass
class LoraConfig:
    """Multi-tenant LoRA serving (``inference/v2/lora/``): one base model
    plus per-tenant low-rank adapters, served from a paged adapter-weight
    pool managed like the KV pool (one page a rank slice, refcounted per
    in-flight request, LRU-evicted to pinned host buffers under pool
    pressure and restored byte for byte).

    ``pool_pages``: device pages in the adapter pool (a rank-r adapter takes
    r); must hold one ``max_rank`` adapter. ``max_rank``: the largest rank
    the engine accepts; decode and verify run at the rank bucket
    ``next_pow2(max registered rank)``, smaller adapters padding their page
    rows with the pool's zero page. ``targets``: the projections that carry
    deltas, a subset of ``("q", "k", "v", "o")``; deltas apply in the decode
    and verify steps only (prefill runs the base model). ``swap_buffers``
    caps the pinned host buffers evicted adapters park in. Validated in the
    JAX package's words."""
    enabled: bool = False
    pool_pages: int = 64
    max_rank: int = 16
    targets: Any = ("q", "v")
    swap_buffers: int = 16

    def __post_init__(self):
        self.targets = tuple(self.targets)
        bad = [t for t in self.targets if t not in ("q", "k", "v", "o")]
        if bad:
            raise ValueError(f"lora.targets must be a subset of "
                             f"('q', 'k', 'v', 'o'), got {self.targets!r}")
        if not self.targets:
            raise ValueError("lora.targets must name at least one projection")
        if self.max_rank < 1:
            raise ValueError(f"lora.max_rank must be >= 1, got {self.max_rank}")
        if self.pool_pages < self.max_rank:
            raise ValueError(
                f"lora.pool_pages ({self.pool_pages}) must hold at least one "
                f"max_rank ({self.max_rank}) adapter")
        if self.swap_buffers < 1:
            raise ValueError("lora.swap_buffers must be >= 1, got "
                             f"{self.swap_buffers}")


@dataclass
class PriorityClassConfig:
    """One tenant priority class for the serving frontend
    (``inference/v2/serving/``): a strict-priority level plus the latency
    SLOs admission plans against. ``priority`` is higher-wins; ``ttft_slo_ms``
    bounds time-to-first-token (arrival -> first streamed token) and
    ``tbt_slo_ms`` bounds time-between-tokens — the two numbers
    goodput-under-SLO is gated on (docs/SERVING.md "Frontend")."""
    name: str
    priority: int
    ttft_slo_ms: float = 2000.0
    tbt_slo_ms: float = 250.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("priority class needs a non-empty name")
        if self.ttft_slo_ms <= 0 or self.tbt_slo_ms <= 0:
            raise ValueError(f"class {self.name!r}: SLO targets must be > 0")


def _default_classes():
    return [PriorityClassConfig("interactive", 2, 500.0, 100.0),
            PriorityClassConfig("standard", 1, 2000.0, 250.0),
            PriorityClassConfig("batch", 0, 30000.0, 2000.0)]


@dataclass
class ServingConfig:
    """The SLO-aware serving frontend (``inference/v2/serving/frontend.py``).

    ``classes``: the tenant priority classes (dicts or
    :class:`PriorityClassConfig`), strict priority between classes, FIFO
    within one.

    ``decode_slice``: pipeline steps per ``DecodePipeline.run`` burst — the
    iteration-level continuous-batching grain. Admission, retirement,
    preemption and restore all happen at slice boundaries; a smaller slice
    lowers admission latency, a larger one amortises per-run host work.

    ``preemption`` picks what happens to low-priority victims under KV-pool
    pressure:

    - ``"offload"`` (default): the victim's *private* KV pages (allocator
      refcount 1 — prefix-cache-shared pages are never touched) round-trip
      through pinned host buffers (``runtime/swap_tensor/buffer_pool.py``)
      and are restored byte-identically on readmit; falls back to recompute
      per victim when ``max_offload_bytes`` is exhausted.
    - ``"recompute"``: the victim is flushed and re-prefilled from its
      prompt + generated-so-far tokens on readmit (vLLM's drop-and-recompute
      baseline).
    - ``"none"``: reject-only — no preemption; admission turns conservative
      (a request is admitted only when its full prompt + ``max_new_tokens``
      KV lifetime is fundable up front) and excess load is held, then shed.

    ``shed_factor``: a queued request is shed once
    ``elapsed_queue_delay + predicted_prefill + one_slice >
    ttft_slo_ms * shed_factor`` — it can no longer meet its SLO, so
    admitting it would burn prefill compute on a guaranteed miss.

    ``max_offload_bytes``: host-buffer capacity for offloaded pages (None =
    unbounded); ``offload_buffers`` caps the pinned-buffer pool's free list.
    ``max_queue`` bounds the pending queue (beyond = immediate shed);
    ``idle_wait_s`` is the engine thread's block interval when idle.

    ``attribution``: record the per-request phase ledger
    (``RequestHandle.timeline()`` — queued/admission/prefill/handoff_wait/
    decode/preempted/restore/migration stints from the same perf stamps the
    trace spans carry) and bucket SLO misses by dominant phase
    (``serve/slo/*``; docs/OBSERVABILITY.md "SLO-miss attribution"). A few
    list appends per phase TRANSITION — nothing per token; ``False``
    disables both.

    ``spec``: serve greedy requests through the engine's speculative
    pipeline when ``spec_decode.enabled`` (default). ``False`` pins this
    frontend to the plain ``DecodePipeline`` — a per-frontend A/B lever
    (draft-miss overhead vs k-token amortization): spec-on and spec-off
    greedy streams agree only up to cross-kernel float noise (the verify
    step attends through the chunk kernel, the plain step through the
    decode kernel), so a replay held bit-exactly against a plain reference
    serves plain.

    ``tenant_classes``: explicit tenant -> priority-class mapping (tenant
    here = LoRA adapter name, the multi-tenant identity of docs/SERVING.md
    "Multi-tenant LoRA"). Per-request ``priority=`` stays the override, but
    a submit that names an adapter WITHOUT naming a class defaults to the
    tenant's mapped class instead of ``"standard"`` — mixed benches stop
    misclassifying traffic whose class lives in workload config rather
    than on each request. Every value must name a configured class.
    """
    classes: Any = field(default_factory=_default_classes)
    tenant_classes: Any = field(default_factory=dict)
    decode_slice: int = 8
    spec: bool = True
    preemption: str = "offload"
    max_offload_bytes: Optional[int] = None
    offload_buffers: int = 16
    shed_factor: float = 1.0
    max_queue: int = 1024
    idle_wait_s: float = 0.02
    attribution: bool = True

    def __post_init__(self):
        self.classes = [PriorityClassConfig(**c) if isinstance(c, dict) else c
                        for c in self.classes]
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate priority class names: {names}")
        if not self.classes:
            raise ValueError("serving.classes must name at least one class")
        if self.preemption not in ("offload", "recompute", "none"):
            raise ValueError("serving.preemption must be 'offload', "
                             f"'recompute' or 'none', got {self.preemption!r}")
        if self.decode_slice < 1:
            raise ValueError("serving.decode_slice must be >= 1")
        self.tenant_classes = dict(self.tenant_classes)
        for tenant, cls_name in self.tenant_classes.items():
            if cls_name not in names:
                raise ValueError(
                    f"serving.tenant_classes[{tenant!r}] = {cls_name!r} names "
                    f"no configured priority class (configured: {names})")

    def get_class(self, name: str) -> PriorityClassConfig:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(f"unknown priority class {name!r}; configured: "
                       f"{[c.name for c in self.classes]}")

    def class_for(self, priority: Optional[str],
                  tenant: Optional[str] = None) -> PriorityClassConfig:
        """Resolve a request's class: explicit ``priority`` wins, else the
        tenant's ``tenant_classes`` mapping, else ``"standard"``."""
        if priority is not None:
            return self.get_class(priority)
        if tenant is not None and tenant in self.tenant_classes:
            return self.get_class(self.tenant_classes[tenant])
        return self.get_class("standard")


@dataclass
class HealthConfig:
    """Replica failure detection + self-healing for the multi-replica router
    (``inference/v2/serving/health.py``; docs/SERVING.md "Failure
    semantics"). Off by default: a router without health monitoring keeps
    the unmonitored behavior — a dead replica surfaces NAMED at
    ``drain()``/``close()`` instead of being failed over.

    When ``enabled``, a ``dstpu-health`` thread polls every ``interval_s``:
    engine-thread/prefill-worker LIVENESS (a died loop is ``down``
    immediately) plus a PROGRESS heartbeat — the decode-step counter the
    pipeline stats already track (and prefill tokens completed) — so a
    *wedged* replica is detected, not just a dead one. A replica with work
    in flight whose counters stop moving turns ``suspect`` after
    ``suspect_after_s`` and ``down`` after ``down_after_s``; detection
    fences the replica (its loop emits nothing further), migrates every
    in-flight request to a survivor, and — with ``auto_rejoin`` — rebuilds
    a frontend on the engine once its old thread has exited, re-warming the
    pow2 program grids off the hot path (``rejoin_warmup``) before the
    replica re-enters routing.

    ``fence_join_s`` bounds how long failover waits for the failed engine
    thread to exit before migrating anyway (streams stay exact either way:
    migration seals each handle under its emit lock, and a fenced loop
    drops every later emission)."""
    enabled: bool = False
    interval_s: float = 0.05
    suspect_after_s: float = 1.0
    down_after_s: float = 3.0
    fence_join_s: float = 1.0
    auto_rejoin: bool = True
    rejoin_warmup: bool = True

    def __post_init__(self):
        for f in ("interval_s", "suspect_after_s", "down_after_s",
                  "fence_join_s"):
            if getattr(self, f) <= 0:
                raise ValueError(f"health.{f} must be > 0, got "
                                 f"{getattr(self, f)}")
        if self.down_after_s < self.suspect_after_s:
            raise ValueError(
                f"health.down_after_s ({self.down_after_s}) must be >= "
                f"suspect_after_s ({self.suspect_after_s})")


@dataclass
class RouterConfig:
    """The multi-replica serving router (``inference/v2/serving/router.py``;
    docs/SERVING.md "Multi-replica & disaggregation"). Cluster-level — it
    configures a ``ServingRouter`` over N engines, not any single engine.

    ``policy`` picks request placement:

    - ``"cache_aware"`` (default): route to the replica whose radix prefix
      cache holds the longest cached match for the prompt (the
      SGLang-RadixAttention trick at cluster scope, read from a shared
      chain-hash index fed by per-replica insert/evict deltas), scored
      against load: ``score = cached_tokens - balance * outstanding``.
    - ``"round_robin"``: placement ignores caches — the bench baseline.

    ``balance`` is the stickiness/balance tradeoff knob: how many cached
    prompt tokens one outstanding request on a replica outweighs. ``0`` is
    pure stickiness (hotspot risk); large values degrade to least-loaded.

    ``topology``:

    - ``"colocated"`` (default): every replica runs prefill AND decode.
    - ``"disaggregated"``: dedicated prefill replicas run SplitFuse passes
      and hand finished KV to decode replicas over the page fabric
      (``engine.export_kv``/``import_kv`` — the same bucketed page gather
      preempt-offload rides), eliminating prefill interference on decode
      TBT.

    ``federation``: aggregate per-replica admission state (per-class
    queue-delay EMAs + SLO cost models) into placement — a replica whose
    predicted TTFT already busts the class SLO is skipped while a cold one
    absorbs, and the router sheds up front when EVERY candidate is hot
    (``shed_factor`` scales the SLO bound exactly like
    ``ServingConfig.shed_factor``).

    ``health``: replica failure detection + self-healing
    (:class:`HealthConfig`; docs/SERVING.md "Failure semantics").

    ``handoff_retries`` / ``handoff_timeout_s`` / ``handoff_backoff_s``:
    bounded-retry budget for the disaggregated prefill->decode handoff
    (``utils/resilience.retry_call`` semantics). Each attempt is
    deadline-wrapped (``IOTimeout`` past ``handoff_timeout_s`` — a wedged
    decode replica must not stall the prefill worker unboundedly) and
    re-planned against a DIFFERENT decode replica; a request that exhausts
    the budget is shed with the error NAMED on its handle
    (``RequestHandle.error``), never swallowed."""
    policy: str = "cache_aware"
    balance: float = 32.0
    topology: str = "colocated"
    federation: bool = True
    shed_factor: float = 1.0
    health: Any = field(default_factory=HealthConfig)
    handoff_retries: int = 3
    handoff_timeout_s: Optional[float] = 30.0
    handoff_backoff_s: float = 0.05

    def __post_init__(self):
        if isinstance(self.health, dict):
            self.health = HealthConfig(**self.health)
        if self.handoff_retries < 1:
            raise ValueError("router.handoff_retries must be >= 1, got "
                             f"{self.handoff_retries}")
        if self.handoff_timeout_s is not None and self.handoff_timeout_s <= 0:
            raise ValueError("router.handoff_timeout_s must be > 0 (or "
                             f"None), got {self.handoff_timeout_s}")
        if self.handoff_backoff_s < 0:
            raise ValueError("router.handoff_backoff_s must be >= 0, got "
                             f"{self.handoff_backoff_s}")
        if self.policy not in ("cache_aware", "round_robin"):
            raise ValueError("router.policy must be 'cache_aware' or "
                             f"'round_robin', got {self.policy!r}")
        if self.topology not in ("colocated", "disaggregated"):
            raise ValueError("router.topology must be 'colocated' or "
                             f"'disaggregated', got {self.topology!r}")
        if self.balance < 0:
            raise ValueError(f"router.balance must be >= 0, got {self.balance}")
        if self.shed_factor <= 0:
            raise ValueError("router.shed_factor must be > 0, got "
                             f"{self.shed_factor}")


@dataclass
class AttentionConfig:
    """Flash-decoding split ladder: paged attention runs at a pow2 rung of
    ``[1, 2, ..., decode_splits]`` picked each step as
    ``min(decode_splits, pow2_floor(max_live_ctx / min_ctx_per_split))``."""
    decode_splits: int = 1
    min_ctx_per_split: int = 512

    def __post_init__(self):
        if self.decode_splits < 1 or (
                self.decode_splits & (self.decode_splits - 1)) != 0:
            raise ValueError(
                "attention.decode_splits must be a power of two >= 1 (the "
                f"warmed pow2 split ladder), got {self.decode_splits}")
        if self.min_ctx_per_split < 1:
            raise ValueError("attention.min_ctx_per_split must be >= 1, "
                             f"got {self.min_ctx_per_split}")


_SECTIONS = {
    "state_manager": DSStateManagerConfig,
    "kv_cache": KVCacheSizingConfig,
    "quantization": QuantizationConfig,
    "kv_quant": KVQuantConfig,
    "prefix_cache": PrefixCacheConfig,
    "compile": CompileConfig,
    "spec_decode": SpecDecodeConfig,
    "lora": LoraConfig,
    "attention": AttentionConfig,
    "serving": ServingConfig,
}


@dataclass
class RaggedInferenceEngineConfig:
    state_manager: DSStateManagerConfig = field(default_factory=DSStateManagerConfig)
    kv_cache: KVCacheSizingConfig = field(default_factory=KVCacheSizingConfig)
    quantization: QuantizationConfig = field(default_factory=QuantizationConfig)
    kv_quant: KVQuantConfig = field(default_factory=KVQuantConfig)
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    compile: CompileConfig = field(default_factory=CompileConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    spec_decode: SpecDecodeConfig = field(default_factory=SpecDecodeConfig)
    lora: LoraConfig = field(default_factory=LoraConfig)
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    tensor_parallel: int = 1
    dtype: torch.dtype = torch.bfloat16
    seed: int = 0

    def __post_init__(self):
        if self.state_manager.chunk_budget <= 0:
            raise ValueError(
                "max_ragged_batch_size must exceed max_ragged_sequence_count")
        self.check_slice()

    def check_slice(self) -> None:
        """Refuse every feature the port does not carry yet, by name."""
        if self.lora.enabled and self.tensor_parallel > 1:
            # the JAX engine's refusal (its engine_v2 :296-302)
            raise NotImplementedError(
                "multi-tenant LoRA with tensor_parallel > 1 is not wired "
                "(adapter pages are unsharded whole-projection slices); "
                "run lora at tp=1")
        if self.tensor_parallel > 1:
            raise NotImplementedError(
                "tensor_parallel > 1: not ported to deepspeed_tpu_torch yet")

    @classmethod
    def load(cls, config=None, **overrides) -> "RaggedInferenceEngineConfig":
        if isinstance(config, cls):
            if overrides:
                raise ValueError("pass overrides via a dict config, not on top "
                                 "of an already-built RaggedInferenceEngineConfig")
            config.check_slice()
            return config
        d = dict(config or {})
        d.update(overrides)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown engine config keys {sorted(unknown)}")
        for name, section in _SECTIONS.items():
            if isinstance(d.get(name), dict):
                d[name] = section(**d[name])
        return cls(**d)
