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
JAX package. PyTorch runs eagerly here, so it has no counterpart yet: it is
accepted, validated as in the JAX package, and has no effect.
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
    """XLA compile cache and AOT warmup in the JAX package; no effect here.
    The values are validated and normalised as the JAX package does:
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
}


@dataclass
class RaggedInferenceEngineConfig:
    state_manager: DSStateManagerConfig = field(default_factory=DSStateManagerConfig)
    kv_cache: KVCacheSizingConfig = field(default_factory=KVCacheSizingConfig)
    quantization: QuantizationConfig = field(default_factory=QuantizationConfig)
    kv_quant: KVQuantConfig = field(default_factory=KVQuantConfig)
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    compile: CompileConfig = field(default_factory=CompileConfig)
    serving: Any = field(default_factory=dict)
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
        off = []
        if self.tensor_parallel > 1:
            off.append("tensor_parallel > 1")
        if self.serving:
            off.append("serving (the serving frontend)")
        if off:
            raise NotImplementedError(
                f"{', '.join(off)}: not ported to deepspeed_tpu_torch yet")

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
