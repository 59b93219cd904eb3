"""The ragged forward of the v2 engine, in eager PyTorch.

One forward serves every family the adapters map onto
:class:`RaggedModelSpec` (an :class:`Adapter` each): the Llama lineage
(``LLAMA``: RMSNorm, SwiGLU, RoPE, untied head; Qwen2's biased q/k/v,
Gemma's scaled embedding, ``1 + weight`` norms and GeGLU, Mixtral's routed
experts through :func:`_moe_ffn`), GPT-2 (``GPT2``) and the generic decoder
(``DECODER``: OPT, Falcon, Phi, GPT-NeoX, GPT-J and BLOOM), whose
structural flags (norm, activation, full or partial rotary or none, learned
positions, parallel blocks, biases, tied head, head bias, embedding norm,
ALiBi) follow the JAX package's ``ragged_model.py``.

Pass structure (see ``ragged/ragged_batch.py``): tokens = [filled prompt-chunk
slots | decode rows]. Each layer writes the pass's K/V into the paged pool
(in place), then attends through ``AttentionKernelSpec``:

  - chunk slots -> ``chunk`` (paged chunk kernel, causal by absolute position)
  - decode rows -> ``decode`` (paged decode kernel, one token per sequence)

A pass that prefills every sequence from position 0 takes
:func:`build_prefill_forward` instead: packed attention over the pass's own
rows, then whole-page writes; an ALiBi model never does (the packed kernel
has no position bias), so its prefill runs the paged pass. The pipelined
decode step (:func:`build_decode_step`) attends the current token as a side
row and writes it into its page afterwards. A burst of decode steps
(:func:`build_multistep_decode`, the engine's ``decode_steps``) keeps its
new rows in a side slab and flushes them into the pages at its end, or
writes each step's row first where the slab does not fit.

A sliding window (``spec.window``, Mistral) and ALiBi (``spec.alibi``,
BLOOM) are bound into every attention dispatch (``AttentionKernelSpec``).

Multi-tenant LoRA (``lora_targets`` on the decode, verify and burst
builders): each row reads its adapter's rank-slice pages from the pool
(:func:`lora_layer_operands`, one layer at a time) and adds ``(x @ A) @ B``
to the targeted q/k/v/o projections (:func:`_lora_mm`), an f32 product
pair in plain torch ops, as the JAX package leaves it to XLA.

A Python loop over layers takes the place of the JAX package's ``lax.scan``,
and each layer indexes its own pool view ``kv[l]`` (and, for an int8 pool,
its scale tiles ``kv_scales[l]``), so no layer offset enters the block
tables or the write destinations.

The serving weight tree: ``weights["layers"]`` is a list of per-layer dicts
(``ln1``, ``ln2`` norm scales with ``ln1_bias``/``ln2_bias`` for LayerNorm;
``wq``/``wk``/``wv``/``wo`` with optional ``bq``/``bk``/``bv``/``bo``;
``w_gate``/``w_up``/``w_down`` with optional ``b_up``/``b_down``, or, for
an MoE layer, ``moe``: ``{"router" [hidden, E], "w_gate", "w_up" [E, hidden,
ff], "w_down" [E, ff, hidden]}``), beside
``embed``, ``final_norm`` (and ``final_norm_bias``), optional ``pos_embed``,
``embed_norm``/``embed_norm_bias``, ``lm_head`` and ``lm_head_bias``. A tied
head keeps ``embed_f32``, one f32 copy of the embedding made at build (the
head computes ``x.f32 @ embed.f32.T``, as the JAX package; a per-step
conversion would allocate the whole f32 table each step).

Projections go through :func:`_mm`: a plain matrix product (``x @
kernel``, kernels ``[in, out]``), or, for a weight tree quantized as it
lands (:func:`adapt_model` with ``quantize``; the bytes of
:func:`quantize_weights_int8` or :func:`quantize_weights_int4`, packed two
per byte), the int8 matmul kernel (K8); an MoE
layer's expert products go through K8's grouped entries
(``quantized_matmul_grouped``), each row with its expert's weight. With an int8 KV
pool every page write quantizes its rows (``_kv_page_write_quant``,
``_kv_page_write_pages_quant``); the packed prefill still attends its
in-flight rows at full precision.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.attention import (AttentionKernelSpec,
                                                       token_write_rows, write_rows)
from deepspeed_tpu_torch.models.decoder import PLAIN_ACTS, layer_norm
from deepspeed_tpu_torch.models.llama import apply_rope, mlp_gate_act, rope_tables
from deepspeed_tpu_torch.ops.kernels.kv_quant import (kv_quantize_rows,
                                                      kv_write_dequant,
                                                      scale_tile_rows,
                                                      scale_write_index)
from deepspeed_tpu_torch.ops.kernels.quantized_matmul import (quantized_matmul,
                                                              quantized_matmul_grouped,
                                                              quantized_matmul_int4)
from deepspeed_tpu_torch.ops.quantizer import pack_int4


@dataclass
class RaggedModelSpec:
    family: str
    num_layers: int
    hidden_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    norm: str = "rms"                 # "rms" | "ln"
    # gated: "swiglu" (silu gate) | "geglu" (tanh-gelu gate, Gemma); plain:
    # see PLAIN_ACTS
    activation: str = "swiglu"
    rope_theta: Optional[float] = 10000.0   # None -> no rotary
    rotary_dim: Optional[int] = None        # partial rotary (phi); None = full head
    learned_pos: bool = False         # gpt2/opt learned position embeddings
    pos_offset: int = 0               # opt: positions are offset by 2 in the table
    parallel_block: bool = False      # falcon/phi: attn + mlp both from the same norm
    parallel_dual_norm: bool = False  # gpt_neox: parallel, but MLP from ln2(x)
    tied_lm_head: bool = False        # logits = x.f32 @ embed.f32.T
    head_bias: bool = False           # phi/gpt-j: bias added to the logits
    embed_scale_by_sqrt_dim: bool = False  # gemma: x *= sqrt(hidden) after embed
    norm_plus_one: bool = False       # gemma: RMSNorm scales by (1 + weight)
    eps: float = 1e-5
    window: Optional[int] = None      # sliding-window span (Mistral); None = full
    alibi: bool = False               # BLOOM: per-head linear position bias
    embed_norm: bool = False          # BLOOM: a norm right after the embedding
    moe: Optional[Dict[str, int]] = None  # {"num_experts": E, "top_k": k}
    dtype: torch.dtype = torch.bfloat16


def _llama_spec(config, max_context: Optional[int] = None) -> RaggedModelSpec:
    """The Llama lineage's spec from its config alone (Llama, Mistral,
    Mixtral, Qwen2, Gemma: the JAX package's ``adapt_llama`` :99-173):
    Gemma's flags and activation, Mixtral's experts, Mistral's window."""
    moe = None
    if hasattr(config, "num_local_experts"):
        moe = {"num_experts": config.num_local_experts,
               "top_k": config.num_experts_per_tok}
    mlp_act = getattr(config, "mlp_act", "silu")
    mlp_gate_act(mlp_act)            # refuses an activation with no gated mapping
    window = getattr(config, "sliding_window", None)
    if window is not None and max_context is not None and max_context <= window:
        window = None   # no position can see past the window: full attention
    return RaggedModelSpec(
        family="mixtral" if moe else "llama",
        num_layers=config.num_hidden_layers,
        hidden_size=config.hidden_size,
        num_heads=config.num_attention_heads,
        num_kv_heads=config.num_key_value_heads,
        head_dim=config.head_dim,
        vocab_size=config.vocab_size,
        norm="rms", activation="swiglu" if mlp_act == "silu" else "geglu",
        rope_theta=config.rope_theta,
        embed_scale_by_sqrt_dim=getattr(config, "embed_scale_by_sqrt_dim", False),
        norm_plus_one=getattr(config, "norm_plus_one", False),
        eps=config.rms_norm_eps, moe=moe, window=window)


#: the Llama lineage's flat names (a layer's after ``layers_{i}/``) and the
#: serving keys they land under: attention and norms, Qwen2's q/k/v biases,
#: a dense MLP or an MoE layer's router and expert stacks (``moe``)
_LLAMA_ATTN = {"input_layernorm/weight": "ln1", "post_attention_layernorm/weight": "ln2",
               **{f"self_attn/{p}_proj/kernel": f"w{p}" for p in "qkvo"}}
_LLAMA_QKV_BIAS = {f"self_attn/{p}_proj/bias": f"b{p}" for p in "qkv"}
_LLAMA_MLP = {f"mlp/{p}_proj/kernel": f"w_{p}" for p in ("gate", "up", "down")}
_LLAMA_MOE = {"block_sparse_moe/gate/kernel": "router",
              **{f"block_sparse_moe/{k}": k for k in ("w_gate", "w_up", "w_down")}}
_LLAMA_LAYER = {**_LLAMA_ATTN, **_LLAMA_QKV_BIAS, **_LLAMA_MLP, **_LLAMA_MOE}
_LLAMA_TOP = {"embed_tokens/embedding": "embed", "norm/weight": "final_norm",
              "lm_head/kernel": "lm_head"}


def _llama_weights(params: Mapping[str, torch.Tensor], config) -> Dict:
    """Flax-named Llama-lineage tree (``checkpoint/convert.py``) -> the
    serving tree: ``weights["layers"]`` is a list of per-layer dicts
    referencing the same tensors (no stacking, so no copy)."""
    moe = hasattr(config, "num_local_experts")
    layers = []
    for i in range(config.num_hidden_layers):
        p = f"layers_{i}/"
        names = dict(_LLAMA_ATTN)
        if p + "self_attn/q_proj/bias" in params:     # Qwen2 lineage: biased q/k/v
            names.update(_LLAMA_QKV_BIAS)
        layer = {k: params[p + n] for n, k in names.items()}
        mlp = {k: params[p + n] for n, k in (_LLAMA_MOE if moe else _LLAMA_MLP).items()}
        layer.update({"moe": mlp} if moe else mlp)
        layers.append(layer)
    return {"layers": layers, **{k: params[n] for n, k in _LLAMA_TOP.items()}}


def _layer_key(name: str, prefix: str, table: Callable) -> Optional[str]:
    """The serving key of flat ``name``: a layer's (``{prefix}{i}/rest``)
    through ``table(rest)``, else None."""
    head, _, rest = name.partition("/")
    if head.startswith(prefix) and head[len(prefix):].isdigit():
        return table(rest)
    return None


def _llama_key(name: str) -> Optional[str]:
    return _layer_key(name, "layers_", _LLAMA_LAYER.get) or _LLAMA_TOP.get(name)


def _tie_head(weights: Dict) -> Dict:
    """A tied head's f32 embedding, made once at build (the same tensor
    when the embedding is already f32)."""
    weights["embed_f32"] = weights["embed"].float()
    return weights


def _columns(w, start: int, stop: int):
    """Columns ``[start, stop)`` of a ``[K, N]`` kernel: a view of a plain
    tensor, or a quantized dict's weight and scale columns (contiguous, as
    the matmul kernel reads them; per-column quantization makes them the
    bytes of quantizing the columns alone)."""
    if isinstance(w, dict):
        return {k: v[..., start:stop].contiguous() for k, v in w.items()}
    return w[:, start:stop]


def _gpt2_spec(config, max_context: Optional[int] = None) -> RaggedModelSpec:
    """GPT-2: LayerNorm, tanh gelu, learned positions, tied head."""
    E = config.n_embd
    return RaggedModelSpec(
        family="gpt2",
        num_layers=config.n_layer,
        hidden_size=E,
        num_heads=config.n_head,
        num_kv_heads=config.n_head,
        head_dim=E // config.n_head,
        vocab_size=config.vocab_size,
        norm="ln", activation="gelu", rope_theta=None, learned_pos=True,
        tied_lm_head=True, eps=1e-5)


#: the port's ``GPT2LMHead`` flat names after ``h_{i}/`` and their serving
#: keys; the fused c_attn (``wqkv``, ``bqkv``) is cut into q/k/v columns
_GPT2_LAYER = {"ln_1/scale": "ln1", "ln_1/bias": "ln1_bias",
               "ln_2/scale": "ln2", "ln_2/bias": "ln2_bias",
               "attn/c_attn/kernel": "wqkv", "attn/c_attn/bias": "bqkv",
               "attn/c_proj/kernel": "wo", "attn/c_proj/bias": "bo",
               "mlp/c_fc/kernel": "w_up", "mlp/c_fc/bias": "b_up",
               "mlp/c_proj/kernel": "w_down", "mlp/c_proj/bias": "b_down"}
_GPT2_TOP = {"wte/embedding": "embed", "wpe/embedding": "pos_embed",
             "ln_f/scale": "final_norm", "ln_f/bias": "final_norm_bias"}


def _gpt2_weights(params: Mapping[str, torch.Tensor], config) -> Dict:
    """The port's ``GPT2LMHead`` flat tree (``wte/embedding``,
    ``h_{i}/attn/c_attn/kernel`` ...): the fused c_attn qkv is cut into
    wq/wk/wv columns."""
    E = config.n_embd
    layers = []
    for i in range(config.n_layer):
        layer = {k: params[f"h_{i}/{n}"] for n, k in _GPT2_LAYER.items()}
        wqkv, bqkv = layer.pop("wqkv"), layer.pop("bqkv")     # [E, 3E], [3E]
        for j, n in enumerate("qkv"):
            layer["w" + n] = _columns(wqkv, j * E, (j + 1) * E)
            layer["b" + n] = bqkv[j * E:(j + 1) * E]
        layers.append(layer)
    weights = {k: params[n] for n, k in _GPT2_TOP.items()}
    return _tie_head({**weights, "layers": layers})


def _gpt2_key(name: str) -> Optional[str]:
    return _layer_key(name, "h_", _GPT2_LAYER.get) or _GPT2_TOP.get(name)


def _decoder_key(rest: str) -> str:
    """A generic-decoder layer parameter's key in the serving tree:
    ``ln1/scale`` -> ``ln1``, ``ln1/bias`` -> ``ln1_bias``, ``mlp/w_up`` ->
    ``w_up``; ``wq``, ``bq`` ... stay."""
    rest = rest[len("mlp/"):] if rest.startswith("mlp/") else rest
    return rest.replace("/scale", "").replace("/bias", "_bias")


def _decoder_spec(config, max_context: Optional[int] = None) -> RaggedModelSpec:
    """``models/decoder.py`` (``DecoderLM``: opt/falcon/phi/gpt_neox/gptj/
    gpt_bigcode/bloom). Guards on the FEATURES the ragged path cannot
    carry (not family names), in the JAX package's words."""
    unsupported = []
    if getattr(config, "local_window", None) is not None:
        unsupported.append("local_window")
    if any(k == "local" for k in getattr(config, "attention_layers", None) or ()):
        unsupported.append("attention_layers with 'local' entries")
    if getattr(config, "attn_scale", None) is not None:
        unsupported.append("attn_scale")
    if unsupported:
        raise ValueError(
            f"config features {unsupported} are not supported by the ragged "
            "(paged) attention path — serve through deepspeed_tpu."
            "init_inference (v1 dense engine) instead")
    return RaggedModelSpec(
        family=config.family,
        num_layers=config.num_hidden_layers,
        hidden_size=config.hidden_size,
        num_heads=config.num_attention_heads,
        num_kv_heads=config.kv_heads,
        head_dim=config.head_dim,
        vocab_size=config.vocab_size,
        norm=config.norm, activation=config.activation,
        rope_theta=config.rope_theta, rotary_dim=config.rotary_dim,
        learned_pos=config.learned_pos, pos_offset=config.pos_offset,
        parallel_block=config.parallel_block,
        parallel_dual_norm=config.parallel_dual_norm,
        tied_lm_head=config.tied_lm_head, head_bias=config.head_bias,
        alibi=getattr(config, "alibi", False),
        embed_norm=getattr(config, "embed_norm", False),
        eps=config.eps)


_DECODER_TOP = {"embed/embedding": "embed", "final_norm/scale": "final_norm",
                "final_norm/bias": "final_norm_bias", "lm_head": "lm_head",
                "lm_head_bias": "lm_head_bias", "pos_embed/embedding": "pos_embed",
                "embed_norm/scale": "embed_norm", "embed_norm/bias": "embed_norm_bias"}
_DECODER_REQUIRED = ("embed", "final_norm")


def _decoder_weights(params: Mapping[str, torch.Tensor], config) -> Dict:
    """The generic decoder's flat tree, re-rooted: each layer's names
    through :func:`_decoder_key`, the optional top-level ones where
    present."""
    layers = []
    for i in range(config.num_hidden_layers):
        p = f"layers_{i}/"
        layers.append({_decoder_key(k[len(p):]): params[k] for k in params
                       if k.startswith(p)})
    weights = {k: params[n] for n, k in _DECODER_TOP.items()
               if k in _DECODER_REQUIRED or n in params}
    weights["layers"] = layers
    return _tie_head(weights) if config.tied_lm_head else weights


def _decoder_key_of(name: str) -> Optional[str]:
    return _layer_key(name, "layers_", _decoder_key) or _DECODER_TOP.get(name)


@dataclass(frozen=True)
class Adapter:
    """A lineage's map from its flat parameter tree to the serving tree:
    ``spec(config, max_context)`` reads no tensor (so a build is refused
    before any lands), ``weights(params, config)`` reads each name once
    and places it, and ``key(name)`` names the serving key a flat name
    lands under (how the landing knows what to quantize)."""
    spec: Callable
    weights: Callable
    key: Callable


LLAMA = Adapter(_llama_spec, _llama_weights, _llama_key)
GPT2 = Adapter(_gpt2_spec, _gpt2_weights, _gpt2_key)
DECODER = Adapter(_decoder_spec, _decoder_weights, _decoder_key_of)

ADAPTERS: Dict[str, Adapter] = {
    # llama lineage (qwen2 = biased qkv; gemma = structural flags: both are
    # LlamaConfig features the adapter reads)
    "llama": LLAMA,
    "mistral": LLAMA,
    "mixtral": LLAMA,
    "qwen2": LLAMA,
    "gemma": LLAMA,
    "gpt2": GPT2,
    # generic-decoder lineage (canonical parameter names; re-rooting only)
    "opt": DECODER,
    "falcon": DECODER,
    "phi": DECODER,
    "gpt_neox": DECODER,
    "gptj": DECODER,
    "gpt_bigcode": DECODER,
    "bloom": DECODER,   # ALiBi carried by the paged kernels
}

#: families whose attention needs a bias the ragged kernels don't carry
_UNSUPPORTED = {
    # gpt_neo alternates GLOBAL and LOCAL attention layers; the ragged spec
    # carries one window for all layers
    "gpt_neo": "per-layer alternating local-window attention",
}


def adapt_model(family: str, params: Mapping[str, torch.Tensor], config,
                max_context: Optional[int] = None, quantize: Optional[Callable] = None,
                check: Optional[Callable] = None) -> Tuple[RaggedModelSpec, Dict]:
    """(spec, serving weights) through the family's adapter, refusing
    unsupported families in the JAX package's words. ``check(spec)`` runs
    before any tensor is read. With ``quantize`` (``quantize_weight_int8``
    or ``_int4``), each tensor whose serving key weight-only quantization
    replaces (:data:`_QUANTIZED`) is read as ``quantize(tensor)``: over a
    :class:`LandingParams` its model-dtype copy is gone before the next
    name lands. The bytes are :func:`quantize_weights_int8`'s (``_int4``)
    over the unquantized tree: each tensor quantizes on its own either
    way."""
    if family in _UNSUPPORTED:
        raise ValueError(
            f"family '{family}' uses {_UNSUPPORTED[family]}, which the ragged "
            "(paged) attention path does not support — serve it through "
            "deepspeed_tpu.init_inference (v1 dense engine) instead")
    if family not in ADAPTERS:
        raise ValueError(f"no ragged adapter for family '{family}' "
                         f"(have {sorted(ADAPTERS)})")
    adapter = ADAPTERS[family]
    spec = adapter.spec(config, max_context)
    if check is not None:
        check(spec)
    if quantize is not None:
        params = _QuantizingParams(params, quantize, adapter.key)
    return spec, adapter.weights(params, config)


class _ParamsView(Mapping):
    """A flat parameter tree read through ``src``, name by name."""

    src: Mapping[str, torch.Tensor]

    def __contains__(self, name) -> bool:
        return name in self.src

    def __iter__(self):
        return iter(self.src)

    def __len__(self) -> int:
        return len(self.src)


class LandingParams(_ParamsView):
    """A flat parameter tree whose tensors land on ``device`` in ``dtype``
    one at a time, as an adapter reads them (each name is read once), so
    the tree is never on the device whole before the adapter has placed
    (and :func:`adapt_model` quantized) each tensor."""

    def __init__(self, src: Mapping[str, torch.Tensor], device: torch.device,
                 dtype: torch.dtype):
        self.src, self.device, self.dtype = src, device, dtype

    def __getitem__(self, name: str):
        return self.src[name].to(device=self.device, dtype=self.dtype)


class _QuantizingParams(_ParamsView):
    """``src`` with every tensor whose serving key (``key(name)``) is in
    :data:`_QUANTIZED` read as ``quantize(tensor)``."""

    def __init__(self, src: Mapping[str, torch.Tensor], quantize: Callable,
                 key: Callable):
        self.src, self.quantize, self.key = src, quantize, key

    def __getitem__(self, name: str):
        t = self.src[name]
        return self.quantize(t) if self.key(name) in _QUANTIZED else t


def _norm(x, w: Dict, key: str, spec: RaggedModelSpec):
    """Norm ``key`` of tree ``w`` (its scale, ``1 + scale`` in the scale's
    dtype under ``norm_plus_one``, and ``key + "_bias"`` for LayerNorm),
    statistics in f32, in the model dtype."""
    scale = 1 + w[key] if spec.norm_plus_one else w[key]
    return layer_norm(x, scale, w.get(key + "_bias"), spec.norm, spec.eps, spec.dtype)


def _plain_act(name: str) -> Callable:
    """Non-gated MLP activation. Raising on unknown names (rather than a relu
    fallback) keeps a new activation from silently serving garbage."""
    try:
        return PLAIN_ACTS[name]
    except KeyError:
        raise ValueError(
            f"unknown MLP activation '{name}' for the ragged path "
            f"(gated: swiglu/geglu; plain: {sorted(PLAIN_ACTS)})") from None


def _rope(spec: RaggedModelSpec, positions: torch.Tensor):
    """(cos, sin) tables [T, rd / 2] over the rotary dims, or None without
    rotary."""
    if spec.rope_theta is None:
        return None
    return rope_tables(positions, spec.rotary_dim or spec.head_dim, spec.rope_theta)


def _rope_flat(x: torch.Tensor, rope, rotary_dim: Optional[int]) -> torch.Tensor:
    """Rotary embedding on [T, H, D] rows with per-token tables (``rope``
    from :func:`_rope`) over the first ``rotary_dim`` dims (all without
    one)."""
    cos, sin = rope
    rd = rotary_dim or x.shape[-1]
    if rd == x.shape[-1]:
        return apply_rope(x, cos, sin)
    return torch.cat([apply_rope(x[..., :rd], cos, sin), x[..., rd:]], dim=-1)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain ``[K, N]`` tensor OR a weight-only
    dict with a ``[1, N]`` f32 column scale: int8 ``{"w8" [K, N], "scale"}``
    or packed int4 ``{"w4" [K/2, N], "scale"}``. Either way the int8 matmul
    kernel (K8) sums ``x @ w8`` in f32 and scales the sum once per column,
    in x's dtype: the JAX package's ``_mm`` (:409) for both, whose int4
    branch is an f32 dot over the unpacked values. Packed int4 goes through
    ``quantized_matmul_int4``: at most 8 rows of x read the packed bytes in
    K8's ``qmm_gemv``; more rows unpack the weight
    (``ops/quantizer.unpack_int4``) for ``qmm_mma``."""
    if isinstance(w, dict):
        if "w4" in w:
            return quantized_matmul_int4(x, w["w4"], w["scale"])
        return quantized_matmul(x, w["w8"], w["scale"])
    return x @ w


# --------------------------------------------------------------------------- #
# multi-tenant LoRA: paged adapter weights -> each row's grouped delta
# (inference/v2/lora/)
# --------------------------------------------------------------------------- #

#: projections a LoRA adapter may target (attention only, as the JAX
#: package's: the S-LoRA / Punica serving pattern)
LORA_TARGETS = ("q", "k", "v", "o")


def lora_target_dims(spec: RaggedModelSpec, target: str) -> Tuple[int, int]:
    """``(d_in, d_out)`` of one LoRA-targeted base projection."""
    H, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    hid = spec.hidden_size
    dims = {"q": (hid, H * D), "k": (hid, Hkv * D), "v": (hid, Hkv * D),
            "o": (H * D, hid)}
    if target not in dims:
        raise ValueError(f"unknown LoRA target {target!r} "
                         f"(supported: {LORA_TARGETS})")
    return dims[target]


def lora_page_layout(spec: RaggedModelSpec,
                     targets: Tuple[str, ...]) -> Tuple[int, int, int]:
    """``(elements, in_max, out_max)`` of ONE adapter-weight page, as the
    JAX package's (:463): a page is one rank slice of a whole adapter, for
    every layer and targeted projection column ``j`` of its A (padded to
    ``in_max``) then row ``j`` of its B (alpha / rank folded in, padded to
    ``out_max``), flattened ``[L, nproj, in_max + out_max]``. A rank-r
    adapter owns r pages; the pool's zero page pads ranks below the
    dispatch bucket and backs unbound rows."""
    dims = [lora_target_dims(spec, t) for t in targets]
    in_max = max(d[0] for d in dims)
    out_max = max(d[1] for d in dims)
    return spec.num_layers * len(targets) * (in_max + out_max), in_max, out_max


def lora_layer_operands(spec: RaggedModelSpec, targets: Tuple[str, ...],
                        lora_pool: torch.Tensor, adapter_pt: torch.Tensor,
                        layer: int) -> torch.Tensor:
    """Layer ``layer``'s slice of each row's adapter pages, gathered on the
    device: ``lora_pool`` ``[P + 2, elements]``, ``adapter_pt`` ``[S, RB]``
    page ids (rank padding and pad rows at the zero page) -> ``[S, RB,
    nproj, in_max + out_max]``. The JAX package gathers all layers once a
    run (:483, ``[L, S, RB, ...]`` riding its layer scan); here each layer
    of each step gathers its own slice: the same bits, 1/L of the memory
    (at Llama-2-7B, four targets and RB 16, a run's whole gather holds 32
    MiB a sequence)."""
    _, in_max, out_max = lora_page_layout(spec, targets)
    pages = lora_pool.view(lora_pool.shape[0], spec.num_layers, len(targets),
                           in_max + out_max)[:, layer]
    return pages[adapter_pt.long()]


def _lora_split(spec: RaggedModelSpec, targets: Tuple[str, ...],
                lora_l: torch.Tensor) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """One layer's gathered slice ``[S, RB, nproj, io]`` -> ``{target: (A
    [S, RB, d_in], B [S, RB, d_out])}`` for :func:`_lora_mm` (views)."""
    _, in_max, _ = lora_page_layout(spec, targets)
    out = {}
    for p, t in enumerate(targets):
        din, dout = lora_target_dims(spec, t)
        out[t] = (lora_l[:, :, p, :din], lora_l[:, :, p, in_max:in_max + dout])
    return out


def _lora_mm(x: torch.Tensor, w, lora: Optional[Dict], name: str) -> torch.Tensor:
    """``_mm(x, w)`` plus each row's grouped LoRA delta ``(x @ A) @ B`` (the
    JAX package's ``_lora_mm`` :514): one batched product pair serves a
    batch that mixes tenants. ``lora[name]`` holds ``(A [S, RB, d_in], B
    [S, RB, d_out])`` for ``S`` row groups; the ``T = S * R`` rows of ``x``
    run in groups of ``R`` consecutive rows on their group's pages (a
    decode step: R = 1; a verify step: a sequence's k + 1 rows share its
    adapter). The contraction is f32 over f32 casts of the operands, added
    in ``y``'s dtype, so a row on the zero page adds an exact ``+0``."""
    y = _mm(x, w)
    if lora is None or name not in lora:
        return y
    a, b = lora[name]
    S = a.shape[0]
    xs = x.float().view(S, -1, x.shape[-1])                          # [S, R, d_in]
    c = torch.bmm(xs, a.float().transpose(1, 2))                      # [S, R, RB]
    d = torch.bmm(c, b.float())                                       # [S, R, d_out]
    return y + d.view(y.shape).to(y.dtype)


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_QUANT_MLP_KEYS = ("w_gate", "w_up", "w_down")
#: the serving keys whose tensors weight-only quantization replaces by
#: ``q(w)`` dicts as they land (:func:`adapt_model`): the layers'
#: projections and expert stacks (:data:`_QUANT_KEYS`), GPT-2's fused qkv
#: before it is cut (:func:`_columns`), an untied head
_QUANTIZED = frozenset(_QUANT_KEYS + ("wqkv", "lm_head"))


def _column_scale(wf: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-output-column scale ``absmax_K / qmax`` of ``[K, N]`` f32 (1 for
    an all-zero column), ``[1, N]``; a tensor divisor: an IEEE quotient on
    CUDA too (kv_quant.py)."""
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    return torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                       torch.ones_like(absmax))


def quantize_weight_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-column int8 of one ``[K, N]`` kernel:
    ``scale = absmax_K / 127`` (1 for an all-zero column), ``w8 =
    clip(round_half_even(w / scale), -127, 127)``; scale ``[1, N]`` f32."""
    wf = w.float()
    scale = _column_scale(wf, 127.0)
    w8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w8": w8, "scale": scale}


def quantize_weight_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-column int4 of one ``[K, N]`` kernel (K even),
    packed two per byte along K: ``scale = absmax_K / 7`` (1 for an
    all-zero column), values ``clip(round_half_even(w / scale), -7, 7)``;
    ``{"w4" [K/2, N] int8, "scale" [1, N] f32}`` (the JAX package's
    ``quantize_weights_int4`` :540)."""
    wf = w.float()
    scale = _column_scale(wf, 7.0)
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8)
    return {"w4": pack_int4(q, axis=-2), "scale": scale}


def _quantize_weight_tree(weights: Dict, q: Callable) -> Dict:
    """Every layer's projections, an MoE layer's expert stacks (one scale
    per expert and output column: ``[E, 1, N]``) and an untied ``lm_head``
    (a tied head has none: it stays the embedding) become ``q(w)`` dicts,
    in place; embeddings, norms, biases and the router stay in the model
    dtype. Each layer quantizes on its own, which gives the same bytes as
    the JAX package's stacked ``[L, K, N]`` tree (its absmax runs along
    K)."""
    for layer in weights["layers"]:
        for tree, keys in ((layer, _QUANT_KEYS), (layer.get("moe", {}), _QUANT_MLP_KEYS)):
            for key in keys:
                if key in tree and not isinstance(tree[key], dict):
                    tree[key] = q(tree[key])
    if "lm_head" in weights and not isinstance(weights["lm_head"], dict):
        weights["lm_head"] = q(weights["lm_head"])
    return weights


def quantize_weights_int8(weights: Dict) -> Dict:
    """Weight-only int8 for the serving weight tree (in place, returns it):
    :func:`quantize_weight_int8` over :func:`_quantize_weight_tree`."""
    return _quantize_weight_tree(weights, quantize_weight_int8)


def quantize_weights_int4(weights: Dict) -> Dict:
    """Weight-only packed int4 for the serving weight tree (in place,
    returns it): :func:`quantize_weight_int4` over the same tree walk, the
    head included, as the JAX package's (:540, :600-601). At rest the
    weights take K*N/2 bytes, a quarter of bf16."""
    return _quantize_weight_tree(weights, quantize_weight_int4)


def _grouped_mm(x: torch.Tensor, w, ends: torch.Tensor) -> torch.Tensor:
    """Rows ``x`` [R, K] sorted by expert (expert e's rows end at
    ``ends[e]``) times their expert's weight: int8 stacks ``{"w8" [E, K,
    N], "scale" [E, 1, N]}`` through K8's grouped entries, model-dtype
    stacks ``[E, K, N]`` through ``torch._grouped_mm`` (the JAX package's
    ``gg`` :382-393: int8 sums in f32 times the row's expert's column
    scale, in x's dtype; a plain grouped product, which the JAX package
    leaves to XLA)."""
    if isinstance(w, dict):
        return quantized_matmul_grouped(x, ends, w["w8"], w["scale"])
    return torch._grouped_mm(x, w, offs=ends)


def _moe_route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Rows ``x`` [T, hidden] to their experts: f32 router logits, the top
    k, a softmax over their k logits. Returns (gates [T, k] f32, expert ids
    [T, k])."""
    gates, ids = torch.topk(x.float() @ router.float(), top_k, dim=-1)
    return torch.softmax(gates, dim=-1), ids


def _moe_ffn(x: torch.Tensor, w: Dict, top_k: int, dtype: torch.dtype) -> torch.Tensor:
    """Sort-based token dispatch and grouped products over ragged rows ``x``
    [T, hidden], step for step the JAX package's ``_moe_ffn`` (:364-405):
    the routing (:func:`_moe_route`); the T * k (token, choice) rows stably
    sorted by expert and gathered; grouped gate/up, silu(gate) * up
    (gelu(up) for a plain gated MLP), grouped down; each row times its gate
    in the model dtype, the sort inverted and the k choices summed. Rows
    are counted per expert with ``scatter_add_`` and a cumsum, and the
    grouped entries pick their kernel from the row count, a shape: nothing
    here waits on the device."""
    T = x.shape[0]
    E = w["router"].shape[-1]
    gates, ids = _moe_route(x, w["router"], top_k)
    expert_ids = ids.reshape(-1)
    order = torch.argsort(expert_ids, stable=True)
    xs = x[order // top_k]
    counts = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
        0, expert_ids, torch.ones_like(expert_ids, dtype=torch.int32))
    ends = counts.cumsum(0, dtype=torch.int32)
    if "w_gate" in w:
        h = F.silu(_grouped_mm(xs, w["w_gate"], ends)) * _grouped_mm(xs, w["w_up"], ends)
    else:
        h = PLAIN_ACTS["gelu"](_grouped_mm(xs, w["w_up"], ends))
    ys = _grouped_mm(h, w["w_down"], ends)
    scale = gates.reshape(-1)[order].to(ys.dtype)
    out = (ys * scale[:, None])[torch.argsort(order)].reshape(T, top_k, -1).sum(1)
    return out.to(dtype)


def _transformer_layer(spec: RaggedModelSpec, w: Dict, x: torch.Tensor, rope,
                       attend: Callable, lora: Optional[Dict] = None) -> torch.Tensor:
    """One layer over ragged rows ``x`` [T, hidden], as the JAX package's
    ``_transformer_layer``: biased q/k/v/o, full or partial rotary (``rope``
    from :func:`_rope`, None without), sequential or parallel blocks, a
    gated (SwiGLU or GeGLU) or plain MLP with biases, or the routed experts
    of an MoE layer (:func:`_moe_ffn`). ``attend(q, k, v) -> [T, H, D]``
    writes the pass's K/V into the pool and attends, in the shape of its
    pass. ``lora`` (:func:`_lora_split`'s dict, or None) adds each row's
    adapter delta to the targeted projections: q/k/v before their biases
    and the rotary, o before its bias."""
    H, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    h1 = _norm(x, w, "ln1", spec)
    q, k, v = (_lora_mm(h1, w["wq"], lora, "q"), _lora_mm(h1, w["wk"], lora, "k"),
               _lora_mm(h1, w["wv"], lora, "v"))
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q, k, v = q.view(-1, H, D), k.view(-1, Hkv, D), v.view(-1, Hkv, D)
    if rope is not None:
        q = _rope_flat(q, rope, spec.rotary_dim)
        k = _rope_flat(k, rope, spec.rotary_dim)
    attn_out = _lora_mm(attend(q, k, v).reshape(-1, H * D), w["wo"], lora, "o")
    if "bo" in w:
        attn_out = attn_out + w["bo"]
    if spec.parallel_block:
        mlp_in = _norm(x, w, "ln2", spec) if spec.parallel_dual_norm else h1
    else:
        x = x + attn_out
        mlp_in = _norm(x, w, "ln2", spec)
    if spec.moe is not None:
        mlp_out = _moe_ffn(mlp_in, w["moe"], spec.moe["top_k"], spec.dtype)
    else:
        if spec.activation in ("swiglu", "geglu"):
            act = mlp_gate_act("silu" if spec.activation == "swiglu" else "gelu")
            hmid = act(_mm(mlp_in, w["w_gate"])) * _mm(mlp_in, w["w_up"])
        else:
            hmid = _mm(mlp_in, w["w_up"])
            if "b_up" in w:
                hmid = hmid + w["b_up"]
            hmid = _plain_act(spec.activation)(hmid)
        mlp_out = _mm(hmid, w["w_down"])
        if "b_down" in w:
            mlp_out = mlp_out + w["b_down"]
    return x + attn_out + mlp_out if spec.parallel_block else x + mlp_out


def _embed_in(spec: RaggedModelSpec, weights, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Token (+ learned position) embedding, then the embedding norm, then
    Gemma's sqrt(hidden) scale in f32 (the JAX package's ``_embed_in``)."""
    x = weights["embed"][tokens.long()]
    if spec.learned_pos:
        x = x + weights["pos_embed"][positions.long() + spec.pos_offset]
    if spec.embed_norm:
        x = _norm(x.to(spec.dtype), weights, "embed_norm", spec)
    if spec.embed_scale_by_sqrt_dim:
        x = x.float() * spec.hidden_size ** 0.5
    return x.to(spec.dtype)


def _unembed(spec: RaggedModelSpec, weights, xs: torch.Tensor) -> torch.Tensor:
    """Final-hidden rows -> f32 logits (tied head in f32, or untied; plus
    the head bias)."""
    if spec.tied_lm_head:
        logits = xs.float() @ weights["embed_f32"].t()
    else:
        logits = _mm(xs, weights["lm_head"]).float()
    if spec.head_bias:
        logits = logits + weights["lm_head_bias"].float()
    return logits


def _kv_write_rows(dest: torch.Tensor, Hkv: int, bs: int) -> torch.Tensor:
    """Flat rows of one layer's pool view [NB*2*Hkv*bs, D] for the tokens at
    flat destinations ``dest`` (page * bs + slot): all K rows, then all V
    rows, each [n, Hkv] row-major."""
    dest = dest.long()
    base = (dest // bs) * (2 * Hkv * bs) + dest % bs
    h = torch.arange(Hkv, device=dest.device) * bs
    return torch.cat([(base[:, None] + h).reshape(-1),
                      (base[:, None] + Hkv * bs + h).reshape(-1)])


def _kv_page_write(kv_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   src: torch.Tensor, rows: torch.Tensor) -> None:
    """Write K/V of pass rows ``src`` at pool rows ``rows``
    (:func:`_kv_write_rows`). Padding rows were dropped on the host
    (``RaggedBatch.host_arrays``), so every row here is in range."""
    D = kv_l.shape[-1]
    new = torch.cat([k[src].reshape(-1, D), v[src].reshape(-1, D)])
    kv_l.view(-1, D).index_copy_(0, rows, new.to(kv_l.dtype))


def _kv_page_write_quant(kv_l: torch.Tensor, sc_l: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, src: torch.Tensor, rows: torch.Tensor) -> None:
    """int8 variant of :func:`_kv_page_write`: the new rows quantize per
    (token, kv head) and their scales go to the layer's scale tiles
    ``sc_l`` [NB, R8, 128]."""
    _, _, Hkv, bs, D = kv_l.shape
    q8, s = kv_quantize_rows(torch.cat([k[src].reshape(-1, D), v[src].reshape(-1, D)]))
    kv_l.view(-1, D).index_copy_(0, rows, q8)
    sc_l.view(-1).index_copy_(0, scale_write_index(rows, Hkv, bs), s)


def _page_plan_windows(k: torch.Tensor, v: torch.Tensor, bs: int,
                       page_rows: torch.Tensor, page_fill: torch.Tensor):
    """The page plan's token windows as K and V ``[PW, Hkv, bs, D]``:
    entry i holds pass rows ``page_rows[i] ..`` for ``page_fill[i]``
    tokens, zeros past the fill."""
    CT = k.shape[0]
    j = torch.arange(bs, device=k.device)
    rows = (page_rows.long()[:, None] + j[None]).clamp_max(CT - 1)   # [PW, bs]
    valid = (j[None] < page_fill.long()[:, None])[..., None, None]

    def window(x):
        return torch.where(valid, x[rows], torch.zeros((), dtype=x.dtype,
                                                        device=x.device)).transpose(1, 2)

    return window(k), window(v)


def _kv_page_write_pages(kv_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         page_ids: torch.Tensor, page_rows: torch.Tensor,
                         page_fill: torch.Tensor) -> None:
    """Whole-page writes for prefill-from-zero passes: plan entry i fills
    page ``page_ids[i]`` from pass rows ``page_rows[i] ..`` for
    ``page_fill[i]`` tokens; slots past the fill are zeroed (every reader
    bounds keys by ctx, so they are never read)."""
    kw, vw = _page_plan_windows(k, v, kv_l.shape[3], page_rows, page_fill)
    kv_l.index_copy_(0, page_ids.long(), torch.stack([kw, vw], dim=1).to(kv_l.dtype))


def _kv_page_write_pages_quant(kv_l: torch.Tensor, sc_l: torch.Tensor,
                               k: torch.Tensor, v: torch.Tensor, page_ids: torch.Tensor,
                               page_rows: torch.Tensor, page_fill: torch.Tensor) -> None:
    """int8 variant of :func:`_kv_page_write_pages`: the page windows
    quantize per (token, kv head) row, and each written page's scale tile
    ``[R8, 128]`` (flat order kv*Hkv*bs + h*bs + t, zero padded) is written
    whole."""
    NB, _, Hkv, bs, D = kv_l.shape
    kw, vw = _page_plan_windows(k, v, bs, page_rows, page_fill)
    q8, s = kv_quantize_rows(torch.stack([kw, vw], dim=1))   # [PW, 2, Hkv, bs(, D)]
    ids = page_ids.long()
    kv_l.index_copy_(0, ids, q8)
    PW = ids.shape[0]
    tiles = torch.zeros((PW, scale_tile_rows(Hkv, bs) * 128), dtype=torch.float32,
                        device=s.device)
    tiles[:, :2 * Hkv * bs] = s.reshape(PW, -1)
    sc_l.index_copy_(0, ids, tiles.view(PW, -1, 128))


# keys each pass forward reads (RaggedBatch.device_arrays ships only these)
PAGED_PASS_KEYS = (
    "chunk_tokens", "chunk_positions", "chunk_ntok", "chunk_block_tables",
    "chunk_q0", "chunk_ctx_lens", "decode_tokens", "decode_positions",
    "decode_block_tables", "decode_ctx_lens", "kv_src", "kv_dest")
PREFILL_PASS_KEYS = (
    "chunk_tokens", "chunk_positions", "chunk_ntok", "row_seg", "page_ids",
    "page_rows", "page_fill")


def _last_rows(b, Cs: int) -> torch.Tensor:
    """Row of each filled slot's last token."""
    ntok = b["chunk_ntok"].long()
    return torch.arange(ntok.shape[0], device=ntok.device) * Cs + (ntok - 1).clamp_min(0)


def build_ragged_forward(spec: RaggedModelSpec, n_splits: int = 1) -> Callable:
    """Returns ``fwd(weights, kv, b, kv_scales=None) -> (chunk_logits [NC, V],
    decode_logits [S, V])`` over the filled slots and decode rows of ``b``
    (``RaggedBatch.device_arrays(device, PAGED_PASS_KEYS)``); ``chunk_logits[j]``
    are the logits after slot j's last token. ``kv`` [L, NB, 2, Hkv, bs, D]
    (int8 with its scale tiles ``kv_scales`` [L, NB, R8, 128]) is written in
    place. ``n_splits`` is the split rung the paged attention runs at."""
    H, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    ak = AttentionKernelSpec(spec, n_splits=n_splits)

    def fwd(weights, kv, b, kv_scales=None):
        bs = kv.shape[4]
        NC = b["chunk_ntok"].shape[0]
        CT = b["chunk_tokens"].shape[0]
        Cs = CT // NC if NC else 0
        S = b["decode_tokens"].shape[0]
        tokens = torch.cat([b["chunk_tokens"], b["decode_tokens"]])
        positions = torch.cat([b["chunk_positions"], b["decode_positions"]])
        x = _embed_in(spec, weights, tokens, positions)
        rope = _rope(spec, positions)
        src = b["kv_src"].long()
        rows = _kv_write_rows(b["kv_dest"], Hkv, bs)

        for l, w in enumerate(weights["layers"]):
            kv_l = kv[l]
            sc_l = None if kv_scales is None else kv_scales[l]

            def attend(q, k, v, kv_l=kv_l, sc_l=sc_l):
                if sc_l is None:
                    _kv_page_write(kv_l, k, v, src, rows)
                else:
                    _kv_page_write_quant(kv_l, sc_l, k, v, src, rows)
                outs = []
                if NC:
                    outs.append(ak.chunk(q[:CT].view(NC, Cs, H, D), kv_l,
                                         b["chunk_block_tables"], b["chunk_q0"],
                                         b["chunk_ctx_lens"],
                                         kv_scales=sc_l).reshape(CT, H, D))
                if S:
                    outs.append(ak.decode(q[CT:], kv_l, b["decode_block_tables"],
                                          b["decode_ctx_lens"], kv_scales=sc_l))
                return torch.cat(outs) if len(outs) > 1 else outs[0]

            x = _transformer_layer(spec, w, x, rope, attend)

        x = _norm(x, weights, "final_norm", spec)
        xs = torch.cat([x[_last_rows(b, Cs)], x[CT:]])
        logits = _unembed(spec, weights, xs)
        return logits[:NC], logits[NC:]

    return fwd


def build_prefill_forward(spec: RaggedModelSpec) -> Callable:
    """Prefill-from-zero fast path: every token a slot can see was computed
    IN THIS PASS, so attention is one packed segment-masked kernel over the
    pass's own Q/K/V (no paged reads), and the page write happens after
    attention. Same signature as :func:`build_ragged_forward` over
    ``PREFILL_PASS_KEYS``; decode_logits is empty (a pure-prefill pass has no
    decode rows). With an int8 pool the attention still reads the in-flight
    rows at full precision; only the page write quantizes. An ALiBi model
    has no packed pass (the packed kernel carries no position bias)."""
    if spec.alibi:
        raise ValueError("an ALiBi model prefills through the paged pass "
                         "(build_ragged_forward): the packed prefill kernel has no "
                         "position bias")
    ak = AttentionKernelSpec(spec)

    def fwd(weights, kv, b, kv_scales=None):
        NC = b["chunk_ntok"].shape[0]
        CT = b["chunk_tokens"].shape[0]
        Cs = CT // NC
        seg = b["row_seg"]
        x = _embed_in(spec, weights, b["chunk_tokens"], b["chunk_positions"])
        rope = _rope(spec, b["chunk_positions"])

        for l, w in enumerate(weights["layers"]):
            kv_l = kv[l]
            sc_l = None if kv_scales is None else kv_scales[l]

            def attend(q, k, v, kv_l=kv_l, sc_l=sc_l):
                out = ak.packed(q, k, v, seg)
                if sc_l is None:
                    _kv_page_write_pages(kv_l, k, v, b["page_ids"], b["page_rows"],
                                         b["page_fill"])
                else:
                    _kv_page_write_pages_quant(kv_l, sc_l, k, v, b["page_ids"],
                                               b["page_rows"], b["page_fill"])
                return out

            x = _transformer_layer(spec, w, x, rope, attend)

        x = _norm(x, weights, "final_norm", spec)
        logits = _unembed(spec, weights, x[_last_rows(b, Cs)])
        return logits, logits[:0]

    return fwd


def _sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                   do_sample: bool, top_k: int, temperature: float) -> torch.Tensor:
    """The one greedy / temperature / top-k sampler of the decode paths;
    returns int32 token ids [S]."""
    if not do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    z = logits / max(float(temperature), 1e-6)
    if top_k > 0:
        kth = torch.topk(z, top_k, dim=-1).values[:, -1:]
        z = torch.where(z < kth, torch.full_like(z, float("-inf")), z)
    ids = torch.multinomial(torch.softmax(z, dim=-1), 1, generator=generator)
    return ids[:, 0].to(torch.int32)


def _step_logits(spec: RaggedModelSpec, weights, kv, ids, positions, kv_scales,
                 attend_layer: Callable,
                 lora_layer: Optional[Callable[[int], Dict]] = None) -> torch.Tensor:
    """One decode step's forward over the rows ``ids`` at ``positions``:
    layer ``l`` attends through ``attend_layer(l, q, k, v, kv_l, sc_l)``
    (``kv_l``/``sc_l``: the layer's pool view and scale tiles), which also
    places the rows' K/V; with an int8 pool it gets the ``kv_write_dequant``
    rows (f32), the values the pages store. ``lora_layer(l)`` gives layer
    ``l``'s adapter slices (:func:`_lora_split`), or is None. Returns f32
    logits [S, V]."""
    x = _embed_in(spec, weights, ids, positions)
    rope = _rope(spec, positions)
    for l, w in enumerate(weights["layers"]):
        kv_l = kv[l]
        sc_l = None if kv_scales is None else kv_scales[l]

        def attend(q, k, v, l=l, kv_l=kv_l, sc_l=sc_l):
            if sc_l is not None:
                k, v = kv_write_dequant(k), kv_write_dequant(v)
            return attend_layer(l, q, k, v, kv_l, sc_l)

        x = _transformer_layer(spec, w, x, rope, attend,
                               None if lora_layer is None else lora_layer(l))
    x = _norm(x, weights, "final_norm", spec)
    return _unembed(spec, weights, x)


def _lora_layers(spec: RaggedModelSpec, lora_targets: Optional[Tuple[str, ...]],
                 lora_pool: Optional[torch.Tensor],
                 adapter_pt: Optional[torch.Tensor]) -> Optional[Callable[[int], Dict]]:
    """The per-layer adapter slices of a LoRA-built step (``lora_targets``
    set: both operands required), or None for a base step, which refuses
    LoRA operands (the JAX package's assertion, :1423)."""
    if lora_targets is None:
        if lora_pool is not None or adapter_pt is not None:
            raise ValueError("lora operands on a non-LoRA step (built with "
                             "lora_targets=None)")
        return None
    if lora_pool is None or adapter_pt is None:
        raise ValueError(f"a LoRA step (lora_targets={lora_targets}) needs both "
                         "lora_pool and adapter_pt")
    return lambda l: _lora_split(spec, lora_targets, lora_layer_operands(
        spec, lora_targets, lora_pool, adapter_pt, l))


def build_decode_step(spec: RaggedModelSpec, n_splits: int = 1,
                      window_ring_ok: bool = False,
                      lora_targets: Optional[Tuple[str, ...]] = None) -> Callable:
    """One decode step for the pipelined serving loop: consume ``ids`` [S]
    (this step's tokens), attend and write their KV, and sample the NEXT
    token row on the device.

    The step attends the current token as a side row and writes it after
    (the side-buffer schedule). Under a sliding window that schedule reads
    frozen pages while the write lands ahead, so it runs only when the
    caller has checked that the scheduler's page ring covers it
    (``window_ring_ok = scheduler.ring_covers(2)``); otherwise the step
    takes the per-step write path (write, then attend), as the JAX package
    does.

    Returns ``fwd(weights, kv, ids [S], positions [S], block_tables [S, MB],
    ctx [S], generator, do_sample, top_k, temperature, kv_scales=None) ->
    (next_ids [S] int32, logits [S, V] f32)``; ``ctx`` counts tokens
    INCLUDING the current one (>= 1 on every row). With an int8 pool the
    current token is attended at its pool value (``kv_write_dequant``, f32
    side rows) and written quantized after.

    ``lora_targets`` (a subset of :data:`LORA_TARGETS`) builds the
    multi-tenant LoRA step: ``fwd`` then needs the keyword operands
    ``lora_pool`` ``[P + 2, elements]`` and ``adapter_pt`` ``[S, RB]``
    (each row's page ids, :meth:`LoraAdapterRegistry.page_table`), and each
    row's adapter delta rides the targeted projections (:func:`_lora_mm`)
    on either schedule. None builds the base step, which takes neither."""
    ak = AttentionKernelSpec(spec, n_splits=n_splits)
    sidebuf = spec.window is None or window_ring_ok
    step = ak.decode_step if sidebuf else ak.decode_step_write

    def fwd(weights, kv, ids, positions, block_tables, ctx, generator=None,
            do_sample: bool = False, top_k: int = 0, temperature: float = 1.0,
            kv_scales=None, lora_pool=None, adapter_pt=None):
        logits = _step_logits(spec, weights, kv, ids, positions, kv_scales,
                              lambda l, q, k, v, kv_l, sc_l: step(
                                  q, k, v, kv_l, block_tables, ctx, kv_scales=sc_l),
                              _lora_layers(spec, lora_targets, lora_pool, adapter_pt))
        return _sample_logits(logits, generator, do_sample, top_k, temperature), logits

    return fwd


def build_verify_step(spec: RaggedModelSpec, k: int,
                      lora_targets: Optional[Tuple[str, ...]] = None) -> Callable:
    """Speculative decoding's verify step (the JAX package's
    ``build_verify_step`` :1352-1503): score ``k`` draft tokens a sequence
    in ONE ragged forward.

    Each sequence contributes ``K1 = k + 1`` rows: its committed current
    token (on the device, sampled by the previous step) and the draft.
    Every layer writes all K1 rows' K/V into the pool first (quantized on
    write over an int8 pool, so every row is attended at its pool value),
    then attends through ``AttentionKernelSpec.chunk`` (the chunk kernel,
    K5, at every rung): one slot a sequence, ``q_starts = positions0``,
    ``ctx = ctx0 + k``, causal by absolute position, so row j sees the
    frozen prefix plus rows 0..j. The decode step attends through another
    kernel, so on the card the two agree to rounding, not to the bit.

    The greedy accept mask runs on the device: draft token j+1 is accepted
    iff it equals ``argmax(logits[:, j])`` and every earlier one was, and
    ``n_draft`` bounds each row's proposals. No host sync: the caller
    drains ``accept_row`` through the pipeline's one policed copy. Rejected
    rows' K/V stay in the pool past the advanced context, never read (every
    reader is ctx-bounded) and overwritten by the next write there.

    Returns ``fwd(weights, kv, ids [S], draft [S, k], n_draft [S],
    positions0 [S], block_tables [S, MB], ctx0 [S], kv_scales=None) ->
    (accept_row [2, S] int32, next_ids [S] int32, final_logits [S, V])``:
    row i emits ``accept_row[0, i] + 1`` tokens (the accepted drafts, then
    ``accept_row[1, i] = next_ids[i]``, the greedy bonus token), and
    ``final_logits`` are the logits ``next_ids`` was taken from. ``ctx0``
    counts tokens INCLUDING the current one (``positions0 + 1``); the pool
    is written in place.

    ``lora_targets`` builds the LoRA verify step, as
    :func:`build_decode_step`'s: ``adapter_pt`` ``[S, RB]`` holds each
    sequence's pages, which all its k + 1 rows use (the JAX package repeats
    them to token rows, :1414-1421), so the verify step runs the decode
    step's delta row for row."""
    H, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    K1 = k + 1
    ak = AttentionKernelSpec(spec)

    def fwd(weights, kv, ids, draft, n_draft, positions0, block_tables, ctx0,
            kv_scales=None, lora_pool=None, adapter_pt=None):
        lora_layer = _lora_layers(spec, lora_targets, lora_pool, adapter_pt)
        S, bs, MB = ids.shape[0], kv.shape[4], block_tables.shape[1]
        steps = torch.arange(K1, dtype=positions0.dtype, device=ids.device)
        tokens = torch.cat([ids[:, None], draft.to(ids.dtype)], dim=1)   # [S, K1]
        positions = positions0[:, None] + steps[None]
        pos_flat = positions.reshape(-1)
        x = _embed_in(spec, weights, tokens.reshape(-1), pos_flat)
        rope = _rope(spec, pos_flat)
        # the run's reservation covers positions0 + k; the pad rows' all-
        # scratch tables are clamped inside their width as in the JAX package
        rows = token_write_rows(block_tables, positions.clamp_max(MB * bs - 1), Hkv, bs)
        ctx = ctx0 + k

        for l, w in enumerate(weights["layers"]):
            kv_l = kv[l]
            sc_l = None if kv_scales is None else kv_scales[l]

            def attend(q, k_, v, kv_l=kv_l, sc_l=sc_l):
                write_rows(kv_l, rows, k_, v, sc_l)
                return ak.chunk(q.view(S, K1, H, D), kv_l, block_tables, positions0, ctx,
                                kv_scales=sc_l).reshape(S * K1, H, D)

            x = _transformer_layer(spec, w, x, rope, attend,
                                   None if lora_layer is None else lora_layer(l))

        x = _norm(x, weights, "final_norm", spec)
        logits = _unembed(spec, weights, x).view(S, K1, -1)
        # the greedy sampler's argmax, so an accepted token is the token the
        # decode step would emit from the same logits
        pred = torch.argmax(logits, dim=-1).to(torch.int32)               # [S, K1]
        match = (pred[:, :k] == draft.to(torch.int32)) & (
            steps[None, :k] < n_draft.to(steps.dtype)[:, None])
        accept = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)  # [S]
        next_ids = pred.gather(1, accept[:, None].long())[:, 0]
        final_logits = logits.gather(
            1, accept.long()[:, None, None].expand(S, 1, logits.shape[-1]))[:, 0]
        accept_row = torch.stack([accept.to(torch.int32), next_ids])
        return accept_row, next_ids, final_logits

    return fwd


def _build_multistep_sidebuf(spec: RaggedModelSpec, n_steps: int, do_sample: bool,
                             top_k: int, n_splits: int = 1) -> Callable:
    """The side-buffer burst (the JAX package's ``_build_multistep_sidebuf``
    :1007): the pools stay frozen for the whole burst. Each layer's new K/V
    rows go into a sequence-major slab ``[L, S, C * Hkv, D]`` (row ``cc *
    Hkv + h``; ``C = n_steps``, not padded: the padding of JAX's ``Cb``
    aligns TPU sublanes); step ``j`` of layer ``l`` attends the frozen
    prefix ``[0, prefix)`` plus slab rows ``cc <= j`` through
    ``AttentionKernelSpec.sidebuf`` (the decode kernel, or K7 with its side
    piece at rungs above 1), handed the layer's slab ``side_k[l]`` as a
    view. At the burst's end one flush writes slab rows ``[0, C)`` into pool
    positions ``[prefix, prefix + C)`` through the block tables.

    With an int8 pool the slab is f32 and holds the ``kv_write_dequant``
    rows; the flush re-quantizes them to the bytes and scales a per-step
    write stores (the format is value-idempotent)."""
    Hkv, D, C = spec.num_kv_heads, spec.head_dim, n_steps
    ak = AttentionKernelSpec(spec, n_splits=n_splits)

    def fwd(weights, kv, ids0, positions0, block_tables, ctx0, generator=None,
            temperature: float = 1.0, kv_scales=None):
        L, S = kv.shape[0], ids0.shape[0]
        side_dtype = spec.dtype if kv_scales is None else torch.float32
        side_k = torch.zeros((L, S, C * Hkv, D), dtype=side_dtype, device=kv.device)
        side_v = torch.zeros_like(side_k)
        # the pages hold only the frozen prefix; the current token and every
        # later one live in the slab
        prefix = (ctx0 - 1).clamp_min(0)
        out_ids = torch.empty((C, S), dtype=torch.int32, device=ids0.device)
        ids, pos = ids0, positions0
        logits = None
        for j in range(C):
            span = slice(j * Hkv, (j + 1) * Hkv)

            def attend(l, q, k, v, kv_l, sc_l):
                side_k[l, :, span] = k
                side_v[l, :, span] = v
                return ak.sidebuf(q, kv_l, block_tables, prefix, side_k[l], side_v[l], j,
                                  kv_scales=sc_l)

            logits = _step_logits(spec, weights, kv, ids, pos, kv_scales, attend)
            out_ids[j] = ids
            ids = _sample_logits(logits, generator, do_sample, top_k, temperature)
            pos = pos + 1
        flush_side_slab(kv, side_k, side_v, block_tables, prefix, kv_scales)
        return out_ids, logits

    return fwd


def flush_side_slab(kv: torch.Tensor, side_k: torch.Tensor, side_v: torch.Tensor,
                    block_tables: torch.Tensor, prefix: torch.Tensor,
                    kv_scales: Optional[torch.Tensor] = None) -> None:
    """The side-buffer burst's flush (JAX :1142-1192): slab rows ``[0, C)``
    of every layer (``side_k``/``side_v`` ``[L, S, C * Hkv, D]``) into pool
    positions ``[prefix, prefix + C)`` of each row's sequence, through its
    block table, one ``index_copy_`` a layer; an int8 pool re-quantizes the
    f32 rows and writes their scales into the tiles ``kv_scales``."""
    L, _, _, Hkv, bs, _ = kv.shape
    C = side_k.shape[2] // Hkv
    cc = torch.arange(C, device=prefix.device)
    rows = token_write_rows(block_tables, prefix.long()[:, None] + cc, Hkv, bs)
    for l in range(L):
        write_rows(kv[l], rows, side_k[l], side_v[l],
                   None if kv_scales is None else kv_scales[l])


def _build_multistep_general(spec: RaggedModelSpec, n_steps: int, do_sample: bool,
                             top_k: int, n_splits: int = 1,
                             lora_targets: Optional[Tuple[str, ...]] = None) -> Callable:
    """The per-step-write burst (the JAX package's
    ``_build_multistep_general`` :1505): each layer of each step writes the
    current token's K/V into its page, then attends, through
    ``AttentionKernelSpec.decode_step_write`` (K4's order and its split-K
    dispatcher). ``lora_targets`` adds each row's adapter delta, as
    :func:`build_decode_step`'s (the bindings hold for the whole burst)."""
    ak = AttentionKernelSpec(spec, n_splits=n_splits)

    def fwd(weights, kv, ids0, positions0, block_tables, ctx0, generator=None,
            temperature: float = 1.0, kv_scales=None, lora_pool=None, adapter_pt=None):
        lora_layer = _lora_layers(spec, lora_targets, lora_pool, adapter_pt)
        out_ids = torch.empty((n_steps, ids0.shape[0]), dtype=torch.int32,
                              device=ids0.device)
        ids, pos, ctx = ids0, positions0, ctx0
        logits = None
        for j in range(n_steps):
            logits = _step_logits(spec, weights, kv, ids, pos, kv_scales,
                                  lambda l, q, k, v, kv_l, sc_l: ak.decode_step_write(
                                      q, k, v, kv_l, block_tables, ctx, kv_scales=sc_l),
                                  lora_layer)
            out_ids[j] = ids
            ids = _sample_logits(logits, generator, do_sample, top_k, temperature)
            pos, ctx = pos + 1, ctx + 1
        return out_ids, logits

    return fwd


def multistep_schedule(spec: RaggedModelSpec, n_steps: int, n_rows: int,
                       window_ring_ok: bool = False,
                       max_side_bytes: Optional[int] = None) -> str:
    """Which burst schedule :func:`build_multistep_decode` runs for
    ``n_rows`` rows: ``"sidebuf"``, or ``"general"`` (the per-step-write
    loop) under a window whose page ring does not cover the burst
    (``window_ring_ok = scheduler.ring_covers(n_steps + 1)``) or when the
    slab's ``2 * L * S * n_steps * Hkv * D * esize`` bytes exceed
    ``max_side_bytes`` (default ``DSTPU_SIDEBUF_MAX_MB``, 6144 MB), as in
    the JAX package (:1262-1281). The JAX package also sends ``head_dim %
    128 != 0`` to the per-step loop, for TPU lane alignment; the CUDA
    kernels need none, so the port keeps the slab at every head dim."""
    if spec.window is not None and not window_ring_ok:
        return "general"
    if max_side_bytes is None:
        max_side_bytes = int(float(os.environ.get("DSTPU_SIDEBUF_MAX_MB", "6144")) * 1e6)
    esize = torch.empty((), dtype=spec.dtype).element_size()
    side_bytes = (2 * spec.num_layers * n_rows * n_steps * spec.num_kv_heads
                  * spec.head_dim * esize)
    return "sidebuf" if side_bytes <= max_side_bytes else "general"


def build_multistep_decode(spec: RaggedModelSpec, n_steps: int, do_sample: bool = False,
                           top_k: int = 0, window_ring_ok: bool = False,
                           max_side_bytes: Optional[int] = None,
                           n_splits: int = 1,
                           lora_targets: Optional[Tuple[str, ...]] = None) -> Callable:
    """A burst of ``n_steps`` decode steps with on-device sampling between
    them (the JAX package's ``build_multistep_decode`` :1214): the
    sample -> embed -> forward -> sample loop runs on the device with no
    host round trip, on the schedule :func:`multistep_schedule` picks from
    static conditions.

    Returns ``fwd(weights, kv, ids0 [S], positions0 [S], block_tables [S,
    MB], ctx0 [S], generator, temperature, kv_scales=None) -> (out_ids
    [n_steps, S] int32, final_logits [S, V] f32)``, the pool written in
    place; ``ctx0`` counts tokens INCLUDING the first current token;
    ``out_ids[j]`` is the token *consumed* by step ``j`` (``ids0`` first),
    and ``final_logits`` predict the token after the last one generated.

    ``lora_targets`` builds the per-step-write loop only, with the LoRA
    operands as :func:`build_decode_step`'s, as in the JAX package
    (:1259-1265). The engine's ``decode_steps`` builds its bursts without
    (adapter-bound rows are refused there)."""
    general = _build_multistep_general(spec, n_steps, do_sample, top_k, n_splits,
                                       lora_targets)
    if lora_targets is not None:
        return general
    sidebuf = _build_multistep_sidebuf(spec, n_steps, do_sample, top_k, n_splits)

    def fwd(weights, kv, ids0, *rest, **kw):
        impl = sidebuf if multistep_schedule(spec, n_steps, ids0.shape[0], window_ring_ok,
                                             max_side_bytes) == "sidebuf" else general
        return impl(weights, kv, ids0, *rest, **kw)

    return fwd
