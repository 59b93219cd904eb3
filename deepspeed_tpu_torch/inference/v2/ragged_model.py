"""The ragged Llama forward of the v2 engine, in eager PyTorch.

Pass structure (see ``ragged/ragged_batch.py``): tokens = [filled prompt-chunk
slots | decode rows]. Each layer writes the pass's K/V into the paged pool
(in place), then attends through ``AttentionKernelSpec``:

  - chunk slots -> ``chunk`` (paged chunk kernel, causal by absolute position)
  - decode rows -> ``decode`` (paged decode kernel, one token per sequence)

A pass that prefills every sequence from position 0 takes
:func:`build_prefill_forward` instead: packed attention over the pass's own
rows, then whole-page writes. The pipelined decode step
(:func:`build_decode_step`) attends the current token as a side row and
writes it into its page afterwards.

A sliding window (``spec.window``, Mistral) is bound into every attention
dispatch (``AttentionKernelSpec``): the packed, chunk and decode kernels and
the split-K rungs all mask by it and skip the pages below its start, so
the scheduler's page ring may reuse those pages.

A Python loop over layers takes the place of the JAX package's ``lax.scan``,
and each layer indexes its own pool view ``kv[l]`` (and, for an int8 pool,
its scale tiles ``kv_scales[l]``), so no layer offset enters the block
tables or the write destinations.

Projections go through :func:`_mm`: a plain matrix product (``x @
kernel``, kernels ``[in, out]``), or, for a weight tree quantized by
:func:`quantize_weights_int8`, the int8 matmul kernel (K8). With an int8 KV
pool every page write quantizes its rows (``_kv_page_write_quant``,
``_kv_page_write_pages_quant``); the packed prefill still attends its
in-flight rows at full precision.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.models.llama import apply_rope, rms_norm, rope_tables
from deepspeed_tpu_torch.ops.kernels.kv_quant import (kv_quantize_rows,
                                                      kv_write_dequant,
                                                      scale_tile_rows,
                                                      scale_write_index)
from deepspeed_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul


@dataclass
class RaggedModelSpec:
    family: str
    num_layers: int
    hidden_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    rope_theta: float = 10000.0
    eps: float = 1e-5
    window: Optional[int] = None      # sliding-window span (Mistral); None = full
    alibi: bool = False               # not ported yet
    moe: Optional[Dict[str, int]] = None  # not ported yet
    dtype: torch.dtype = torch.bfloat16


def adapt_llama(params: Dict[str, torch.Tensor], config,
                max_context: Optional[int] = None) -> Tuple[RaggedModelSpec, Dict]:
    """Flax-named Llama tree (``checkpoint/convert.py``) -> (spec, weights):
    ``weights["layers"]`` is a list of per-layer dicts referencing the same
    tensors (no stacking, so no copy)."""
    moe = None
    if hasattr(config, "num_local_experts"):
        moe = {"num_experts": config.num_local_experts,
               "top_k": config.num_experts_per_tok}
    window = getattr(config, "sliding_window", None)
    if window is not None and max_context is not None and max_context <= window:
        window = None   # no position can see past the window: full attention
    spec = RaggedModelSpec(
        family="mixtral" if moe else "llama",
        num_layers=config.num_hidden_layers,
        hidden_size=config.hidden_size,
        num_heads=config.num_attention_heads,
        num_kv_heads=config.num_key_value_heads,
        head_dim=config.head_dim,
        vocab_size=config.vocab_size,
        rope_theta=config.rope_theta,
        eps=config.rms_norm_eps, moe=moe, window=window)
    layers = []
    for i in range(config.num_hidden_layers):
        p = f"layers_{i}/"
        layer = {
            "ln1": params[p + "input_layernorm/weight"],
            "ln2": params[p + "post_attention_layernorm/weight"],
            "wq": params[p + "self_attn/q_proj/kernel"],
            "wk": params[p + "self_attn/k_proj/kernel"],
            "wv": params[p + "self_attn/v_proj/kernel"],
            "wo": params[p + "self_attn/o_proj/kernel"],
        }
        if moe is None:
            layer.update(w_gate=params[p + "mlp/gate_proj/kernel"],
                         w_up=params[p + "mlp/up_proj/kernel"],
                         w_down=params[p + "mlp/down_proj/kernel"])
        layers.append(layer)
    weights = {
        "embed": params["embed_tokens/embedding"],
        "layers": layers,
        "final_norm": params["norm/weight"],
        "lm_head": params["lm_head/kernel"],
    }
    return spec, weights


def _norm(x, scale, spec: RaggedModelSpec):
    return rms_norm(x, scale, spec.eps, spec.dtype)


def _rope_flat(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on [T, H, D] rows with per-token tables [T, D/2]."""
    return apply_rope(x, cos, sin)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain ``[K, N]`` tensor OR a weight-only
    int8 dict ``{"w8" [K, N] int8, "scale" [1, N] f32}``: the int8 matmul
    kernel (K8) sums ``x @ w8`` in f32 and scales the sum once per column,
    in x's dtype."""
    if isinstance(w, dict):
        return quantized_matmul(x, w["w8"], w["scale"])
    return x @ w


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_weight_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-column int8 of one ``[K, N]`` kernel:
    ``scale = absmax_K / 127`` (1 for an all-zero column), ``w8 =
    clip(round_half_even(w / scale), -127, 127)``; scale ``[1, N]`` f32."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    # a tensor divisor: an IEEE quotient on CUDA too (kv_quant.py)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    w8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w8": w8, "scale": scale}


def quantize_weights_int8(weights: Dict) -> Dict:
    """Weight-only int8 for the serving weight tree (in place, returns it):
    every layer's projections and the untied ``lm_head`` become
    :func:`quantize_weight_int8` dicts; embeddings and norms stay in the
    model dtype. Each layer quantizes on its own, which gives the same
    bytes as the JAX package's stacked ``[L, K, N]`` tree (its absmax runs
    along K)."""
    for layer in weights["layers"]:
        for key in _QUANT_KEYS:
            if key in layer and not isinstance(layer[key], dict):
                layer[key] = quantize_weight_int8(layer[key])
    if not isinstance(weights["lm_head"], dict):
        weights["lm_head"] = quantize_weight_int8(weights["lm_head"])
    return weights


def _transformer_layer(spec: RaggedModelSpec, w: Dict, x: torch.Tensor, cos, sin,
                       attend: Callable) -> torch.Tensor:
    """One pre-norm Llama layer over ragged rows ``x`` [T, hidden].
    ``attend(q, k, v) -> [T, H, D]`` writes the pass's K/V into the pool and
    attends, in the shape of its pass."""
    H, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    h1 = _norm(x, w["ln1"], spec)
    q = _rope_flat(_mm(h1, w["wq"]).view(-1, H, D), cos, sin)
    k = _rope_flat(_mm(h1, w["wk"]).view(-1, Hkv, D), cos, sin)
    v = _mm(h1, w["wv"]).view(-1, Hkv, D)
    x = x + _mm(attend(q, k, v).reshape(-1, H * D), w["wo"])
    m = _norm(x, w["ln2"], spec)
    return x + _mm(F.silu(_mm(m, w["w_gate"])) * _mm(m, w["w_up"]), w["w_down"])


def _embed_in(spec: RaggedModelSpec, weights, tokens: torch.Tensor) -> torch.Tensor:
    return weights["embed"][tokens.long()].to(spec.dtype)


def _unembed(spec: RaggedModelSpec, weights, xs: torch.Tensor) -> torch.Tensor:
    """Final-hidden rows -> f32 logits."""
    return _mm(xs, weights["lm_head"]).float()


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
        x = _embed_in(spec, weights, tokens)
        cos, sin = rope_tables(positions, D, spec.rope_theta)
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

            x = _transformer_layer(spec, w, x, cos, sin, attend)

        x = _norm(x, weights["final_norm"], spec)
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
    rows at full precision; only the page write quantizes."""
    ak = AttentionKernelSpec(spec)

    def fwd(weights, kv, b, kv_scales=None):
        NC = b["chunk_ntok"].shape[0]
        CT = b["chunk_tokens"].shape[0]
        Cs = CT // NC
        seg = b["row_seg"]
        x = _embed_in(spec, weights, b["chunk_tokens"])
        cos, sin = rope_tables(b["chunk_positions"], spec.head_dim, spec.rope_theta)

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

            x = _transformer_layer(spec, w, x, cos, sin, attend)

        x = _norm(x, weights["final_norm"], spec)
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


def build_decode_step(spec: RaggedModelSpec, n_splits: int = 1,
                      window_ring_ok: bool = False) -> Callable:
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
    side rows) and written quantized after."""
    ak = AttentionKernelSpec(spec, n_splits=n_splits)
    sidebuf = spec.window is None or window_ring_ok
    step = ak.decode_step if sidebuf else ak.decode_step_write

    def fwd(weights, kv, ids, positions, block_tables, ctx, generator=None,
            do_sample: bool = False, top_k: int = 0, temperature: float = 1.0,
            kv_scales=None):
        x = _embed_in(spec, weights, ids)
        cos, sin = rope_tables(positions, spec.head_dim, spec.rope_theta)
        for l, w in enumerate(weights["layers"]):
            kv_l = kv[l]
            sc_l = None if kv_scales is None else kv_scales[l]

            def attend(q, k, v, kv_l=kv_l, sc_l=sc_l):
                if sc_l is not None:
                    k, v = kv_write_dequant(k), kv_write_dequant(v)
                return step(q, k, v, kv_l, block_tables, ctx, kv_scales=sc_l)

            x = _transformer_layer(spec, w, x, cos, sin, attend)
        x = _norm(x, weights["final_norm"], spec)
        logits = _unembed(spec, weights, x)
        return _sample_logits(logits, generator, do_sample, top_k, temperature), logits

    return fwd
