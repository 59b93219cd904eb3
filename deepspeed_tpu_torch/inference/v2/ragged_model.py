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

A Python loop over layers takes the place of the JAX package's ``lax.scan``,
and each layer indexes its own pool view ``kv[l]``, so no layer offset enters
the block tables or the write destinations. Projections are plain matrix
products (``x @ kernel``, kernels ``[in, out]``); only attention runs in the
port's kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference.v2.attention import AttentionKernelSpec
from deepspeed_tpu_torch.models.llama import apply_rope, rms_norm, rope_tables


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
    window: Optional[int] = None      # sliding-window span; not ported yet
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


def _transformer_layer(spec: RaggedModelSpec, w: Dict, x: torch.Tensor, cos, sin,
                       attend: Callable) -> torch.Tensor:
    """One pre-norm Llama layer over ragged rows ``x`` [T, hidden].
    ``attend(q, k, v) -> [T, H, D]`` writes the pass's K/V into the pool and
    attends, in the shape of its pass."""
    H, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    h1 = _norm(x, w["ln1"], spec)
    q = _rope_flat((h1 @ w["wq"]).view(-1, H, D), cos, sin)
    k = _rope_flat((h1 @ w["wk"]).view(-1, Hkv, D), cos, sin)
    v = (h1 @ w["wv"]).view(-1, Hkv, D)
    x = x + attend(q, k, v).reshape(-1, H * D) @ w["wo"]
    m = _norm(x, w["ln2"], spec)
    return x + (F.silu(m @ w["w_gate"]) * (m @ w["w_up"])) @ w["w_down"]


def _embed_in(spec: RaggedModelSpec, weights, tokens: torch.Tensor) -> torch.Tensor:
    return weights["embed"][tokens.long()].to(spec.dtype)


def _unembed(spec: RaggedModelSpec, weights, xs: torch.Tensor) -> torch.Tensor:
    """Final-hidden rows -> f32 logits."""
    return (xs @ weights["lm_head"]).float()


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


def _kv_page_write_pages(kv_l: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         page_ids: torch.Tensor, page_rows: torch.Tensor,
                         page_fill: torch.Tensor) -> None:
    """Whole-page writes for prefill-from-zero passes: plan entry i fills
    page ``page_ids[i]`` from pass rows ``page_rows[i] ..`` for
    ``page_fill[i]`` tokens; slots past the fill are zeroed (every reader
    bounds keys by ctx, so they are never read)."""
    bs = kv_l.shape[3]
    CT = k.shape[0]
    j = torch.arange(bs, device=k.device)
    rows = (page_rows.long()[:, None] + j[None]).clamp_max(CT - 1)   # [PW, bs]
    valid = (j[None] < page_fill.long()[:, None])[..., None, None]

    def window(x):                                   # -> [PW, Hkv, bs, D]
        return torch.where(valid, x[rows], torch.zeros((), dtype=x.dtype,
                                                        device=x.device)).transpose(1, 2)

    new = torch.stack([window(k), window(v)], dim=1)
    kv_l.index_copy_(0, page_ids.long(), new.to(kv_l.dtype))


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


def build_ragged_forward(spec: RaggedModelSpec) -> Callable:
    """Returns ``fwd(weights, kv, b) -> (chunk_logits [NC, V], decode_logits
    [S, V])`` over the filled slots and decode rows of ``b``
    (``RaggedBatch.device_arrays(device, PAGED_PASS_KEYS)``); ``chunk_logits[j]``
    are the logits after slot j's last token. ``kv`` [L, NB, 2, Hkv, bs, D] is
    written in place."""
    H, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    ak = AttentionKernelSpec(spec)

    def fwd(weights, kv, b):
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

            def attend(q, k, v, kv_l=kv_l):
                _kv_page_write(kv_l, k, v, src, rows)
                outs = []
                if NC:
                    outs.append(ak.chunk(q[:CT].view(NC, Cs, H, D), kv_l,
                                         b["chunk_block_tables"], b["chunk_q0"],
                                         b["chunk_ctx_lens"]).reshape(CT, H, D))
                if S:
                    outs.append(ak.decode(q[CT:], kv_l, b["decode_block_tables"],
                                          b["decode_ctx_lens"]))
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
    decode rows)."""
    ak = AttentionKernelSpec(spec)

    def fwd(weights, kv, b):
        NC = b["chunk_ntok"].shape[0]
        CT = b["chunk_tokens"].shape[0]
        Cs = CT // NC
        seg = b["row_seg"]
        x = _embed_in(spec, weights, b["chunk_tokens"])
        cos, sin = rope_tables(b["chunk_positions"], spec.head_dim, spec.rope_theta)

        for l, w in enumerate(weights["layers"]):
            kv_l = kv[l]

            def attend(q, k, v, kv_l=kv_l):
                out = ak.packed(q, k, v, seg)
                _kv_page_write_pages(kv_l, k, v, b["page_ids"], b["page_rows"],
                                     b["page_fill"])
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


def build_decode_step(spec: RaggedModelSpec) -> Callable:
    """One decode step for the pipelined serving loop: consume ``ids`` [S]
    (this step's tokens), attend and write their KV, and sample the NEXT
    token row on the device.

    Returns ``fwd(weights, kv, ids [S], positions [S], block_tables [S, MB],
    ctx [S], generator, do_sample, top_k, temperature) -> (next_ids [S]
    int32, logits [S, V] f32)``; ``ctx`` counts tokens INCLUDING the current
    one (>= 1 on every row)."""
    ak = AttentionKernelSpec(spec)

    def fwd(weights, kv, ids, positions, block_tables, ctx, generator=None,
            do_sample: bool = False, top_k: int = 0, temperature: float = 1.0):
        x = _embed_in(spec, weights, ids)
        cos, sin = rope_tables(positions, spec.head_dim, spec.rope_theta)
        for l, w in enumerate(weights["layers"]):
            kv_l = kv[l]

            def attend(q, k, v, kv_l=kv_l):
                return ak.decode_step(q, k, v, kv_l, block_tables, ctx)

            x = _transformer_layer(spec, w, x, cos, sin, attend)
        x = _norm(x, weights["final_norm"], spec)
        logits = _unembed(spec, weights, x)
        return _sample_logits(logits, generator, do_sample, top_k, temperature), logits

    return fwd
