#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

Phases, each fatal on failure:

1. the device: ``nvidia-smi`` name and power limit; no CUDA, no run;
2. build the CUDA kernels from ``deepspeed_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, in bf16, at
   the shapes Llama-2-7B serving gives it, with its time, its plain
   version's time, one PyTorch library call's time where one computes the
   same function, and the least time the card could take (bound);
4. the serving slice at Llama-2-7B width (random bf16 weights from a seed):
   ``generate()`` on four prompts (one longer than the 736-token chunk
   budget) and a ``put()`` round mixing a new prompt with one-token decode
   rows, with every kernel's launch count; then the engine's next-token
   logits at prefill and at decode steps held against the dense forward
   (fp32 yardstick; the engine's bf16 error must be within 2x the dense bf16
   forward's own), and the prefill and decode token rates;
5. the training slice at GPT-2 small's full width (124M, T = 1024, random
   bf16 weights from a seed): ``initialize`` -> ``train_steps(10)`` on one
   fixed batch of 16 x 1024 token ids (micro-batch 8, AdamW, WarmupLR,
   clipping), with the flash attention kernels' launch counts (24 of each
   per step), the loss stream (finite, falling), step time and tokens/s, a
   device profile of one step, and the first-step check: the engine's first
   micro-batch loss and gradient (bf16, K1) against an fp32 forward/backward
   with plain attention, within 2x the error of a bf16 one plus a floor.

6. memory-lean long-context serving of Llama-2-13B at full width and depth
   (40 layers; random bf16 weights from seed 0, which the engine quantizes
   to int8 at build before the caller's bf16 tree is dropped) with
   ``quantization.weight_bits = 8``, int8 KV pages and the split ladder up
   to 8: ``generate()`` on prompts of 4200/2000/900/200 tokens (32 new
   tokens each), a decode step at each pinned rung 1/2/4/8 on one live set,
   and a ``put()`` round mixing a new prompt with decode rows; every new
   kernel's launch count (each > 0) and the rung counts; next-token logits
   at prefill and five decode steps against a dense fp32 forward over the
   engine's own int8 weights and pool values, streamed layer by layer (RMS
   error within 2x the same forward's in bf16); rung invariance (rungs 2/4/8
   against rung 1, same limit); quantize-on-write (a decode step and a
   ragged pass store the same layer-0 page bytes for the same token);
   prefill and decode rates, device profiles, peak memory, its own seconds.

Phase 3 also holds the flash attention kernels (K1 forward, dq, dk/dv;
tensor cores) against their plain versions at the training shape, at a
ragged T = 1000, non-causal, GQA 12/4 at D = 128, D = 16 and 32, and Tq !=
Tk both ways (top-left causal and full), each backward run twice and
required bitwise equal; prints the ``k1-kernels`` line (registers, spill
bytes and shared memory per kernel and head dim, achieved TFLOP/s at the
training shape) and fails on a spill; and the memory-lean serving kernels
at Llama-2-13B's shapes: K8 (int8 weight matmul) at M = 4 through every
projection and the LM head and at M = 736 through gate/up, the int8 decode
and chunk kernels, K7 split-K decode at 2, 4 and 8 splits (contexts up to
4264 tokens, one short enough to leave splits empty) and its merge kernel.

7. block-sparse attention (K9) at BERT-large's attention geometry (16
   heads, D = 64), B = 2, S = 4096, bf16, through the op's entry point
   ``sparse_self_attention`` forward and ``.backward``, under three layouts
   (A: DeepSpeed's documented fixed config, per head with 4 global
   patterns; B: fixed unidirectional, causal; C: BigBird defaults) and two
   ragged shapes at D = 128 (S = 1040 in blocks of 16, S = 1056 in blocks
   of 32); each kernel (forward, dq, dk/dv) against its plain version, one
   launch of each per op call, the op against its plain route, the op's
   and kernels' times with SDPA over the boolean token mask as yardstick.

8. Evoformer pair-bias attention (K10) at AlphaFold 2's fine-tuning
   Evoformer widths (crop 384 residues, 512 MSA clusters, B = 1; MSA row
   attention 8 heads x 32, triangle attention 4 heads x 32), bf16, through
   ``DS4Sci_EvoformerAttention`` (MSA row attention with ``fused=True``,
   the -1e9 mask bias and the pair bias; and ``fused=None`` with the pair
   bias alone) and both triangle attentions, forward and ``.backward``;
   each kernel (forward, dq, dk/dv, d(pair)) against its plain version at
   the MSA row shape and at a ragged S = 300 (R = 4, D = 16 and 64, f32
   pair bias), one launch of each per op call, the op's output and four
   gradients against its plain route, ``msa_col_attention`` once (plain
   torch, no kernel), and the op's and kernels' times with SDPA over the
   float bias as yardstick.

9. sliding-window serving of Mistral-7B at full width and depth (32
   layers, 32 query heads over 8 KV heads, window 4096; random bf16 weights
   from seed 0): the engine with pages of 128, a chunk budget of 8192 (take
   cap 4224, page ring 66 pages), max_context 16384, 160 pages and the
   split ladder up to 4; ``generate()`` on prompts of 12000/5000/2000/300
   tokens (32 new tokens each; the 12000-token one wraps the ring), a
   decode step at each pinned rung 1/2/4 and a ``put()`` mixing a 180-token
   prompt with decode rows (at rung 1); ``spec.window == 4096``, launches
   of the windowed K2, K5, decode kernel, K7 and the merge; next-token
   logits at prefill and four decode steps against a dense fp32 forward
   with the window, streamed over layers and query blocks (RMS within 2x
   the same forward's in bf16); rung invariance; the 12032-token sequence
   holding exactly 66 physical pages; rates, profiles, peak memory.

Phase 3 also holds the window branch of K2, K5, the decode kernel and K7
(2 and 4 splits) against their plain versions at Mistral-7B's shapes
(windows 4096 and 200, ring tables), and checks that pages wholly below
every row's window start are never read (filled with NaN, the outputs stay
bitwise equal).

10. ALiBi serving of BLOOM-560M at full width and depth (24 layers, 1024
   wide, 16 heads, D = 64, FFN 4096, vocab 250880, tied head, embedding
   LayerNorm; random bf16 weights from seed 0): pages of 128, max_context
   2048, 72 pages, the default chunk budget (736), the split ladder up to 4
   (``min_ctx_per_split`` 512); ``generate()`` on prompts of
   1900/1000/400/60 tokens (32 new tokens each), a decode step at each
   pinned rung 1/2/4 and a ``put()`` mixing a 180-token prompt with decode
   rows (at rung 1); launches of the ALiBi K5, decode kernel, K7 at 2 and 4
   splits and the merge, and none of the packed prefill kernel (an ALiBi
   model prefills through the paged pass); next-token logits at prefill
   and four decode steps against the port's dense ``DecoderLM`` forward in
   fp32 with ``alibi_bias`` (RMS within 2x the same forward's in bf16);
   rung invariance; rates, profiles, peak memory.

Phase 3 also holds the ALiBi branch of K5, the decode kernel (pages only
and one side row) and K7 (2 and 4 splits, with the merge and its lse)
against their plain versions at BLOOM-560M's shapes (ctx
1932/1032/432/92), plus one launch of the decode kernel and K5 at 112
heads, D = 128 (the slopes' interpolation branch).

11. memory-lean serving of Mistral-7B at full width and depth: phase 9's
   engine with ``quantization.weight_bits = 4`` (the engine packs the
   random bf16 weights of seed 0 to int4, two values a byte) and
   ``kv_quant`` (int8 pages under the window, through the page ring);
   ``generate()`` on prompts of 12000/5000/2000/300 tokens, a step at each
   pinned rung 1/2/4, a mixed ``put()`` at rung 1 and 16-step bursts at
   rungs 4 and 1; launches of the int8 window branch of K5, the decode
   kernel (C = 1 and 16) and K7 (2 and 4 splits, the side piece at 4), and
   of K8 on the unpacked int4 weights; next-token logits at prefill and
   four decode steps against the dense fp32 forward with the window over
   the engine's own int4 weights and int8 pool values (RMS within 2x the
   same forward's in bf16); rung invariance; the 12032-token sequence on
   exactly 66 physical pages; rates, a device profile, peak memory.

12. int8-KV serving of BLOOM-7b1 at full width and depth
   (``DecoderConfig.bloom_560m`` at hidden 4096, FFN 16384, 30 layers, 32
   heads, so D = 128; random bf16 weights of seed 0) with ``kv_quant``:
   pages of 128, max_context 2048, the ladder to 4; prompts
   1900/1000/400/60, a step per pinned rung, a mixed ``put()`` and
   16-step bursts at rungs 1 and 2; launches of the int8 ALiBi branch of
   K5, the decode kernel and K7, none of K2; logits against the port's
   dense ``DecoderLM`` in fp32 with ``alibi_bias`` over the pool's values
   (RMS within 2x the same forward's in bf16); rung invariance; rates,
   a device profile, peak memory.

Phase 3 also holds the int8 pool's window branch of the decode kernel
(pages only, one side row, C = 16 at j = 0/7/15), K5 and K7 (2 and 4
splits, the side piece at 4) at Mistral-7B's shapes (windows 4096, 8 and
200) and checks that the scale tiles of pages wholly below every row's
window start are never read (filled with NaN, the outputs stay bitwise
equal); the same kernels' ALiBi branch at BLOOM-7b1's shapes (the side
piece at 2 splits); and ``_mm`` over packed int4 weights (the unpack and
K8, each timed) at Mistral-7B's gate/up projection.

Burst decode (``decode_steps``) and the page fabric. Phase 3's
``check_side_kernels`` holds the decode kernel (K6) and K7's side piece
(2/4/8 splits) over a side slab of C = 16 rows against their plain
versions at steps j = 0, 7 and 15: Llama-2-7B (bf16), Llama-2-13B (int8
pages, f32 slab), Mistral-7B's heads through ring tables (windows of 8,
so that j >= window, and 4096) and BLOOM-560M (ALiBi, D = 64). Phase 4
then runs greedy 16-step bursts over four live sequences at rung 1 and
pinned rungs 2 and 4 (one sequence crosses a page inside the burst), a
burst built with ``max_side_bytes=0`` (the per-step-write loop), a
sampled burst (top_k 50), ``sample_next`` against a ``put()`` of the same
tokens, the bursts' final logits against the dense fp32 forward (RMS
within 2x the dense bf16 forward's), a ``fetch=False`` burst under
``torch.cuda.set_sync_debug_mode("error")``, and an ``export_kv`` ->
``import_kv`` handoff whose pages come back byte for byte and whose
greedy burst equals the original's. Two greedy streams must be equal, or
first differ where the dense fp32 forward's top-2 logit gap is below
twice the dense bf16 forward's largest logit error. Phase 6 runs a burst
at each pinned rung 1/2/4/8 and hands off a sequence's packed int8 pages;
phase 9 bursts at rungs 4 and 1 (the side-buffer schedule:
``ring_covers(17)``; no sequence holds more than the ring); phase 10 at
rungs 1 and 2. Each burst prints its wall and device ms per step beside
the phase's pipeline step, with the card's name and power limit.

The last two lines are the kernel table (53 rows) and ``{"ok": true,
"device": ...}`` as JSON. Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
# Kernel against plain version: |out - ref| <= RTOL * max|ref| over the same
# (row, head) + ATOL, elementwise. Attention over n random keys gives
# outputs of about sqrt(e/n) (0.04 at 2048 keys), so the bound follows each
# row's own scale: RTOL is 2 to 4 bf16 ulps of the row's largest value; ATOL only
# admits rounding on rows that are exactly zero in the reference.
KERNEL_RTOL = 2.0 ** -6
KERNEL_ATOL = 1e-5
# first training step against the fp32 yardstick: the engine's error may be
# 2x a bf16 plain-attention pass's own error plus this share of the
# yardstick's scale (|loss|, or the RMS of the gradient): 2^-10, an eighth
# of bf16's relative spacing (2^-7), so that a bf16 reference that happens
# to land very close does not fail an engine that is as exact as bf16 allows
FIRST_STEP_FLOOR = 2.0 ** -10


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def err(*pairs):
    """Over (out, ref) pairs: max abs error, its worst share of the (row,
    head) scale (the last dim is a row), and its ratio to the typical |ref|;
    not ok where the elementwise bound ``RTOL * rowmax + ATOL`` is broken."""
    out = {"max_abs_err": 0.0, "max_err_over_rowmax": 0.0,
           "max_err_over_mean_abs_ref": 0.0, "mean_abs_ref": None, "ok": True}
    for o, ref in pairs:
        ref = ref.float()
        d = (o.float() - ref).abs()
        rowmax = ref.abs().amax(-1, keepdim=True)
        typ = float(ref.abs().mean())
        out["ok"] &= bool((d <= KERNEL_RTOL * rowmax + KERNEL_ATOL).all())
        out["max_abs_err"] = max(out["max_abs_err"], float(d.max()))
        out["max_err_over_rowmax"] = max(out["max_err_over_rowmax"],
                                         float((d / (rowmax + KERNEL_ATOL)).max()))
        out["max_err_over_mean_abs_ref"] = max(out["max_err_over_mean_abs_ref"],
                                               float(d.max()) / max(typ, 1e-30))
        if out["mean_abs_ref"] is None:
            out["mean_abs_ref"] = typ
    return out


def record_check(rows, name, case, e, row=False, **extra):
    """Print one check and fail on a broken bound; ``row`` makes its timings
    the kernel-table row (the main path's shape)."""
    line = {"kernel": name, "case": case, **e,
            "rtol": KERNEL_RTOL, "atol": KERNEL_ATOL, **extra}
    print("kernel-check " + json.dumps(line), flush=True)
    if not e["ok"]:
        raise AssertionError(
            f"{name} {case}: error {e['max_abs_err']} breaks "
            f"{KERNEL_RTOL} x rowmax + {KERNEL_ATOL}")
    r = rows.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], e["max_abs_err"])
    if row:
        r.update(extra, case=case)


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #

def check_kernels(dev):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import (
        flash_attention_packed, flash_attention_packed_plain,
        paged_chunk_attention_batched, paged_chunk_attention_batched_plain,
        paged_decode_attention, paged_decode_attention_plain)
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    rows = {}
    record = functools.partial(record_check, rows)

    # ---- K2: packed prefill, R = 768 rows, H = Hkv = 32, D = 128 ---- #
    R, H, D = 768, 32, 128
    seg_lens = [300, 200, 150, 100]
    seg = torch.full((R,), -1, dtype=torch.int32, device=dev)
    o = 0
    for i, n in enumerate(seg_lens):
        seg[o:o + n] = i
        o += n
    q, k, v = randn(R, H, D), randn(R, H, D), randn(R, H, D)
    out = flash_attention_packed(q, k, v, seg)
    ref = flash_attention_packed_plain(q, k, v, seg)
    torch.cuda.synchronize()
    pairs = sum(n * (n + 1) // 2 for n in seg_lens + [R - sum(seg_lens)])
    mask = (torch.arange(R, device=dev)[:, None] >= torch.arange(R, device=dev)[None]) \
        & (seg[:, None] == seg[None])
    qt, kt, vt = (x.transpose(0, 1)[None] for x in (q, k, v))
    b_ms, b_by = bound(4 * R * H * D * 2 + R * 4, 4 * D * H * pairs)
    record("flash_packed", f"R={R} H={H} D={D} segs={seg_lens}+pad", err((out, ref)),
           row=True, ms=time_ms(lambda: flash_attention_packed(q, k, v, seg)),
           plain_ms=time_ms(lambda: flash_attention_packed_plain(q, k, v, seg), 5, 1),
           library_ms=time_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, attn_mask=mask)),
           bound_ms=b_ms, bound_by=b_by)
    # GQA 32/8 at the same rows
    k8, v8 = randn(R, 8, D), randn(R, 8, D)
    record("flash_packed", "GQA H=32 Hkv=8", err((
        flash_attention_packed(q, k8, v8, seg),
        flash_attention_packed_plain(q, k8, v8, seg))))

    # ---- paged pool shared by K5 and the decode kernel ---- #
    def make_pool(NB, Hkv, bs, D):
        return randn(NB, 2, Hkv, bs, D)

    tables = functools.partial(block_tables, dev=dev)

    # ---- K5: 6 slots x 128 rows, bs = 128, ctx up to 2048, one empty ---- #
    bs, Hkv, MB = 128, 32, 16
    ctxs = [2048, 1536, 1000, 300, 128, 0]
    NB = sum(-(-c // bs) for c in ctxs) + 4
    pool = make_pool(NB, Hkv, bs, D)
    Cs = 128
    bt = tables(ctxs, bs, MB, NB)
    ctx_t = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    q0 = torch.clamp(ctx_t - Cs, min=0)
    qc = randn(len(ctxs), Cs, H, D)
    out = paged_chunk_attention_batched(qc, pool, bt, q0, ctx_t)
    ref = paged_chunk_attention_batched_plain(qc, pool, bt, q0, ctx_t)
    torch.cuda.synchronize()
    if float(out[-1].float().abs().max()) != 0.0:
        raise AssertionError("paged_chunk: empty slot is not zero")
    vis = sum(min(c, q + r + 1) for c, q in zip(ctxs, q0.tolist())
              for r in range(Cs) if c > 0)
    nbytes = 2 * qc.numel() * 2 + sum(ctxs) * Hkv * D * 2 * 2
    b_ms, b_by = bound(nbytes, 4 * D * H * vis)
    record("paged_chunk", f"6x{Cs} rows ctx={ctxs} bs={bs}", err((out, ref)),
           row=True, ms=time_ms(lambda: paged_chunk_attention_batched(qc, pool, bt, q0, ctx_t)),
           plain_ms=time_ms(lambda: paged_chunk_attention_batched_plain(
               qc, pool, bt, q0, ctx_t), 5, 1),
           library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # ---- decode kernel: S in {4, 32}, ctx up to 2048, three modes ---- #
    def decode_case(S, Hq, Hkv, D, C, j, timed=False, row=False):
        rng = np.random.RandomState(S * 131 + Hkv + D + C)
        ctxs = [int(x) for x in rng.randint(1, 2049, size=S)]
        ctxs[0] = 2048
        ctxs[1] = 0
        NB = sum(-(-c // bs) for c in ctxs) + 2
        pool = make_pool(NB, Hkv, bs, D)
        bt = tables(ctxs, bs, MB, NB)
        qd = randn(S, Hq, D)
        lens = torch.tensor(ctxs, dtype=torch.int32, device=dev)
        side = ()
        if C:
            lens = torch.clamp(lens - 1, min=0)
            side = (randn(S, C * Hkv, D), randn(S, C * Hkv, D))
        kw = {"j": j} if C else {}
        out = paged_decode_attention(qd, pool, bt, lens, *side, **kw)
        ref = paged_decode_attention_plain(qd, pool, bt, lens, *side, **kw)
        torch.cuda.synchronize()
        case = f"S={S} H={Hq} Hkv={Hkv} D={D} C={C} j={j}"
        extra = {}
        if timed:
            toks = int(lens.sum()) + (S * (j + 1) if C else 0)
            nbytes = toks * Hkv * D * 2 * 2 + 2 * qd.numel() * 2
            b_ms, b_by = bound(nbytes, 4 * D * Hq * toks)
            extra = dict(
                ms=time_ms(lambda: paged_decode_attention(qd, pool, bt, lens, *side, **kw)),
                plain_ms=time_ms(lambda: paged_decode_attention_plain(
                    qd, pool, bt, lens, *side, **kw), 5, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)
        record("paged_decode", case, err((out, ref)), row=row, **extra)

    for S in (4, 32):
        decode_case(S, 32, 32, 128, 0, 0)
        decode_case(S, 32, 32, 128, 1, 0)
        decode_case(S, 32, 32, 128, 4, 2)
    decode_case(32, 32, 32, 64, 1, 0, timed=True)   # K3s's small-D path in JAX
    decode_case(32, 32, 8, 128, 1, 0)
    decode_case(32, 32, 8, 128, 0, 0)
    # timed at the pipelined decode step's shape (one side row); the kernel
    # table keeps S = 4, the main path's decode batch, and S = 32 is printed
    decode_case(4, 32, 32, 128, 1, 0, timed=True, row=True)
    decode_case(32, 32, 32, 128, 1, 0, timed=True)
    check_flash(randn, record)
    check_quant_kernels(dev, g, randn, record)
    check_window_kernels(dev, randn, record)
    check_alibi_kernels(dev, randn, record)
    check_side_kernels(dev, randn, record)
    check_quant_window_kernels(dev, g, randn, record)
    check_quant_alibi_kernels(dev, g, randn, record)
    check_int4_matmul(dev, g, randn, record)
    return rows


def block_tables(ctxs, bs, MB, NB, dev):
    """Block tables [len(ctxs), MB] int32 on ``dev``: each row's pages drawn
    from one seeded permutation of the NB pages, no page shared."""
    import torch
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(7))
    bt = torch.zeros((len(ctxs), MB), dtype=torch.int32)
    used = 0
    for i, c in enumerate(ctxs):
        n = -(-c // bs)
        bt[i, :n] = perm[used:used + n].to(torch.int32)
        used += n
    return bt.to(dev)


def check_flash_refusals(randn):
    """On CUDA tensors K1 launches or raises: a non-bf16 or non-contiguous
    input raises before any launch, and a launch the C side refuses (here
    an unsupported head dim sent past the wrapper) raises too; none of them
    counts a launch."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, _loader, flash_attention_fwd
    q = randn(1, 64, 2, 64)
    before = dict(LAUNCHES)
    cases = {
        "float32 input": (TypeError, lambda: flash_attention_fwd(
            q.float(), q.float(), q.float(), True, 0.125)),
        "non-contiguous input": (ValueError, lambda: flash_attention_fwd(
            q.transpose(1, 2).contiguous().transpose(1, 2), q, q, True, 0.125)),
        "refused launch": (RuntimeError, lambda: _loader.launch(
            "flash_fwd", "dstorch_flash_fwd_bf16", q.device, _loader.ptr(q), _loader.ptr(q),
            _loader.ptr(q), _loader.ptr(q), _loader.ptr(q), 1, 64, 64, 2, 48, 0.125, 1)),
    }
    for what, (exc, fn) in cases.items():
        try:
            fn()
        except exc as e:
            print(f"refusal ok: {what}: {type(e).__name__}: {e}", flush=True)
        else:
            raise AssertionError(f"K1 took a {what} without raising")
    torch.cuda.synchronize()
    if dict(LAUNCHES) != before:
        raise AssertionError("a refused K1 call counted a launch")


K1_HEAD_DIMS = (16, 32, 64, 128)
K1_ATTRS = ("registers", "local_bytes", "static_smem", "dynamic_smem", "threads",
            "blocks_per_sm")


def k1_attributes() -> dict:
    """K1's three kernels as compiled, at each head dim:
    ``cudaFuncGetAttributes`` (registers, local spill bytes, shared memory)
    and resident blocks per SM, through ``dstorch_flash_kernel_attrs``."""
    import ctypes
    from deepspeed_tpu_torch.ops.kernels import _loader
    lib = _loader.load_library()
    out = {}
    for i, name in enumerate(K1_NAMES):
        for D in K1_HEAD_DIMS:
            buf = (ctypes.c_int * len(K1_ATTRS))()
            rc = lib.dstorch_flash_kernel_attrs(i, D, ctypes.cast(buf, ctypes.c_void_p))
            if rc != 0:
                raise RuntimeError(f"dstorch_flash_kernel_attrs({name}, D={D}): {rc}")
            out[f"{name}/D{D}"] = dict(zip(K1_ATTRS, list(buf)))
    return out


def check_flash(randn, record):
    """K1: forward (o, lse), dq and dk/dv kernels against their plain
    versions on the same inputs (the backward ones fed the kernel forward's
    o and lse), at D = 16/32/64/128, a ragged T, Tq != Tk (top-left causal
    and full) and GQA; each backward run twice and required bitwise equal;
    timed at the training shape, with SDPA as the library yardstick (never
    called by the port; its backward timed alone, on a retained graph).
    Prints the ``k1-kernels`` line (registers, spills, shared memory,
    achieved TFLOP/s) and fails on a spill."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from deepspeed_tpu_torch.ops.kernels import (
        flash_attention, flash_attention_fwd, flash_attention_fwd_plain,
        flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain,
        flash_delta)

    timed_rows = {}

    def case(B, H, Hkv, Tq, Tk, D, causal, timed=False):
        name = (f"B={B} H={H} Hkv={Hkv} Tq={Tq} Tk={Tk} D={D} "
                f"{'causal' if causal else 'full'}")
        scale = D ** -0.5
        q, do = randn(B, Tq, H, D), randn(B, Tq, H, D)
        k, v = randn(B, Tk, Hkv, D), randn(B, Tk, Hkv, D)
        kr = k.repeat_interleave(H // Hkv, dim=2)
        vr = v.repeat_interleave(H // Hkv, dim=2)
        o, lse = flash_attention_fwd(q, kr, vr, causal, scale)
        o_ref, lse_ref = flash_attention_fwd_plain(q, kr, vr, causal, scale)
        delta = flash_delta(o, do)
        dq = flash_bwd_dq(q, kr, vr, do, lse, delta, causal, scale)
        dq_ref = flash_bwd_dq_plain(q, kr, vr, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv(q, kr, vr, do, lse, delta, causal, scale)
        dk_ref, dv_ref = flash_bwd_dkv_plain(q, kr, vr, do, lse, delta, causal, scale)
        # no atomics: a second backward on the same inputs gives the same bits
        dq2 = flash_bwd_dq(q, kr, vr, do, lse, delta, causal, scale)
        dk2, dv2 = flash_bwd_dkv(q, kr, vr, do, lse, delta, causal, scale)
        torch.cuda.synchronize()
        same = {n: bool(torch.equal(a, b2)) for n, a, b2 in
                (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2))}
        print("k1-rerun " + json.dumps({"case": name, "bitwise_equal": same}), flush=True)
        if not all(same.values()):
            raise AssertionError(f"K1 backward is not deterministic at {name}: {same}")
        if causal:   # top-left: query i sees keys 0 .. min(i, Tk - 1)
            pairs = B * H * sum(min(i + 1, Tk) for i in range(Tq))
        else:
            pairs = B * H * Tq * Tk
        xq, xk = B * Tq * H * D * 2, B * Tk * H * D * 2   # one q-side / k-side tensor
        stats = B * H * Tq * 4                             # lse or delta
        extra = {}, {}, {}
        if timed:
            # the library yardstick: SDPA pinned to its flash backend; its
            # backward timed alone on one forward's retained graph
            qs, ks, vs, dos = (t.transpose(1, 2).contiguous() for t in (q, kr, vr, do))
            qg, kg, vg = (t.clone().requires_grad_() for t in (qs, ks, vs))
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                lib_f = time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal))
                out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
                lib_b = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dos,
                                                            retain_graph=True))
            del out, qg, kg, vg
            covers = "SDPA (flash backend) backward alone: dq, dk and dv together"
            flops = [4 * D * pairs, 6 * D * pairs, 8 * D * pairs]
            bounds = [bound(2 * xq + 2 * xk + stats, flops[0]),
                      bound(3 * xq + 2 * xk + 2 * stats, flops[1]),
                      bound(2 * xq + 4 * xk + 2 * stats, flops[2])]
            extra = (
                dict(ms=time_ms(lambda: flash_attention_fwd(q, kr, vr, causal, scale)),
                     plain_ms=time_ms(lambda: flash_attention_fwd_plain(
                         q, kr, vr, causal, scale), 5, 1), library_ms=lib_f),
                dict(ms=time_ms(lambda: flash_bwd_dq(q, kr, vr, do, lse, delta, causal, scale)),
                     plain_ms=time_ms(lambda: flash_bwd_dq_plain(
                         q, kr, vr, do, lse, delta, causal, scale), 5, 1), library_ms=lib_b,
                     library_covers=covers),
                dict(ms=time_ms(lambda: flash_bwd_dkv(q, kr, vr, do, lse, delta, causal, scale)),
                     plain_ms=time_ms(lambda: flash_bwd_dkv_plain(
                         q, kr, vr, do, lse, delta, causal, scale), 5, 1), library_ms=lib_b,
                     library_covers=covers))
            for kname, e, (b_ms, b_by), fl in zip(K1_NAMES, extra, bounds, flops):
                e.update(bound_ms=b_ms, bound_by=b_by)
                timed_rows[kname] = {"ms": e["ms"], "tflops": fl / e["ms"] / 1e9}
        record("flash_fwd", name, err((o, o_ref), (lse[..., None], lse_ref[..., None])),
               row=timed, **extra[0])
        record("flash_bwd_dq", name, err((dq, dq_ref)), row=timed, **extra[1])
        record("flash_bwd_dkv", name, err((dk, dk_ref), (dv, dv_ref)), row=timed, **extra[2])
        if Hkv != H:
            # the public autograd path: GQA repeat in the wrapper, dk/dv
            # reduced over each kv head's query heads by autograd
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            out = flash_attention(qg, kg, vg, causal=causal)
            out.backward(do)
            G = H // Hkv
            red = lambda t: t.float().view(B, Tk, Hkv, G, D).sum(3)
            record("flash_attention (autograd, GQA)", name,
                   err((out.detach(), o_ref), (qg.grad, dq_ref), (kg.grad, red(dk_ref)),
                       (vg.grad, red(dv_ref))))

    check_flash_refusals(randn)
    case(8, 12, 12, 1024, 1024, 64, True, timed=True)    # GPT-2 small's training shape
    case(2, 12, 12, 1000, 1000, 64, True)                # ragged edge
    case(2, 12, 12, 1024, 1024, 64, False)               # non-causal
    case(2, 12, 4, 1024, 1024, 128, True)                # GQA 12/4 at D = 128
    case(2, 12, 12, 1024, 1024, 16, True)                # D = 16
    case(2, 12, 12, 1000, 1000, 32, False)               # D = 32, ragged, full
    case(2, 12, 12, 384, 1000, 64, True)                 # Tq < Tk, top-left causal
    case(2, 12, 12, 384, 1000, 128, False)               # Tq < Tk, full
    case(2, 12, 12, 1000, 384, 32, True)                 # Tq > Tk, top-left causal
    case(2, 12, 12, 1000, 384, 16, False)                # Tq > Tk, full
    attrs = k1_attributes()
    print("k1-kernels " + json.dumps({"attributes": attrs, "training_shape": timed_rows,
                                      "device": torch.cuda.get_device_name(0)}), flush=True)
    spills = {k: a["local_bytes"] for k, a in attrs.items() if a["local_bytes"]}
    if spills:
        raise AssertionError(f"K1 kernels spill to local memory: {spills}")


# K8 at Llama-2-13B's projection shapes: M = 4 (the decode batch) through
# q/k/v/o, gate/up, down and the LM head, and M = 736 (a prefill pass)
# through gate/up; the kernel table keeps one shape per kernel
QMM_SHAPES = ((4, 5120, 5120), (4, 5120, 13824), (4, 13824, 5120), (4, 5120, 32000),
              (736, 5120, 13824))
QMM_ROWS = {"quantized_matmul_gemv": (4, 5120, 13824),
            "quantized_matmul_mma": (736, 5120, 13824)}
# the 13B attention cases: S = 4 sequences, 40 heads (MHA), D = 128, pages of
# 128, block tables as wide as phase 6's max_context (4608 = 36 pages); the
# 200-token row leaves splits empty at every split count
Q_CTXS = [4264, 2000, 900, 200]
Q_MB = 36


def check_quant_kernels(dev, g, randn, record):
    """K8, the int8 decode and chunk kernels, K7 at 2, 4 and 8 splits and
    the split-K merge, each against its plain version at Llama-2-13B's
    shapes; timed, with its bound (int8 values and f32 scales counted as
    the bytes they are)."""
    import torch
    from deepspeed_tpu_torch.inference.v2.ragged_model import quantize_weight_int8
    from deepspeed_tpu_torch.ops.kernels.kv_quant import (kv_quantize_rows,
                                                          kv_write_dequant,
                                                          scales_to_tiles)
    from deepspeed_tpu_torch.ops.kernels.paged_chunk import (
        paged_chunk_attention_batched, paged_chunk_attention_batched_plain)
    from deepspeed_tpu_torch.ops.kernels.paged_decode import (
        paged_decode_attention, paged_decode_attention_plain)
    from deepspeed_tpu_torch.ops.kernels.paged_splitk import (
        NEG_INF, merge_splitk_partials, splitk_attention, splitk_attention_plain,
        splitk_merge)
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import (
        GEMV, GEMV_MAX_M, MMA, quantized_matmul, quantized_matmul_plain)

    # ---- the int8 formats on the card: byte-equal to the CPU's (which the
    # CPU tests hold byte-equal to the JAX package's), and re-quantizing the
    # dequantized KV rows stores the same bytes ---- #
    rows = torch.randn(8192, 128, generator=g, device=dev) \
        * torch.rand(8192, 1, generator=g, device=dev) * 30
    qg, sg = kv_quantize_rows(rows)
    qc, sc_ = kv_quantize_rows(rows.cpu())
    qr, sr = kv_quantize_rows(kv_write_dequant(rows))
    w = torch.randn(5120, 1024, generator=g, device=dev) * 0.02
    wg, wc = quantize_weight_int8(w), quantize_weight_int8(w.cpu())
    fmt = {"kv_rows_equal_cpu": bool(torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc_)),
           "kv_requantize_idempotent": bool(torch.equal(qr, qg) and torch.equal(sr, sg)),
           "weights_equal_cpu": all(torch.equal(wg[k].cpu(), wc[k]) for k in wg)}
    print("int8 formats " + json.dumps(fmt), flush=True)
    if not all(fmt.values()):
        raise AssertionError(f"int8 formats differ on the card: {fmt}")
    del rows, qg, sg, qc, sc_, qr, sr, w, wg, wc

    # ---- K8 ---- #
    for M, K, N in QMM_SHAPES:
        a = randn(M, K)
        w = torch.randn(K, N, generator=g, device=dev) * K ** -0.5
        qd = quantize_weight_int8(w)
        w8, sc = qd["w8"], qd["scale"]
        wb = w.to(torch.bfloat16)
        del w
        out = quantized_matmul(a, w8, sc)
        ref = quantized_matmul_plain(a, w8, sc)
        torch.cuda.synchronize()
        name = GEMV if M <= GEMV_MAX_M else MMA
        b_ms, b_by = bound(K * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
        record(name, f"M={M} K={K} N={N}", err((out, ref)),
               row=(M, K, N) == QMM_ROWS[name],
               ms=time_ms(lambda: quantized_matmul(a, w8, sc)),
               plain_ms=time_ms(lambda: quantized_matmul_plain(a, w8, sc), 5, 1),
               library_ms=time_ms(lambda: torch.matmul(a, wb)),
               library_covers="torch.matmul on the bf16 weight of the same shape "
                              "(twice the weight bytes)",
               bound_ms=b_ms, bound_by=b_by)
        del w8, sc, wb

    # ---- one int8 pool (and its bf16 twin) for the attention kernels ---- #
    S, Hq, Hkv, D, bs = 4, 40, 40, 128, 128
    NB = sum(-(-c // bs) for c in Q_CTXS) + 2
    x = torch.randn(NB, 2, Hkv, bs, D, generator=g, device=dev)
    q8, scl = kv_quantize_rows(x)
    tiles = scales_to_tiles(scl).contiguous()
    pool16 = x.to(torch.bfloat16)
    del x, scl
    bt = block_tables(Q_CTXS, bs, Q_MB, NB, dev)
    ctx = torch.tensor(Q_CTXS, dtype=torch.int32, device=dev)
    qd = randn(S, Hq, D)

    def attn_bytes(toks, side_rows=0, extra=0):
        """int8 K and V rows + their f32 scales + bf16 q and out + f32 side
        rows, each once."""
        return (toks * Hkv * (2 * D + 2 * 4) + 2 * qd.numel() * 2
                + side_rows * Hkv * D * 2 * 4 + extra)

    # ---- int8 decode: pages only (pass rows), one side row (the step),
    # and four side rows at j = 2 (the side buffer) ---- #
    def decode_int8(C, j, timed=False):
        lens, side, kw = ctx, (), {}
        if C:
            lens = torch.clamp(ctx - 1, min=0)
            side = tuple(kv_write_dequant(randn(S, C * Hkv, D)) for _ in range(2))
            kw = {"j": j}
        fn = lambda: paged_decode_attention(qd, q8, bt, lens, *side, kv_scales=tiles, **kw)
        ref = paged_decode_attention_plain(qd, q8, bt, lens, *side, kv_scales=tiles, **kw)
        out = fn()
        torch.cuda.synchronize()
        extra = {}
        if timed:
            toks = int(lens.sum())
            b_ms, b_by = bound(attn_bytes(toks, S * (j + 1)),
                               4 * D * Hq * (toks + S * (j + 1)))
            extra = dict(ms=time_ms(fn), plain_ms=time_ms(lambda: paged_decode_attention_plain(
                qd, q8, bt, lens, *side, kv_scales=tiles, **kw), 5, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)
        record("paged_decode_int8", f"S={S} H={Hq} Hkv={Hkv} D={D} ctx={Q_CTXS} C={C} j={j}",
               err((out, ref)), row=timed, **extra)

    decode_int8(0, 0)
    decode_int8(4, 2)
    decode_int8(1, 0, timed=True)

    # ---- int8 chunk: 4 slots x 128 rows at the end of each context ---- #
    Cs = 128
    qc = randn(S, Cs, Hq, D)
    q0 = torch.clamp(ctx - Cs, min=0)
    out = paged_chunk_attention_batched(qc, q8, bt, q0, ctx, kv_scales=tiles)
    ref = paged_chunk_attention_batched_plain(qc, q8, bt, q0, ctx, kv_scales=tiles)
    torch.cuda.synchronize()
    vis = sum(min(c, q + r + 1) for c, q in zip(Q_CTXS, q0.tolist()) for r in range(Cs))
    b_ms, b_by = bound(sum(Q_CTXS) * Hkv * (2 * D + 8) + 2 * qc.numel() * 2, 4 * D * Hq * vis)
    record("paged_chunk_int8", f"{S}x{Cs} rows ctx={Q_CTXS} H={Hq} D={D}", err((out, ref)),
           row=True, ms=time_ms(lambda: paged_chunk_attention_batched(
               qc, q8, bt, q0, ctx, kv_scales=tiles)),
           plain_ms=time_ms(lambda: paged_chunk_attention_batched_plain(
               qc, q8, bt, q0, ctx, kv_scales=tiles), 5, 1),
           library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # ---- K7 at 2, 4 and 8 splits: int8 with one f32 side row (the decode
    # step, timed), int8 pages only (pass rows), bf16 pages only ---- #
    lens1 = torch.clamp(ctx - 1, min=0)
    side = tuple(kv_write_dequant(randn(S, Hkv, D)) for _ in range(2))
    for n in (2, 4, 8):
        name = f"paged_splitk_int8/{n}"
        fn = lambda: splitk_attention(qd, q8, bt, lens1, n, *side, kv_scales=tiles)
        out = fn()
        ref = splitk_attention_plain(qd, q8, bt, lens1, n, *side, kv_scales=tiles)
        toks = int(lens1.sum())
        partials = S * (n + 1) * Hq * (D + 1) * 4
        b_ms, b_by = bound(attn_bytes(toks, S, extra=2 * partials), 4 * D * Hq * (toks + S))
        record(name, f"S={S} H={Hq} D={D} ctx={Q_CTXS} int8 + 1 f32 side row", err((out, ref)),
               row=True, ms=time_ms(fn),
               plain_ms=time_ms(lambda: splitk_attention_plain(
                   qd, q8, bt, lens1, n, *side, kv_scales=tiles), 5, 1),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
        o, lse = splitk_attention(qd, q8, bt, ctx, n, kv_scales=tiles, with_lse=True)
        o_ref, lse_ref = splitk_attention_plain(qd, q8, bt, ctx, n, kv_scales=tiles,
                                                with_lse=True)
        record(name, "int8 pages only, with lse", err((o, o_ref), (lse[..., None],
                                                                   lse_ref[..., None])))
        record(f"paged_splitk/{n}", "bf16 pages only", err((
            splitk_attention(qd, pool16, bt, ctx, n),
            splitk_attention_plain(qd, pool16, bt, ctx, n))))

    # ---- the split-K merge alone: 9 pieces (8 splits + the side piece),
    # some empty, one row all empty ---- #
    P = 9
    out_p = torch.randn(S, P, Hq, D, generator=g, device=dev)
    lse_p = torch.randn(S, P, Hq, generator=g, device=dev) * 4
    lse_p[:, 5:8] = NEG_INF
    lse_p[3, :] = NEG_INF
    o, lse = splitk_merge(out_p, lse_p, torch.bfloat16, with_lse=True)
    o_ref, lse_ref = merge_splitk_partials(out_p, lse_p)
    torch.cuda.synchronize()
    if float(o[3].float().abs().max()) != 0.0:
        raise AssertionError("splitk_merge: an all-empty row is not zero")
    b_ms, b_by = bound(out_p.numel() * 4 + lse_p.numel() * 4 + S * Hq * (D * 2 + 4),
                       3 * out_p.numel())
    record("splitk_merge", f"S={S} P={P} H={Hq} D={D}, 3 empty pieces, 1 empty row",
           err((o, o_ref.to(torch.bfloat16)), (lse[:3, :, None], lse_ref[:3, :, None])),
           row=True, ms=time_ms(lambda: splitk_merge(out_p, lse_p, torch.bfloat16)),
           plain_ms=time_ms(lambda: merge_splitk_partials(out_p, lse_p), 5, 1),
           library_ms=None, bound_ms=b_ms, bound_by=b_by)


# Mistral-7B's attention at its serving shapes (phase 9): 32 query heads over
# 8 KV heads (G = 4), D = 128, pages of 128, block tables as wide as phase
# 9's max_context (16384 = 128 pages), the page ring of 66 pages; contexts
# past the ring (12032 wraps it), past the window (5032) and inside it (332)
MISTRAL_WINDOW = 4096
W_HEADS, W_BS = (32, 8, 128), 128      # query heads, KV heads, head dim; page size
W_CTXS = [12032, 5032, 2032, 332]
W_MB, W_RING = 128, 66
W_SEGS = [4224, 300, 100]             # K2: the take cap's segment and two short ones
W_SHORT = 200                         # the second window: starts mid-tile, mid-page


def ring_tables(ctxs, bs, MB, ring, dev):
    """Block tables [len(ctxs), MB] int32 as the scheduler's page ring makes
    them: row i owns ``ring`` pages of its own and logical page p reads
    physical page ``own[p % ring]``; returns (tables, pages in the pool)."""
    import torch
    NB = len(ctxs) * ring
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(11)).to(torch.int32)
    bt = torch.zeros((len(ctxs), MB), dtype=torch.int32)
    for i, c in enumerate(ctxs):
        own = perm[i * ring:(i + 1) * ring]
        for p in range(-(-c // bs)):
            bt[i, p] = own[p % ring]
    return bt.to(dev), NB


def poison_below(pool, bt, ctxs, starts, bs):
    """A copy of ``pool`` whose pages wholly below each row's first visible
    token ``starts[i]`` hold NaN (tables without repeated pages): a kernel
    that reads such a page, even masked, gives NaN."""
    import torch
    out = pool.clone()
    for i, lo in enumerate(starts):
        dead = [int(bt[i, p]) for p in range(-(-ctxs[i] // bs)) if (p + 1) * bs <= lo]
        if dead:
            out[torch.tensor(dead, device=pool.device)] = float("nan")
    return out


def check_window_kernels(dev, randn, record):
    """The window branch of K2, K5, the decode kernel (K3/K4/K6) and K7 with
    its merge, each against its plain version at Mistral-7B's shapes with
    the window of 4096 (the kernel-table rows) and of 200 (a start mid-tile
    and mid-page), through ring tables; then the poison check: pages wholly
    below every row's window start filled with NaN (tables without repeated
    pages) leave each kernel's output bitwise unchanged, so those pages are
    skipped, not read and masked."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import (
        flash_attention_packed, flash_attention_packed_plain,
        paged_chunk_attention_batched, paged_chunk_attention_batched_plain,
        paged_decode_attention, paged_decode_attention_plain,
        splitk_attention, splitk_attention_plain)
    (H, Hkv, D), bs = W_HEADS, W_BS
    W = MISTRAL_WINDOW

    # ---- K2: one 4224-row segment (the take cap) plus two short ones ---- #
    seg_lens = W_SEGS
    R = sum(seg_lens) + 16                          # 16 padding rows
    seg = torch.full((R,), -1, dtype=torch.int32, device=dev)
    o = 0
    for i, n in enumerate(seg_lens):
        seg[o:o + n] = i
        o += n
    q, k, v = randn(R, H, D), randn(R, Hkv, D), randn(R, Hkv, D)
    idx = torch.arange(R, device=dev)
    for w in (W, W_SHORT):
        out = flash_attention_packed(q, k, v, seg, window=w)
        ref = flash_attention_packed_plain(q, k, v, seg, window=w)
        torch.cuda.synchronize()
        case = f"R={R} H={H} Hkv={Hkv} D={D} segs={seg_lens}+pad window={w}"
        extra = {}
        if w == W:
            pairs = sum(sum(min(r + 1, w) for r in range(n)) for n in seg_lens + [16])
            mask = (idx[:, None] >= idx[None]) & (idx[:, None] - idx[None] < w) \
                & (seg[:, None] == seg[None])
            qt = q.transpose(0, 1)[None]
            kt, vt = (x.repeat_interleave(H // Hkv, dim=1).transpose(0, 1)[None]
                      for x in (k, v))
            b_ms, b_by = bound((2 * R * H + 2 * R * Hkv) * D * 2 + R * 4, 4 * D * H * pairs)
            extra = dict(ms=time_ms(lambda: flash_attention_packed(q, k, v, seg, window=w)),
                         plain_ms=time_ms(lambda: flash_attention_packed_plain(
                             q, k, v, seg, window=w), 3, 1),
                         library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                             qt, kt, vt, attn_mask=mask)),
                         library_covers="SDPA over the same boolean mask (K and V "
                                        "repeated to 32 heads)",
                         bound_ms=b_ms, bound_by=b_by)
            del mask, qt, kt, vt
        rows_ = slice(0, sum(seg_lens))
        record("flash_packed_window", case, err((out[rows_], ref[rows_])), row=w == W,
               **extra)
    del q, k, v, out, ref
    torch.cuda.empty_cache()

    # ---- one ring pool for K5, the decode kernel and K7 ---- #
    bt, NB = ring_tables(W_CTXS, bs, W_MB, W_RING, dev)
    pool = randn(NB, 2, Hkv, bs, D)
    ctx = torch.tensor(W_CTXS, dtype=torch.int32, device=dev)
    S = len(W_CTXS)

    # K5: 4 slots x 128 rows at the end of each context (window starts
    # mid-page: 12032 - 128 - 4096 + 1 = 7809 = 61 pages + 1)
    Cs = 128
    qc = randn(S, Cs, H, D)
    q0 = torch.clamp(ctx - Cs, min=0)
    for w in (W, W_SHORT):
        out = paged_chunk_attention_batched(qc, pool, bt, q0, ctx, window=w)
        ref = paged_chunk_attention_batched_plain(qc, pool, bt, q0, ctx, window=w)
        torch.cuda.synchronize()
        extra = {}
        if w == W:
            vis = sum(min(c, qs + r + 1) - max(0, qs + r + 1 - w)
                      for c, qs in zip(W_CTXS, q0.tolist()) for r in range(Cs)
                      if qs + r < c)
            toks = sum(c - max(0, qs - w + 1) for c, qs in zip(W_CTXS, q0.tolist()))
            b_ms, b_by = bound(toks * Hkv * D * 2 * 2 + 2 * qc.numel() * 2, 4 * D * H * vis)
            extra = dict(ms=time_ms(lambda: paged_chunk_attention_batched(
                qc, pool, bt, q0, ctx, window=w)),
                plain_ms=time_ms(lambda: paged_chunk_attention_batched_plain(
                    qc, pool, bt, q0, ctx, window=w), 3, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)
        record("paged_chunk_window", f"{S}x{Cs} rows ctx={W_CTXS} ring {W_RING} window={w}",
               err((out, ref)), row=w == W, **extra)

    # the decode kernel: pages only (decode rows of a pass), one side row
    # (the decode step, the table's row) and four side rows at j = 2
    qd = randn(S, H, D)
    for w in (W, W_SHORT):
        for C, j in ((0, 0), (1, 0), (4, 2)):
            lens, side, kw = ctx, (), {}
            if C:
                lens = torch.clamp(ctx - 1 - j, min=0)
                side = (randn(S, C * Hkv, D), randn(S, C * Hkv, D))
                kw = {"j": j}
            out = paged_decode_attention(qd, pool, bt, lens, *side, window=w, **kw)
            ref = paged_decode_attention_plain(qd, pool, bt, lens, *side, window=w, **kw)
            torch.cuda.synchronize()
            timed = w == W and C == 1
            extra = {}
            if timed:
                toks = sum(min(w - 1, n) for n in lens.tolist()) + S
                b_ms, b_by = bound(toks * Hkv * D * 2 * 2 + 2 * qd.numel() * 2,
                                   4 * D * H * toks)
                extra = dict(ms=time_ms(lambda: paged_decode_attention(
                    qd, pool, bt, lens, *side, window=w, **kw)),
                    plain_ms=time_ms(lambda: paged_decode_attention_plain(
                        qd, pool, bt, lens, *side, window=w, **kw), 3, 1),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by)
            record("paged_decode_window",
                   f"S={S} H={H} Hkv={Hkv} ctx={W_CTXS} ring {W_RING} C={C} j={j} window={w}",
                   err((out, ref)), row=timed, **extra)

    # K7 at 2 and 4 splits with one side row (the decode step at rungs 2
    # and 4, the table's rows) and pages only with lse; split 0 lies wholly
    # below the window start (4 splits of 4096 tokens at ctx 12032 and
    # window 4096; 2 splits of 8192 at window 200)
    lens1 = torch.clamp(ctx - 1, min=0)
    side = (randn(S, Hkv, D), randn(S, Hkv, D))
    for n in (2, 4):
        name = f"paged_splitk_window/{n}"
        for w in (W, W_SHORT):
            fn = lambda: splitk_attention(qd, pool, bt, lens1, n, *side, window=w)
            out = fn()
            ref = splitk_attention_plain(qd, pool, bt, lens1, n, *side, window=w)
            extra = {}
            if w == W:
                toks = sum(min(w - 1, n_) for n_ in lens1.tolist()) + S
                partials = S * (n + 1) * H * (D + 1) * 4
                b_ms, b_by = bound(toks * Hkv * D * 2 * 2 + 2 * qd.numel() * 2 + 2 * partials,
                                   4 * D * H * toks)
                extra = dict(ms=time_ms(fn), plain_ms=time_ms(lambda: splitk_attention_plain(
                    qd, pool, bt, lens1, n, *side, window=w), 3, 1),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by)
            record(name, f"S={S} H={H} Hkv={Hkv} ctx={W_CTXS} ring {W_RING} 1 side row "
                   f"window={w}", err((out, ref)), row=w == W, **extra)
            o, lse = splitk_attention(qd, pool, bt, ctx, n, with_lse=True, window=w)
            o_ref, lse_ref = splitk_attention_plain(qd, pool, bt, ctx, n, with_lse=True,
                                                    window=w)
            record(name, f"pages only, with lse, window={w}",
                   err((o, o_ref), (lse[..., None], lse_ref[..., None])))
    del pool
    torch.cuda.empty_cache()

    # ---- the poison check: tables without repeated pages ---- #
    NBp = sum(-(-c // bs) for c in W_CTXS) + 1
    bt_p = block_tables(W_CTXS, bs, W_MB, NBp, dev)
    clean = randn(NBp, 2, Hkv, bs, D)
    poisoned = {}
    for w in (W, W_SHORT):
        def check(label, starts, fn):
            key = (w, tuple(starts))
            if key not in poisoned:
                poisoned[key] = poison_below(clean, bt_p, W_CTXS, starts, bs)
            a, b = fn(clean), fn(poisoned[key])
            torch.cuda.synchronize()
            same = bool(torch.equal(a, b))
            dead = sum((max(0, lo) // bs) for lo in starts)
            print("poison-check " + json.dumps({"kernel": label, "window": w,
                                                "pages_poisoned": dead,
                                                "output_unchanged": same}), flush=True)
            if not same or not dead:
                raise AssertionError(f"{label} window={w}: a page below the window start "
                                     f"was read (or none was poisoned: {dead})")

        starts = [max(0, c - w) for c in W_CTXS]
        check("paged_decode_window (pages only)", starts,
              lambda p: paged_decode_attention(qd, p, bt_p, ctx, window=w))
        side4 = (randn(S, 4 * Hkv, D), randn(S, 4 * Hkv, D))
        lens3 = torch.clamp(ctx - 3, min=0)
        check("paged_decode_window (side rows, j = 2)",
              [max(0, int(n) + 3 - w) for n in lens3.tolist()],
              lambda p: paged_decode_attention(qd, p, bt_p, lens3, *side4, j=2, window=w))
        for n in (2, 4):
            check(f"paged_splitk_window/{n}", starts,
                  lambda p, n=n: splitk_attention(qd, p, bt_p, ctx, n, window=w))
        check("paged_chunk_window", [max(0, qs - w + 1) for qs in q0.tolist()],
              lambda p: paged_chunk_attention_batched(qc, p, bt_p, q0, ctx, window=w))
    del clean, poisoned
    torch.cuda.empty_cache()


# BLOOM-560M's attention at its serving shapes (phase 10): 16 heads over 16
# KV heads (G = 1), D = 64, pages of 128, block tables as wide as phase
# 10's max_context (2048 = 16 pages); contexts at phase 10's prompts' ends
# (the 1900-token prompt reaches 1932 tokens: ALiBi biases up to 0.707 x
# 1931 = 1365 against scores of order 1)
A_HEADS, A_BS, A_MB = (16, 16, 64), 128, 16   # query heads, KV heads, head dim
A_CTXS = [1932, 1032, 432, 92]
A_WIDE = (112, 112, 128)                      # BLOOM-176B's heads: the interpolated slopes
A_WIDE_CTXS = [700, 92]


def check_alibi_kernels(dev, randn, record):
    """The ALiBi branch of K5, the decode kernel (K3/K4/K6) and K7 with its
    merge, each against its plain version at BLOOM-560M's shapes (the
    kernel-table rows), plus one untimed launch of the decode kernel and K5
    at 112 heads, D = 128, whose head count takes the slopes' interpolation
    branch."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import (
        paged_chunk_attention_batched, paged_chunk_attention_batched_plain,
        paged_decode_attention, paged_decode_attention_plain,
        splitk_attention, splitk_attention_plain)
    (H, Hkv, D), bs = A_HEADS, A_BS
    S = len(A_CTXS)
    NB = sum(-(-c // bs) for c in A_CTXS) + 1
    bt = block_tables(A_CTXS, bs, A_MB, NB, dev)
    pool = randn(NB, 2, Hkv, bs, D)
    ctx = torch.tensor(A_CTXS, dtype=torch.int32, device=dev)

    # K5: 4 slots x 128 rows at the end of each context (the prefill
    # passes' continuation chunks at rung 1)
    Cs = 128
    qc = randn(S, Cs, H, D)
    q0 = torch.clamp(ctx - Cs, min=0)
    out = paged_chunk_attention_batched(qc, pool, bt, q0, ctx, alibi=True)
    ref = paged_chunk_attention_batched_plain(qc, pool, bt, q0, ctx, alibi=True)
    torch.cuda.synchronize()
    vis = sum(min(c, qs + r + 1) for c, qs in zip(A_CTXS, q0.tolist()) for r in range(Cs))
    b_ms, b_by = bound(sum(A_CTXS) * Hkv * D * 2 * 2 + 2 * qc.numel() * 2, 4 * D * H * vis)
    record("paged_chunk_alibi", f"{S}x{Cs} rows H={H} Hkv={Hkv} D={D} ctx={A_CTXS} bs={bs}",
           err((out, ref)), row=True,
           ms=time_ms(lambda: paged_chunk_attention_batched(qc, pool, bt, q0, ctx, alibi=True)),
           plain_ms=time_ms(lambda: paged_chunk_attention_batched_plain(
               qc, pool, bt, q0, ctx, alibi=True), 3, 1),
           library_ms=None, bound_ms=b_ms, bound_by=b_by)

    # the decode kernel: pages only (decode rows of a pass) and one side
    # row at prefix + 0 (the decode step at rung 1, the table's row)
    qd = randn(S, H, D)
    lens1 = torch.clamp(ctx - 1, min=0)
    side = (randn(S, Hkv, D), randn(S, Hkv, D))
    for C in (0, 1):
        lens, sd = (lens1, side) if C else (ctx, ())
        fn = lambda: paged_decode_attention(qd, pool, bt, lens, *sd, alibi=True)
        out = fn()
        ref = paged_decode_attention_plain(qd, pool, bt, lens, *sd, alibi=True)
        torch.cuda.synchronize()
        extra = {}
        if C:
            toks = sum(A_CTXS)
            b_ms, b_by = bound(toks * Hkv * D * 2 * 2 + 2 * qd.numel() * 2, 4 * D * H * toks)
            extra = dict(ms=time_ms(fn), plain_ms=time_ms(
                lambda: paged_decode_attention_plain(qd, pool, bt, lens, *sd, alibi=True), 3, 1),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)
        record("paged_decode_alibi", f"S={S} H={H} Hkv={Hkv} D={D} ctx={A_CTXS} C={C}",
               err((out, ref)), row=bool(C), **extra)

    # K7 at 2 and 4 splits: one side row (the decode step at rungs 2 and 4,
    # the table's rows), and pages only with the merged lse
    for n in (2, 4):
        name = f"paged_splitk_alibi/{n}"
        fn = lambda: splitk_attention(qd, pool, bt, lens1, n, *side, alibi=True)
        out = fn()
        ref = splitk_attention_plain(qd, pool, bt, lens1, n, *side, alibi=True)
        toks = sum(A_CTXS)
        partials = S * (n + 1) * H * (D + 1) * 4
        b_ms, b_by = bound(toks * Hkv * D * 2 * 2 + 2 * qd.numel() * 2 + 2 * partials,
                           4 * D * H * toks)
        record(name, f"S={S} H={H} Hkv={Hkv} D={D} ctx={A_CTXS} 1 side row",
               err((out, ref)), row=True, ms=time_ms(fn),
               plain_ms=time_ms(lambda: splitk_attention_plain(
                   qd, pool, bt, lens1, n, *side, alibi=True), 3, 1),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
        o, lse = splitk_attention(qd, pool, bt, ctx, n, with_lse=True, alibi=True)
        o_ref, lse_ref = splitk_attention_plain(qd, pool, bt, ctx, n, with_lse=True,
                                                alibi=True)
        record(name, "pages only, with lse", err((o, o_ref), (lse[..., None],
                                                              lse_ref[..., None])))
    del pool

    # one untimed launch each at 112 heads, D = 128 (interpolated slopes)
    H, Hkv, D = A_WIDE
    ctxs = A_WIDE_CTXS
    NBw = sum(-(-c // bs) for c in ctxs) + 1
    btw = block_tables(ctxs, bs, A_MB, NBw, dev)
    poolw = randn(NBw, 2, Hkv, bs, D)
    cw = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    qw = randn(2, H, D)
    record("paged_decode_alibi", f"S=2 H={H} Hkv={Hkv} D={D} ctx={ctxs} (interpolated slopes)",
           err((paged_decode_attention(qw, poolw, btw, cw, alibi=True),
                paged_decode_attention_plain(qw, poolw, btw, cw, alibi=True))))
    qcw = randn(2, 64, H, D)
    q0w = torch.clamp(cw - 64, min=0)
    record("paged_chunk_alibi", f"2x64 rows H={H} Hkv={Hkv} D={D} ctx={ctxs} "
           "(interpolated slopes)",
           err((paged_chunk_attention_batched(qcw, poolw, btw, q0w, cw, alibi=True),
                paged_chunk_attention_batched_plain(qcw, poolw, btw, q0w, cw, alibi=True))))
    del poolw
    torch.cuda.empty_cache()


# The side buffer of a decode_steps burst (K6 and K7's side piece at C > 1):
# C = 16 side rows, steps j = 0, 7 and 15, at each main path's shapes.
# Llama-2-7B (32/32 heads, D = 128) at phase 4's burst prefixes; Llama-2-13B
# int8 pages with an f32 slab at phase 6's; Mistral-7B's head shape (G = 4)
# through its ring tables with a window of 8 (so j >= window occurs) and of
# 4096 (the table's row); BLOOM-560M (16/16 heads, D = 64) with ALiBi
SIDE_C, SIDE_STEPS = 16, (0, 7, 15)
SIDE_PREFIX_7B = [905, 305, 125, 45]
SIDE_WINDOW = 8


def check_side_kernels(dev, randn, record):
    """The decode kernel (K6) and K7's side piece at 2/4/8 splits over a side
    slab of C = 16 rows, each against its plain version at j = 0, 7, 15;
    the table rows time j = 15 (the most side rows)."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.kv_quant import (kv_quantize_rows,
                                                          kv_write_dequant,
                                                          scales_to_tiles)
    from deepspeed_tpu_torch.ops.kernels.paged_decode import (
        launch_name, paged_decode_attention, paged_decode_attention_plain)
    from deepspeed_tpu_torch.ops.kernels.paged_splitk import (
        kernel_name, splitk_attention, splitk_attention_plain)
    C = SIDE_C
    g = torch.Generator(device=dev).manual_seed(4321)

    def case(label, H, Hkv, D, pool, bt, prefix, side, splits, toks_of, kv_bytes,
             timed_splits=(), **kw):
        """Each kernel (splits 0: the decode kernel) at each step j against
        its plain version; ``toks_of(j)`` counts the visible page tokens,
        ``kv_bytes`` the bytes of one visible token's K and V."""
        S = prefix.shape[0]
        qd = randn(S, H, D)
        quant = "kv_scales" in kw
        for n in splits:
            for j in SIDE_STEPS:
                if n:
                    fn = lambda: splitk_attention(qd, pool, bt, prefix, n, *side, j=j, **kw)
                    plain = lambda: splitk_attention_plain(qd, pool, bt, prefix, n, *side,
                                                           j=j, **kw)
                    name = kernel_name(n, kw.get("window"), kw.get("alibi", False), side=True,
                                       quant=quant)
                else:
                    fn = lambda: paged_decode_attention(qd, pool, bt, prefix, *side, j=j, **kw)
                    plain = lambda: paged_decode_attention_plain(qd, pool, bt, prefix, *side,
                                                                 j=j, **kw)
                    name = launch_name(quant, kw.get("window"), kw.get("alibi", False), C)
                out, ref = fn(), plain()
                torch.cuda.synchronize()
                timed = j == SIDE_STEPS[-1] and n in timed_splits
                extra = {}
                if timed:
                    toks, rows = toks_of(j), S * (j + 1)
                    side_bytes = rows * Hkv * D * side[0].element_size() * 2
                    partials = 2 * S * (n + 1) * H * (D + 1) * 4 if n else 0
                    b_ms, b_by = bound(toks * kv_bytes + side_bytes + 2 * qd.numel() * 2
                                       + partials, 4 * D * H * (toks + rows))
                    extra = dict(ms=time_ms(fn), plain_ms=time_ms(plain, 3, 1),
                                 library_ms=None, bound_ms=b_ms, bound_by=b_by)
                record(name, f"{label} C={C} j={j}", err((out, ref)), row=timed, **extra)

    # ---- Llama-2-7B, bf16 ---- #
    H, Hkv, D, bs, MB = 32, 32, 128, 128, 16
    NB = sum(-(-(p + C) // bs) for p in SIDE_PREFIX_7B) + 2
    bt = block_tables([p + C for p in SIDE_PREFIX_7B], bs, MB, NB, dev)
    pool = randn(NB, 2, Hkv, bs, D)
    prefix = torch.tensor(SIDE_PREFIX_7B, dtype=torch.int32, device=dev)
    side = (randn(4, C * Hkv, D), randn(4, C * Hkv, D))
    case(f"Llama-2-7B S=4 H={H} D={D} prefix={SIDE_PREFIX_7B}", H, Hkv, D, pool, bt, prefix,
         side, (0, 2, 4, 8), lambda j: sum(SIDE_PREFIX_7B), Hkv * D * 2 * 2,
         timed_splits=(0, 2, 4))
    del pool, side

    # ---- Llama-2-13B, int8 pages, f32 slab (timed at 2/4/8 splits) ---- #
    H, Hkv = 40, 40
    pre13 = [c - 1 for c in Q_CTXS]
    NB = sum(-(-(p + C) // bs) for p in pre13) + 2
    x = torch.randn(NB, 2, Hkv, bs, D, generator=g, device=dev)
    q8, scl = kv_quantize_rows(x)
    tiles = scales_to_tiles(scl).contiguous()
    del x, scl
    bt = block_tables([p + C for p in pre13], bs, Q_MB, NB, dev)
    prefix = torch.tensor(pre13, dtype=torch.int32, device=dev)
    side = tuple(kv_write_dequant(randn(4, C * Hkv, D)) for _ in range(2))
    case(f"Llama-2-13B int8 S=4 H={H} D={D} prefix={pre13}", H, Hkv, D, q8, bt, prefix, side,
         (0, 2, 4, 8), lambda j: sum(pre13), Hkv * (2 * D + 8), timed_splits=(0, 2, 4, 8),
         kv_scales=tiles)
    del q8, tiles, side

    # ---- Mistral-7B's heads, ring tables, windows of 8 and 4096 ---- #
    (H, Hkv, D), bs = W_HEADS, W_BS
    preW = [c - 1 - C for c in W_CTXS]
    bt, NB = ring_tables(W_CTXS, bs, W_MB, W_RING, dev)
    pool = randn(NB, 2, Hkv, bs, D)
    prefix = torch.tensor(preW, dtype=torch.int32, device=dev)
    side = (randn(4, C * Hkv, D), randn(4, C * Hkv, D))
    for w in (SIDE_WINDOW, MISTRAL_WINDOW):
        case(f"Mistral-7B heads S=4 H={H} Hkv={Hkv} prefix={preW} ring {W_RING} window={w}",
             H, Hkv, D, pool, bt, prefix, side, (0, 4),
             lambda j, w=w: sum(min(max(w - 1 - j, 0), p) for p in preW), Hkv * D * 2 * 2,
             timed_splits=(0, 4) if w == MISTRAL_WINDOW else (), window=w)
    del pool, side

    # ---- BLOOM-560M, ALiBi, D = 64 ---- #
    (H, Hkv, D), bs = A_HEADS, A_BS
    preA = [c - 1 - C for c in A_CTXS]
    NB = sum(-(-(p + C) // bs) for p in preA) + 1
    bt = block_tables([p + C for p in preA], bs, A_MB, NB, dev)
    pool = randn(NB, 2, Hkv, bs, D)
    prefix = torch.tensor(preA, dtype=torch.int32, device=dev)
    side = (randn(4, C * Hkv, D), randn(4, C * Hkv, D))
    case(f"BLOOM-560M S=4 H={H} D={D} prefix={preA}", H, Hkv, D, pool, bt, prefix, side,
         (0, 2), lambda j: sum(preA), Hkv * D * 2 * 2, timed_splits=(0, 2), alibi=True)
    del pool, side
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# phase 4: the serving slice at Llama-2-7B width
# --------------------------------------------------------------------------- #

def run_slice():
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    # the fp32 yardstick runs in full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"model: Llama-2-7B geometry, {cfg.num_hidden_layers} layers, bf16, random weights "
          f"(seed 0), init {time.perf_counter() - t0:.1f} s", flush=True)
    # the default pool sizing (max_tracked_sequences x max_context) would ask
    # for 4096 pages of 64 MiB: size the pool explicitly
    # the split ladder up to 4 serves decode_steps bursts at pinned rungs 2
    # and 4; every earlier step stays at rung 1 (contexts below 1024)
    econf = {"kv_cache": {"block_size": 128, "num_blocks": 64},
             "attention": {"decode_splits": 4}, "seed": 0}
    engine = InferenceEngineV2(model, econf, model.flat_params())
    V = cfg.vocab_size
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in (900, 300, 120, 40)]

    # ---- the main path: generate(), then a mixed put() round ---- #
    reset_launches()
    outs = engine.generate(prompts, max_new_tokens=32)
    new = [rng.randint(0, V, n).astype(np.int32) for n in (200, 150, 180)]
    lg = engine.put([100, 101], new[:2])
    nxt = [np.array([int(np.argmax(r))], np.int32) for r in lg]
    lg2 = engine.put([100, 101, 102], nxt + [new[2]])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    engine.flush([100, 101, 102])
    print("main-path launches " + json.dumps(launches), flush=True)
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + 32 or list(o[:len(p)]) != list(p) \
                or not all(0 <= t < V for t in o):
            raise AssertionError("generate() returned a malformed stream")
    if lg2.shape != (3, V) or not np.isfinite(lg2).all():
        raise AssertionError("put() logits malformed")
    launches = {k: launches[k] for k in ("flash_packed", "paged_chunk", "paged_decode")}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if engine.free_blocks != 64:
        raise AssertionError(f"free blocks {engine.free_blocks} != 64 after flush")

    # ---- logits against the dense forward; token rates ---- #
    uids = [10, 11, 12, 13]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [engine.put(uids, prompts)]                      # prefill logits
    t_prefill = time.perf_counter() - t0
    pipe = engine.decode_pipeline(uids)
    toks = []
    for _ in range(3):                                     # pipelined steps
        toks.append(pipe.run(1)[:, 0])
        engine._materialize(uids)
        got.append(np.stack([engine._last_logits[u] for u in uids]))
    last = np.argmax(got[-1], axis=-1).astype(np.int32)    # one decode row each
    got.append(engine.put(uids, [last[i:i + 1] for i in range(4)]))
    toks.append(last)
    e_eng, e_dense, m_eng, m_dense = [], [], 0.0, 0.0
    for i, p in enumerate(prompts):
        seq = np.concatenate([p] + [t[i:i + 1] for t in toks])
        ids = torch.from_numpy(seq).long().cuda()[None]
        ref32 = model.forward_logits(ids, compute_dtype=torch.float32)[0]
        ref16 = model.forward_logits(ids, compute_dtype=torch.bfloat16)[0]
        rows = slice(len(p) - 1, len(p) + 4)
        eng = torch.from_numpy(np.stack([g[i] for g in got])).cuda()
        d_eng = (eng - ref32[rows]).float()
        d_dense = (ref16[rows] - ref32[rows]).float()
        e_eng.append(float(d_eng.pow(2).mean()))
        e_dense.append(float(d_dense.pow(2).mean()))
        m_eng = max(m_eng, float(d_eng.abs().max()))
        m_dense = max(m_dense, float(d_dense.abs().max()))
        if not torch.isfinite(eng).all():
            raise AssertionError("engine logits are not finite")
    rms_eng, rms_dense = float(np.sqrt(np.mean(e_eng))), float(np.sqrt(np.mean(e_dense)))
    print(f"logits vs dense fp32 (prefill + 4 decode steps x 4 prompts): engine bf16 "
          f"rms {rms_eng:.5f} max {m_eng:.4f}; dense bf16 rms {rms_dense:.5f} "
          f"max {m_dense:.4f}; limit rms <= 2 x dense", flush=True)
    if not rms_eng <= 2 * rms_dense:
        raise AssertionError(f"engine logits error {rms_eng} > 2 x dense bf16 {rms_dense}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(32)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    n_prompt = sum(len(p) for p in prompts)
    print(f"prefill {n_prompt} tokens in {t_prefill * 1e3:.1f} ms = "
          f"{n_prompt / t_prefill:.1f} tok/s; decode 4 x 32 tokens in "
          f"{t_decode * 1e3:.1f} ms = {128 / t_decode:.1f} tok/s", flush=True)
    # where the time goes: device kernel time under the CUDA profiler
    prof = device_breakdown("decode 4 seqs x 8 steps", lambda: pipe.run(8))
    engine.flush(uids)
    device_breakdown("prefill 4 prompts (1360 tokens)",
                     lambda: engine.put([20, 21, 22, 23], prompts))
    engine.flush([20, 21, 22, 23])
    pipe_step = {"wall_ms": t_decode / 32 * 1e3, "device_ms": prof["device_ms"] / 8}
    launches.update(run_bursts_7b(engine, model, prompts, 2 * m_dense, pipe_step))
    return launches


# decode_steps bursts: 16 steps each, the side-buffer schedule unless built
# with max_side_bytes = 0 (the per-step-write loop)
# The int8 pool's window and ALiBi branches (phases 11 and 12): Mistral-7B's
# heads through its ring tables (phase 3's window shapes) and BLOOM-7b1's
# (32/32 heads, D = 128, pages of 128, block tables as wide as phase 12's
# max_context of 2048) at phase 12's prompts' ends
Q_SIDE_WINDOW = 8                     # the side buffer's j >= window case
B7_HEADS, B7_CTXS, B7_MB = (32, 32, 128), [1932, 1032, 432, 92], 16


def int8_pool(g, NB, Hkv, bs, D, dev):
    """An int8 pool [NB, 2, Hkv, bs, D] and its f32 scale tiles from one
    seeded f32 draw (rows of different magnitudes)."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_quantize_rows, scales_to_tiles
    x = torch.randn(NB, 2, Hkv, bs, D, generator=g, device=dev) \
        * (0.25 + 2 * torch.rand(NB, 2, Hkv, bs, 1, generator=g, device=dev))
    q8, scl = kv_quantize_rows(x)
    return q8, scales_to_tiles(scl).contiguous()


def page_tokens(lens, j, side, window):
    """Visible page tokens of one decode row: its query sits at lens - 1
    (pages only) or lens + j (side rows), and sees tokens from the window
    start on."""
    q_next = lens + j + 1 if side else lens
    return lens - (max(q_next - window, 0) if window else 0)


def int8_branch_checks(label, H, Hkv, D, q8, tiles, bt, ctxs, randn, record, kw,
                       timed, splits, side_splits, dev):
    """The int8 decode kernel (pages only, one side row, C = 16 side rows at
    j = 0/7/15), K5 (4 slots x 128 rows at each context's end) and K7
    (``splits`` with one side row, pages only with the merged lse; its side
    piece at ``side_splits`` over C = 16 rows), each against its plain
    version under ``kw`` (``window=`` or ``alibi=True``); ``timed`` makes
    the one-side-row, C = 16 j = 15 and K5 cases the kernel-table rows."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_write_dequant
    from deepspeed_tpu_torch.ops.kernels.paged_chunk import (
        paged_chunk_attention_batched, paged_chunk_attention_batched_plain)
    from deepspeed_tpu_torch.ops.kernels.paged_decode import (
        launch_name, paged_decode_attention, paged_decode_attention_plain)
    from deepspeed_tpu_torch.ops.kernels.paged_splitk import (
        kernel_name, splitk_attention, splitk_attention_plain)
    S, C = len(ctxs), SIDE_C
    w, alibi = kw.get("window"), kw.get("alibi", False)
    ctx = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    qd = randn(S, H, D)
    tok_bytes = Hkv * (2 * D + 8)                 # int8 K and V rows + two f32 scales
    case = f"{label} S={S} H={H} Hkv={Hkv} D={D} ctx={ctxs} {kw}"

    def timing(fn, plain, toks, rows, extra_bytes=0):
        side_bytes = rows * Hkv * D * 2 * 4
        b_ms, b_by = bound(toks * tok_bytes + side_bytes + 2 * qd.numel() * 2 + extra_bytes,
                           4 * D * H * (toks + rows))
        return dict(ms=time_ms(fn), plain_ms=time_ms(plain, 3, 1), library_ms=None,
                    bound_ms=b_ms, bound_by=b_by)

    # the decode kernel: pages only, one side row (the decode step), and
    # the side buffer's C = 16 rows at j = 0/7/15
    for c, steps in ((0, (0,)), (1, (0,)), (C, SIDE_STEPS)):
        lens = torch.clamp(ctx - 1 - (c - 1 if c else 0), min=0) if c else ctx
        side = tuple(kv_write_dequant(randn(S, c * Hkv, D)) for _ in range(2)) if c else ()
        for j in steps:
            jk = {"j": j} if c else {}
            fn = lambda: paged_decode_attention(qd, q8, bt, lens, *side, kv_scales=tiles,
                                                **jk, **kw)
            plain = lambda: paged_decode_attention_plain(qd, q8, bt, lens, *side,
                                                         kv_scales=tiles, **jk, **kw)
            out, ref = fn(), plain()
            torch.cuda.synchronize()
            row = timed and c and j == steps[-1]
            extra = timing(fn, plain, sum(page_tokens(n, j, bool(c), w) for n in
                                          lens.tolist()), S * (j + 1) if c else 0) \
                if row else {}
            record(launch_name(True, w, alibi, c), f"{case} C={c} j={j}", err((out, ref)),
                   row=row, **extra)

    # K5: 4 slots x 128 rows at the end of each context
    Cs = 128
    qc = randn(S, Cs, H, D)
    q0 = torch.clamp(ctx - Cs, min=0)
    fn = lambda: paged_chunk_attention_batched(qc, q8, bt, q0, ctx, kv_scales=tiles, **kw)
    plain = lambda: paged_chunk_attention_batched_plain(qc, q8, bt, q0, ctx,
                                                        kv_scales=tiles, **kw)
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    extra = {}
    if timed:
        lo = lambda qs: max(0, qs - w + 1) if w else 0
        toks = sum(c - lo(qs) for c, qs in zip(ctxs, q0.tolist()))
        vis = sum(min(c, qs + r + 1) - (max(0, qs + r + 1 - w) if w else 0)
                  for c, qs in zip(ctxs, q0.tolist()) for r in range(Cs) if qs + r < c)
        b_ms, b_by = bound(toks * tok_bytes + 2 * qc.numel() * 2, 4 * D * H * vis)
        extra = dict(ms=time_ms(fn), plain_ms=time_ms(plain, 3, 1), library_ms=None,
                     bound_ms=b_ms, bound_by=b_by)
    record(f"paged_chunk_int8{'_window' if w else ''}{'_alibi' if alibi else ''}",
           f"{label} {S}x{Cs} rows H={H} Hkv={Hkv} ctx={ctxs} {kw}", err((out, ref)),
           row=timed, **extra)

    # K7: one side row (the decode step at rungs above 1), pages only with
    # lse, and the side piece over C = 16 rows
    lens1 = torch.clamp(ctx - 1, min=0)
    side1 = tuple(kv_write_dequant(randn(S, Hkv, D)) for _ in range(2))
    for n in splits:
        name = kernel_name(n, w, alibi, quant=True)
        fn = lambda: splitk_attention(qd, q8, bt, lens1, n, *side1, kv_scales=tiles, **kw)
        plain = lambda: splitk_attention_plain(qd, q8, bt, lens1, n, *side1,
                                               kv_scales=tiles, **kw)
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        extra = timing(fn, plain, sum(page_tokens(x, 0, True, w) for x in lens1.tolist()),
                       S, 2 * S * (n + 1) * H * (D + 1) * 4) if timed else {}
        record(name, f"{case} 1 side row", err((out, ref)), row=timed, **extra)
        o, lse = splitk_attention(qd, q8, bt, ctx, n, kv_scales=tiles, with_lse=True, **kw)
        o_ref, lse_ref = splitk_attention_plain(qd, q8, bt, ctx, n, kv_scales=tiles,
                                                with_lse=True, **kw)
        record(name, f"{case} pages only, with lse",
               err((o, o_ref), (lse[..., None], lse_ref[..., None])))
    preC = torch.clamp(ctx - 1 - C, min=0)
    sideC = tuple(kv_write_dequant(randn(S, C * Hkv, D)) for _ in range(2))
    for n in side_splits:
        for j in SIDE_STEPS:
            fn = lambda: splitk_attention(qd, q8, bt, preC, n, *sideC, j=j, kv_scales=tiles,
                                          **kw)
            plain = lambda: splitk_attention_plain(qd, q8, bt, preC, n, *sideC, j=j,
                                                   kv_scales=tiles, **kw)
            out, ref = fn(), plain()
            torch.cuda.synchronize()
            row = timed and j == SIDE_STEPS[-1]
            extra = timing(fn, plain, sum(page_tokens(x, j, True, w) for x in preC.tolist()),
                           S * (j + 1), 2 * S * (n + 1) * H * (D + 1) * 4) if row else {}
            record(kernel_name(n, w, alibi, side=True, quant=True), f"{case} C={C} j={j}",
                   err((out, ref)), row=row, **extra)


def check_quant_window_kernels(dev, g, randn, record):
    """The int8 pool's window branch of the decode kernel (K3/K4/K6), K5 and
    K7 (2 and 4 splits, the side piece at 4) at Mistral-7B's shapes through
    its ring tables, windows 4096 (the table's rows), 8 (side rows with
    j >= window) and 200 (a start mid-tile and mid-page); then the int8
    poison check: the scale tiles of every page wholly below each row's
    window start hold NaN (int8 values cannot), and each kernel's output
    stays bitwise equal, so neither those pages nor their scales are
    read."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_write_dequant
    from deepspeed_tpu_torch.ops.kernels.paged_chunk import paged_chunk_attention_batched
    from deepspeed_tpu_torch.ops.kernels.paged_decode import paged_decode_attention
    from deepspeed_tpu_torch.ops.kernels.paged_splitk import splitk_attention
    (H, Hkv, D), bs = W_HEADS, W_BS
    bt, NB = ring_tables(W_CTXS, bs, W_MB, W_RING, dev)
    q8, tiles = int8_pool(g, NB, Hkv, bs, D, dev)
    int8_branch_checks("Mistral-7B ring", H, Hkv, D, q8, tiles, bt, W_CTXS, randn, record,
                       {"window": MISTRAL_WINDOW}, True, (2, 4), (4,), dev)
    for w in (Q_SIDE_WINDOW, W_SHORT):
        int8_branch_checks("Mistral-7B ring", H, Hkv, D, q8, tiles, bt, W_CTXS, randn,
                           record, {"window": w}, False, (2, 4), (4,), dev)
    del q8, tiles
    torch.cuda.empty_cache()

    # ---- the poison check: tables without repeated pages ---- #
    NBp = sum(-(-c // bs) for c in W_CTXS) + 1
    bt_p = block_tables(W_CTXS, bs, W_MB, NBp, dev)
    q8, clean = int8_pool(g, NBp, Hkv, bs, D, dev)
    ctx = torch.tensor(W_CTXS, dtype=torch.int32, device=dev)
    S = len(W_CTXS)
    qd = randn(S, H, D)
    qc = randn(S, 128, H, D)
    q0 = torch.clamp(ctx - 128, min=0)
    side4 = tuple(kv_write_dequant(randn(S, 4 * Hkv, D)) for _ in range(2))
    lens3 = torch.clamp(ctx - 3, min=0)
    for w in (MISTRAL_WINDOW, W_SHORT):
        def check(label, starts, fn):
            poisoned = poison_below(clean, bt_p, W_CTXS, starts, bs)
            a, b = fn(clean), fn(poisoned)
            torch.cuda.synchronize()
            same = bool(torch.equal(a, b))
            dead = sum(lo // bs for lo in starts)
            print("poison-check " + json.dumps({"kernel": label, "window": w,
                                                "scale_tiles_poisoned": dead,
                                                "output_unchanged": same}), flush=True)
            if not same or not dead:
                raise AssertionError(f"{label} window={w}: a scale tile below the window "
                                     f"start was read (or none was poisoned: {dead})")

        starts = [max(0, c - w) for c in W_CTXS]
        check("paged_decode_int8_window (pages only)", starts,
              lambda t: paged_decode_attention(qd, q8, bt_p, ctx, kv_scales=t, window=w))
        check("paged_decode_int8_side_window (side rows, j = 2)",
              [max(0, int(n) + 3 - w) for n in lens3.tolist()],
              lambda t: paged_decode_attention(qd, q8, bt_p, lens3, *side4, j=2,
                                               kv_scales=t, window=w))
        for n in (2, 4):
            check(f"paged_splitk_int8_window/{n}", starts,
                  lambda t, n=n: splitk_attention(qd, q8, bt_p, ctx, n, kv_scales=t,
                                                  window=w))
        check("paged_chunk_int8_window", [max(0, qs - w + 1) for qs in q0.tolist()],
              lambda t: paged_chunk_attention_batched(qc, q8, bt_p, q0, ctx, kv_scales=t,
                                                      window=w))
    del q8, clean
    torch.cuda.empty_cache()


def check_quant_alibi_kernels(dev, g, randn, record):
    """The int8 pool's ALiBi branch of the decode kernel (K3/K4/K6), K5 and
    K7 (2 and 4 splits, the side piece at 2) at BLOOM-7b1's shapes (32/32
    heads, D = 128, contexts 1932/1032/432/92)."""
    import torch
    (H, Hkv, D), bs = B7_HEADS, A_BS
    NB = sum(-(-c // bs) for c in B7_CTXS) + 1
    bt = block_tables(B7_CTXS, bs, B7_MB, NB, dev)
    q8, tiles = int8_pool(g, NB, Hkv, bs, D, dev)
    int8_branch_checks("BLOOM-7b1", H, Hkv, D, q8, tiles, bt, B7_CTXS, randn, record,
                       {"alibi": True}, True, (2, 4), (2,), dev)
    del q8, tiles
    torch.cuda.empty_cache()


# K8 over int4-unpacked weights at Mistral-7B's gate/up projection: M = 4
# (the decode batch, gemv) and M = 4224 (the windowed prefill pass, mma)
QMM4_SHAPES = ((4, 4096, 14336), (4224, 4096, 14336))


def check_int4_matmul(dev, g, randn, record):
    """``_mm`` over a packed int4 weight: the unpack (torch ops) and K8 on
    the unpacked values, each timed, against the plain version; the bound
    counts the packed weight's K*N/2 bytes (what a fused int4 body would
    stream)."""
    import torch
    from deepspeed_tpu_torch.inference.v2.ragged_model import _mm, quantize_weight_int4
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import (
        GEMV, GEMV_MAX_M, quantized_matmul, quantized_matmul_plain)
    from deepspeed_tpu_torch.ops.quantizer import unpack_int4
    for M, K, N in QMM4_SHAPES:
        a = randn(M, K)
        w = torch.randn(K, N, generator=g, device=dev) * K ** -0.5
        qd = quantize_weight_int4(w)
        wb = w.to(torch.bfloat16)
        del w
        w8 = unpack_int4(qd["w4"])
        out, ref = _mm(a, qd), quantized_matmul_plain(a, w8, qd["scale"])
        torch.cuda.synchronize()
        name = GEMV if M <= GEMV_MAX_M else "quantized_matmul_mma"
        b_ms, b_by = bound(K * N // 2 + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
        record(name, f"int4 unpacked M={M} K={K} N={N}", err((out, ref)),
               mm_ms=time_ms(lambda: _mm(a, qd)),
               unpack_ms=time_ms(lambda: unpack_int4(qd["w4"])),
               k8_ms=time_ms(lambda: quantized_matmul(a, w8, qd["scale"])),
               plain_ms_int4=time_ms(lambda: quantized_matmul_plain(
                   a, unpack_int4(qd["w4"]), qd["scale"]), 5, 1),
               library_ms_bf16=time_ms(lambda: torch.matmul(a, wb)),
               bound_ms_int4=b_ms, bound_by_int4=b_by)
        del qd, wb, w8


BURST = 16
BURST_PROFILED = 8          # the profiled burst after each timed one
B_KERNELS_7B = ("paged_decode_side", "paged_splitk_side/2", "paged_splitk_side/4")
B_NAMES = ("paged_decode", "paged_splitk", "splitk_merge", "qmm_gemv", "qmm_mma")


def device_time(fn, names=()) -> dict:
    """Run ``fn`` once under the CUDA-only profiler and sum its device
    activity straight from the trace's events (the per-name tables of
    :func:`device_breakdown` cost seconds of host time for a burst's ~10^5
    kernels): device ms in all, and of the port's kernels ``names``
    (matched as ``<name>_kernel``). Returns ``fn``'s result too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    total, ours = 0, {n: 0 for n in names}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            ns = e.duration_ns()
            total += ns
            for n in names:
                if f"{n}_kernel" in e.name():
                    ours[n] += ns
    return {"device_ms": total / 1e6 if total else float("nan"),
            "port_kernels_ms": {n: v / 1e6 for n, v in ours.items()}, "result": out}


def burst_line(label, engine, uids, n, pipe_step, names=B_NAMES, profiled_steps=None,
               **extra):
    """One greedy burst of ``n`` steps timed on the host clock, then one of
    ``profiled_steps`` (default ``n``) under the profiler; prints wall and
    device ms per step beside the pipeline's step of the same phase, with
    the card's name and power limit. Returns both bursts' ids."""
    import torch
    m = profiled_steps or n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = engine.decode_steps(uids, n)
    wall = (time.perf_counter() - t0) * 1e3
    prof = device_time(lambda: engine.decode_steps(uids, m), names)
    ids = np.concatenate([ids, prof["result"]], axis=1)
    print("burst " + json.dumps({
        "phase": label, "steps": n, "rows": len(uids), "wall_ms_per_step": wall / n,
        "device_ms_per_step": prof["device_ms"] / m, "profiled_steps": m,
        "port_kernels_ms_per_step": {k: v / m for k, v in prof["port_kernels_ms"].items()},
        "pipeline_wall_ms_per_step": pipe_step["wall_ms"],
        "pipeline_device_ms_per_step": pipe_step["device_ms"], "nvidia_smi": smi_line(),
        **extra}), flush=True)
    if ids.shape != (len(uids), n + m) or not ((ids >= 0) & (ids < engine.spec.vocab_size)).all():
        raise AssertionError(f"{label}: malformed burst ids {ids.shape}")
    return ids


def same_or_near_tie(label, a, b, gap_at, limit):
    """Greedy streams ``a`` and ``b`` [S, n] agree, or each row's first
    difference sits where the reference's top-2 logit gap (``gap_at(row,
    step)``) is below ``limit``: twice the largest logit error of the
    phase's dense bf16 forward against fp32. Two bf16 paths whose logits
    each lie that close to fp32 may order two logits closer than twice it
    either way."""
    ties = []
    for i in range(a.shape[0]):
        diff = np.flatnonzero(a[i] != b[i])
        if diff.size:
            gap = gap_at(i, int(diff[0]))
            ties.append({"row": i, "step": int(diff[0]), "top2_gap": gap})
            if not gap < limit:
                raise AssertionError(f"{label}: row {i} differs at step {diff[0]} where the "
                                     f"top-2 gap {gap} >= the limit {limit}")
    print("greedy-compare " + json.dumps({"case": label, "equal": not ties,
                                          "first_differences": ties, "limit": limit}),
          flush=True)


def run_bursts_7b(engine, model, prompts, tie, pipe_step):
    """Phase 4's bursts: greedy at rung 1 and pinned rungs 2 and 4, a
    sampled one (top_k 50), one built with max_side_bytes = 0 (the
    per-step-write loop), sample_next against a put() of the same tokens,
    final logits against the dense fp32 forward, a fetch=False burst with
    no host sync, and a page handoff (export_kv -> import_kv). Returns the
    side kernels' launch counts over these bursts."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    V = engine.spec.vocab_size
    uid = itertools.count(40)

    def fresh():
        """Four new uids holding the prompts' prefill (deterministic, so
        every burst below starts from the same pages and logits)."""
        u = [next(uid) for _ in prompts]
        engine.put(u, prompts)
        return u

    def dense(seq, dt):
        ids = torch.from_numpy(np.asarray(seq, np.int64)).cuda()[None]
        return model.forward_logits(ids, compute_dtype=dt)[0].float()

    def final_logits_check(label, uids_, streams_):
        """The burst's final logits against the dense fp32 forward of prompt
        + generated tokens: RMS within 2x the same forward's in bf16."""
        engine._materialize(uids_)
        e_eng, e_dense = [], []
        for i, u_ in enumerate(uids_):
            seq = np.concatenate([prompts[i], streams_[i]])
            ref32, ref16 = dense(seq, torch.float32)[-1], dense(seq, torch.bfloat16)[-1]
            eng = torch.from_numpy(engine._last_logits[u_]).cuda()
            if not torch.isfinite(eng).all():
                raise AssertionError(f"{label}: final logits are not finite")
            e_eng.append(float((eng - ref32).pow(2).mean()))
            e_dense.append(float((ref16 - ref32).pow(2).mean()))
        rms_eng, rms_dense = float(np.sqrt(np.mean(e_eng))), float(np.sqrt(np.mean(e_dense)))
        print(f"burst final logits vs dense fp32 ({label} x 4 prompts): engine rms "
              f"{rms_eng:.5f}; dense bf16 rms {rms_dense:.5f}; limit rms <= 2 x dense",
              flush=True)
        if not rms_eng <= 2 * rms_dense:
            raise AssertionError(f"{label}: logits error {rms_eng} > 2 x dense bf16 {rms_dense}")

    def gap_of(rows_of):
        def gap(i, step):
            top = torch.topk(dense(rows_of(i, step), torch.float32)[-1], 2).values
            return float(top[0] - top[1])
        return gap

    bs = engine.kv.config.block_size
    crossing = [i for i, p in enumerate(prompts) if len(p) // bs != (len(p) + BURST - 1) // bs]
    if not crossing:
        raise AssertionError("no sequence crosses a page boundary inside the burst")
    reset_launches()
    engine.attn_stats.reset()
    streams = {}
    for rung in (1, 2, 4):
        engine.attn_rung_override = rung
        u = fresh()
        streams[rung] = burst_line(f"Llama-2-7B burst rung {rung}", engine, u, BURST,
                                   pipe_step, profiled_steps=BURST_PROFILED,
                                   crossing_page_rows=crossing)
        if rung == 1:
            base_uids = u
        else:
            engine.flush(u)
    engine.attn_rung_override = 1
    launches = {k: LAUNCHES.get(k, 0) for k in B_KERNELS_7B}
    rungs = dict(engine.attn_stats.rungs)
    print("burst launches " + json.dumps({"launches": launches, "rungs": rungs}), flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the bursts: {missing}")
    toks = streams[1]

    def burst_rows(i, step):
        return np.concatenate([prompts[i], toks[i, :step]])

    for rung in (2, 4):
        same_or_near_tie(f"burst rung {rung} vs rung 1", streams[rung], toks,
                         gap_of(burst_rows), tie)

    # ---- the per-step-write loop: the same tokens ---- #
    u = fresh()
    cache = type(engine._multistep)
    engine._multistep = cache(maxsize=8)       # the next burst's key: built anew
    engine._multistep.get_or_create(
        (BURST, 4, False, 0, 1),
        lambda: engine._build_multistep(BURST, False, 0, 1, max_side_bytes=0))
    reset_launches()
    general = engine.decode_steps(u, BURST)
    side_free = not any(LAUNCHES.get(k, 0) for k in B_KERNELS_7B)
    print("per-step-write burst " + json.dumps({
        "side_launches_none": side_free, "paged_decode": LAUNCHES.get("paged_decode", 0)}),
        flush=True)
    if not side_free or not LAUNCHES.get("paged_decode", 0):
        raise AssertionError("the max_side_bytes=0 burst did not run the per-step-write loop")
    final_logits_check("per-step-write burst, 16 steps", u, general)
    same_or_near_tie("per-step-write loop vs side buffer", general, toks[:, :BURST],
                     gap_of(burst_rows), tie)
    engine._multistep = cache(maxsize=8)
    engine.flush(u)

    final_logits_check(f"side-buffer bursts, {BURST} + {BURST_PROFILED} steps", base_uids, toks)

    # ---- sample_next after the burst against a put() of the same tokens ---- #
    nxt = engine.sample_next(base_uids)
    u = fresh()
    lg = engine.put(u, [toks[i] for i in range(4)])
    ref_nxt = np.argmax(lg, axis=-1)

    def put_gap(i, _):
        top = np.sort(lg[i])[-2:]
        return float(top[1] - top[0])

    same_or_near_tie("sample_next after a burst vs put() of the same tokens",
                     nxt[:, None], ref_nxt[:, None], put_gap, tie)
    engine.flush(u)

    # ---- a sampled burst ---- #
    sampled = engine.decode_steps(base_uids, BURST, do_sample=True, temperature=0.8, top_k=50)
    if sampled.shape != (4, BURST) or not ((sampled >= 0) & (sampled < V)).all():
        raise AssertionError("sampled burst malformed")
    print(f"sampled burst (top_k 50, temperature 0.8): {sampled[:, :8].tolist()}", flush=True)

    # ---- fetch=False: no host sync inside the burst ---- #
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev_ids = engine.decode_steps(base_uids, BURST, fetch=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not (dev_ids.is_cuda and tuple(dev_ids.shape) == (4, BURST)):
        raise AssertionError(f"fetch=False burst returned {dev_ids.device} {dev_ids.shape}")
    print("fetch=False burst under set_sync_debug_mode('error'): no sync", flush=True)
    engine.flush(base_uids)

    # ---- a page handoff: two twins, one exported and imported anew ---- #
    a, b = next(uid), next(uid)
    engine.put([a], [prompts[1]])
    engine.put([b], [prompts[1]])
    sched = engine.scheduler
    twins_equal = bool((engine.fetch_pages(sched.seqs[a].blocks)
                        == engine.fetch_pages(sched.seqs[b].blocks)).all())
    pages, lg_b = engine.export_kv(b)
    c = next(uid)
    ids = engine.import_kv(c, prompts[1], pages, lg_b)
    copy_equal = bool((engine.fetch_pages(ids) == pages).all())
    both = engine.decode_steps([a, c], BURST)
    if both.shape != (2, BURST):
        raise AssertionError(f"burst on the handoff pair returned {both.shape}")
    print("page handoff " + json.dumps({
        "payload": [list(pages.shape), str(pages.dtype)], "twins_bytes_equal": twins_equal,
        "imported_bytes_equal": copy_equal, "pages": len(ids)}), flush=True)
    if not copy_equal:
        raise AssertionError("fetch_pages of the imported pages differs from the export")
    same_or_near_tie("burst on the imported copy vs the original", both[1:], both[:1],
                     gap_of(lambda i, step: np.concatenate([prompts[1], both[0, :step]])),
                     tie)
    engine.flush([a, c])
    engine.attn_rung_override = None
    return launches


# --------------------------------------------------------------------------- #
# phase 5: the training slice at GPT-2 small's width
# --------------------------------------------------------------------------- #

TRAIN_CONFIG = {
    "train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
    "bf16": {"enabled": True}, "gradient_clipping": 1.0,
    "zero_optimization": {"stage": 0}, "steps_per_print": 0,
    "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                              "eps": 1e-8, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0, "warmup_max_lr": 6e-4,
                                                 "warmup_num_steps": 5}},
}
K1_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


@contextlib.contextmanager
def plain_attention():
    """Route the GPT-2 model's attention to the dense reference (the
    yardstick's path); restored on exit."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.attention import reference_attention
    kernel_path = gpt2.dot_product_attention
    gpt2.dot_product_attention = reference_attention
    try:
        yield
    finally:
        gpt2.dot_product_attention = kernel_path


def loss_and_grads(model, micro):
    """(loss, flat f32 gradient) of one micro-batch through ``model``."""
    import torch
    params = list(model.parameters())
    loss = model(micro)
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), torch.cat([g.float().flatten() for g in grads])


def first_step_check(engine, cfg, micro):
    """The engine's first micro-batch loss and gradient (bf16, K1) against
    an fp32 forward/backward with plain attention (TF32 off), beside a bf16
    one with plain attention; fails unless the engine's error is within 2x
    the bf16 one's plus FIRST_STEP_FLOOR of the yardstick's scale."""
    import dataclasses

    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one = torch.ones((), dtype=torch.float32, device="cuda")
    loss_e, grads_e = engine._grad_fn(micro, one)
    g_e = torch.cat([g.float().flatten() for g in grads_e])
    loss_e = float(loss_e)
    master = engine.state["master"]
    ref = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = GPT2LMHead(dataclasses.replace(cfg, dtype=dt), device="cuda")
        model.load_flat_params(master)
        with plain_attention():
            ref[name] = loss_and_grads(model, micro)
        del model
    loss32, g32 = ref["fp32"]
    rms = lambda t: float(t.pow(2).mean().sqrt())
    out = {"loss_fp32": loss32, "loss_engine": loss_e, "loss_bf16_plain": ref["bf16"][0],
           "loss_err_engine": abs(loss_e - loss32),
           "loss_err_bf16_plain": abs(ref["bf16"][0] - loss32),
           "grad_rms_fp32": rms(g32), "grad_rms_err_engine": rms(g_e - g32),
           "grad_rms_err_bf16_plain": rms(ref["bf16"][1] - g32),
           "floor_share": FIRST_STEP_FLOOR}
    print("first-step " + json.dumps(out), flush=True)
    for what, scale in (("loss", abs(loss32)), ("grad_rms", out["grad_rms_fp32"])):
        limit = 2 * out[f"{what}_err_bf16_plain"] + FIRST_STEP_FLOOR * scale
        if not out[f"{what}_err_engine"] <= limit:
            raise AssertionError(f"first step: engine {what} error "
                                 f"{out[f'{what}_err_engine']} > {limit}")


def run_training(steps: int = 10):
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    cfg = GPT2Config(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = GPT2LMHead(cfg, device="cuda", seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_CONFIG)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.state["master"].values())
    print(f"model: GPT-2 small (GPT2Config() defaults: vocab {cfg.vocab_size}, width "
          f"{cfg.n_embd}, {cfg.n_layer} layers, {cfg.n_head} heads, T {cfg.n_positions}), "
          f"{n_params} params, bf16 with fp32 master, random weights (seed 0), init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    T, V = cfg.n_positions, cfg.vocab_size
    batch = {"input_ids": np.random.default_rng(0).integers(0, V, (16, T)).astype(np.int32)}
    micro = {"input_ids": torch.from_numpy(batch["input_ids"][:8]).cuda()}
    first_step_check(engine, cfg, micro)
    torch.cuda.empty_cache()

    # ---- the main path: train_steps on the repeated batch ---- #
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = engine.train_steps(steps, data_iter=itertools.repeat(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    tokens = steps * 16 * T
    print("main-path launches " + json.dumps(launches), flush=True)
    print("train " + json.dumps({
        "steps": steps, "losses": [float(x) for x in losses], "wall_s": wall,
        "step_ms": wall / steps * 1e3, "tokens_per_s": tokens / wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "grad_norm_last": engine.get_global_grad_norm(), "lr_now": engine.get_lr()[0]}),
        flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: step 1 {losses[0]}, step {steps} {losses[-1]}")
    want = 2 * cfg.n_layer * steps       # one of each per layer and micro-batch
    wrong = {k: launches[k] for k in K1_NAMES if launches[k] != want}
    if wrong:
        raise AssertionError(f"K1 launches {wrong}, expected {want} of each")
    # one step timed in two parts: until train_batch returns (the host's
    # enqueue) and until the device is done
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(batch)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print("train step " + json.dumps({"host_enqueue_ms": (t1 - t0) * 1e3,
                                      "wall_ms": (t2 - t0) * 1e3}), flush=True)
    device_breakdown("train step (16 x 1024 tokens, 2 micro-batches)",
                     lambda: engine.train_batch(batch))
    t0 = time.perf_counter()
    ev = engine.eval_loss(batch)
    print(f"eval_loss {ev:.4f} ({(time.perf_counter() - t0) * 1e3:.1f} ms)", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 6: memory-lean long-context serving of Llama-2-13B
# --------------------------------------------------------------------------- #

Q_KERNELS = ("quantized_matmul_gemv", "quantized_matmul_mma", "paged_decode_int8",
             "paged_chunk_int8", "paged_splitk_int8/2", "paged_splitk_int8/4",
             "paged_splitk_int8/8", "splitk_merge")
ENGINE_13B = {"quantization": {"weight_bits": 8}, "kv_quant": {"enabled": True},
              "attention": {"decode_splits": 8, "min_ctx_per_split": 512},
              "kv_cache": {"block_size": 128, "num_blocks": 96},
              "state_manager": {"max_context": Q_MB * 128}, "seed": 0}


def dense_quant_logits(engine, cfg, ids, rows, dt, n_full=0):
    """What the engine computes, as a dense causal forward over one token
    sequence ``ids`` [T]: every projection is ``_mm``'s function over the
    engine's own int8 weights (f32 sum, column scale, result in ``dt``),
    and attention reads K and V at the values the int8 pages store
    (``kv_write_dequant``), except for the first ``n_full`` positions when
    the sequence began in a prefill-from-zero pass of that many tokens:
    that pass attends its own rows at full precision and only writes the
    pages quantized (as the JAX engine does). Weights dequantize one matmul
    at a time, so no f32 copy of the model exists. Returns f32 logits at
    positions ``rows``."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.models.llama import apply_rope, rms_norm, rope_tables
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_write_dequant
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul_plain

    def mm(x, w):
        return quantized_matmul_plain(x, w["w8"], w["scale"])

    W = engine.weights
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    T = ids.shape[0]
    cos, sin = rope_tables(torch.arange(T, device=ids.device), D, cfg.rope_theta)
    causal = torch.ones(T, T, dtype=torch.bool, device=ids.device).tril()

    def attend(q, k, v):
        n = q.shape[0]
        k, v = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
        s = torch.einsum("qhd,khd->hqk", q, k).float() * D ** -0.5
        s.masked_fill_(~causal[:n, :n], torch.finfo(torch.float32).min)
        p = torch.softmax(s, -1)
        del s
        return torch.einsum("hqk,khd->qhd", p.to(dt), v)

    x = W["embed"][ids].to(dt)
    for w in W["layers"]:
        h = rms_norm(x, w["ln1"], eps, dt)
        q = apply_rope(mm(h, w["wq"]).view(T, H, D), cos, sin)
        k = apply_rope(mm(h, w["wk"]).view(T, Hkv, D), cos, sin)
        v = mm(h, w["wv"]).view(T, Hkv, D)
        o = attend(q, kv_write_dequant(k).to(dt), kv_write_dequant(v).to(dt))
        if n_full:
            o[:n_full] = attend(q[:n_full], k[:n_full], v[:n_full])
        x = x + mm(o.reshape(T, H * D), w["wo"])
        h = rms_norm(x, w["ln2"], eps, dt)
        x = x + mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])
    x = rms_norm(x[rows], W["final_norm"], eps, dt)
    return mm(x, W["lm_head"]).float()


def run_13b():
    """Phase 6: Llama-2-13B at full width and depth, random bf16 weights from
    seed 0, served with int8 weights, int8 KV pages and the split ladder up
    to 8. Returns the main path's launch counts of the new kernels."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = lambda b: b / 2 ** 30
    cfg = LlamaConfig.llama2_13b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    engine = InferenceEngineV2(model, ENGINE_13B, model.flat_params())
    del model                     # the caller's bf16 tree: the engine keeps int8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"model: Llama-2-13B (vocab {cfg.vocab_size}, hidden {cfg.hidden_size}, FFN "
          f"{cfg.intermediate_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, head_dim {cfg.head_dim}), random bf16 weights "
          f"(seed 0) quantized to int8 by the engine, int8 KV pool of "
          f"{ENGINE_13B['kv_cache']['num_blocks']} pages, ladder {engine.attn_split_ladder}; "
          f"build {time.perf_counter() - t0:.1f} s; memory after build "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB, peak during build "
          f"{gib(torch.cuda.max_memory_allocated()):.2f} GiB", flush=True)
    V = cfg.vocab_size
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in (4200, 2000, 900, 200)]
    uids = [10, 11, 12, 13]

    # ---- the main path ---- #
    reset_launches()
    engine.attn_stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    gen_rungs = dict(engine.attn_stats.rungs)
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + 32 or list(o[:len(p)]) != list(p) \
                or not all(0 <= t < V for t in o):
            raise AssertionError("generate() returned a malformed stream")
    # note each sequence's prefill-from-zero pass, whose rows attend each
    # other at full precision (the dense check below follows it)
    n_full = {}
    complete = engine.scheduler.complete_pass

    def noting(batch):
        if batch.pure_prefill:
            for u in batch.chunk_uids:
                n_full.setdefault(u, engine.scheduler.seqs[u].in_flight_tokens)
        return complete(batch)

    engine.scheduler.complete_pass = noting
    t0 = time.perf_counter()
    got = [engine.put(uids, prompts)]                       # prefill logits
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    engine.scheduler.complete_pass = complete
    pipe = engine.decode_pipeline(uids)
    toks = []
    for rung in engine.attn_split_ladder:                   # one step at each rung
        engine.attn_rung_override = rung
        toks.append(pipe.run(1)[:, 0])
        engine._materialize(uids)
        got.append(np.stack([engine._last_logits[u] for u in uids]))
    engine.attn_rung_override = None
    nxt = np.argmax(got[-1], axis=-1).astype(np.int32)
    lg = engine.put(uids + [14], [nxt[i:i + 1] for i in range(4)]
                    + [rng.randint(0, V, 300).astype(np.int32)])
    torch.cuda.synchronize()
    launches = {k: LAUNCHES.get(k, 0) for k in Q_KERNELS}
    rungs = dict(engine.attn_stats.rungs)
    toks.append(nxt)
    got.append(lg[:4])
    print("main-path launches " + json.dumps(launches), flush=True)
    print("attn_stats rungs " + json.dumps({"generate": gen_rungs, "main_path": rungs}),
          flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    unserved = [r for r in engine.attn_split_ladder if not rungs.get(r)]
    if unserved:
        raise AssertionError(f"rungs that served no step: {unserved}")
    if lg.shape != (5, V) or not np.isfinite(lg).all():
        raise AssertionError("put() logits malformed")

    # ---- logits against the dense fp32 forward, layer by layer ---- #
    e_eng, e_dense, m_eng, m_dense = [], [], 0.0, 0.0
    for i, p in enumerate(prompts):
        seq = torch.from_numpy(np.concatenate([p] + [t[i:i + 1] for t in toks])).long().cuda()
        rows = torch.arange(len(p) - 1, len(p) + len(toks), device="cuda")
        nf = n_full.get(uids[i], 0)
        ref32 = dense_quant_logits(engine, cfg, seq, rows, torch.float32, nf)
        ref16 = dense_quant_logits(engine, cfg, seq, rows, torch.bfloat16, nf)
        eng = torch.from_numpy(np.stack([g_[i] for g_ in got])).cuda()
        if not torch.isfinite(eng).all():
            raise AssertionError("engine logits are not finite")
        d_eng, d_dense = eng - ref32, ref16 - ref32
        e_eng.append(float(d_eng.pow(2).mean()))
        e_dense.append(float(d_dense.pow(2).mean()))
        m_eng = max(m_eng, float(d_eng.abs().max()))
        m_dense = max(m_dense, float(d_dense.abs().max()))
        del ref32, ref16
    rms_eng, rms_dense = float(np.sqrt(np.mean(e_eng))), float(np.sqrt(np.mean(e_dense)))
    limit = 2 * rms_dense
    print(f"prefill-from-zero rows per prompt: {[n_full.get(u, 0) for u in uids]}",
          flush=True)
    print(f"logits vs dense fp32 over the int8 weights and pool values (prefill + "
          f"{len(toks)} decode steps x 4 prompts): engine rms {rms_eng:.5f} max {m_eng:.4f}; "
          f"dense bf16 rms {rms_dense:.5f} max {m_dense:.4f}; limit rms <= {limit:.5f}",
          flush=True)
    if not rms_eng <= limit:
        raise AssertionError(f"engine logits error {rms_eng} > 2 x dense bf16 {rms_dense}")

    # ---- rung invariance and quantize-on-write, on one live step ---- #
    db = engine.scheduler.decode_batch(uids, 2, engine.scratch_block)
    ids = engine._sample_device_padded(uids, False, 1.0, 0)
    bt = to_device(db.block_tables, engine.device)
    pos = to_device(db.positions, engine.device)
    step = {}
    for rung in reversed(engine.attn_split_ladder):         # rung 1 writes last
        _, lg_r = engine._step_rungs[rung](engine.weights, engine.kv.kv, ids, pos, bt,
                                           pos + 1, kv_scales=engine.kv.scales)
        step[rung] = lg_r[:4].float()
    diffs = {r: float((step[r] - step[1]).pow(2).mean().sqrt()) for r in step}
    agree = {r: float((step[r].argmax(-1) == step[1].argmax(-1)).float().mean())
             for r in step}
    print("rung invariance " + json.dumps({"rms_vs_rung1": diffs, "limit": limit,
                                           "greedy_agreement_vs_rung1": agree}), flush=True)
    bad = {r: d for r, d in diffs.items() if not d <= limit}
    if bad:
        raise AssertionError(f"rungs {bad} differ from rung 1 by more than {limit}")
    bs = engine.kv.config.block_size
    p_ = db.positions[:4].astype(np.int64)
    page = torch.from_numpy(db.block_tables[np.arange(4), p_ // bs].astype(np.int64)).cuda()
    slot = torch.from_numpy(p_ % bs).cuda()

    def written():
        """Each sequence's slot at the step position: values [4, L, 2, Hkv,
        D] and scales [4, L, 2 * Hkv] (flat tile index kv*Hkv*bs + h*bs + t)."""
        kv = engine.kv.kv[:, page, :, :, slot]
        L = engine.kv.scales.shape[0]
        tiles = engine.kv.scales[:, page].transpose(0, 1).reshape(4, L, -1)
        idx = torch.arange(2 * engine.spec.num_kv_heads, device="cuda")[None] * bs \
            + slot[:, None]
        return kv.clone(), tiles.gather(2, idx[:, None, :].expand(4, L, -1))

    kv_step, sc_step = written()
    engine.put(uids, [np.asarray(ids[i:i + 1].cpu().numpy(), np.int32) for i in range(4)])
    kv_pass, sc_pass = written()
    same0 = bool(torch.equal(kv_step[:, 0], kv_pass[:, 0])
                 and torch.equal(sc_step[:, 0], sc_pass[:, 0]))
    share = float((kv_step == kv_pass).float().mean())
    print("quantize-on-write " + json.dumps({
        "layer0_bytes_equal": same0, "all_layers_equal_byte_share": share}), flush=True)
    if not same0:
        raise AssertionError("the decode step and the ragged pass wrote different bytes "
                             "for the same token at layer 0")

    # ---- rates and where the time goes ---- #
    pipe = engine.decode_pipeline(uids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(16)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    n_prompt = sum(len(p) for p in prompts)
    print(f"generate() 4 prompts x 32 tokens in {t_gen:.2f} s; prefill {n_prompt} tokens in "
          f"{t_prefill * 1e3:.1f} ms = {n_prompt / t_prefill:.1f} tok/s; decode 4 x 16 tokens "
          f"at rung {engine._attn_rung()} in {t_decode * 1e3:.1f} ms = "
          f"{64 / t_decode:.1f} tok/s ({t_decode / 16 * 1e3:.2f} ms/step)", flush=True)
    prof = device_breakdown("13B decode step (4 seqs, int8, rung 8)", lambda: pipe.run(1),
                            Q_NAMES)
    launches.update(run_bursts_13b(engine, uids, {"wall_ms": t_decode / 16 * 1e3,
                                                  "device_ms": prof["device_ms"]}))
    engine.flush(uids + [14])
    device_breakdown("13B prefill pass (736 tokens, int8)", lambda: engine.put(
        [20], [rng.randint(0, V, 736).astype(np.int32)]), Q_NAMES)
    engine.flush([20])
    print(f"phase 6: peak device memory {gib(torch.cuda.max_memory_allocated()):.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


B_KERNELS_13B = ("paged_decode_int8_side", "paged_splitk_int8_side/2",
                 "paged_splitk_int8_side/4", "paged_splitk_int8_side/8")


def run_bursts_13b(engine, uids, pipe_step):
    """Phase 6's bursts: one greedy burst pair at each pinned rung 1/2/4/8
    over the int8 pages (f32 slab), then a page handoff of packed uint8
    rows. Returns the side kernels' launch counts over the bursts."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    reset_launches()
    engine.attn_stats.reset()
    for rung in engine.attn_split_ladder:
        engine.attn_rung_override = rung
        burst_line(f"13B int8 burst rung {rung}", engine, uids, BURST, pipe_step, B_NAMES,
                   profiled_steps=BURST_PROFILED)
    engine.attn_rung_override = None
    torch.cuda.synchronize()
    launches = {k: LAUNCHES.get(k, 0) for k in B_KERNELS_13B}
    print("burst launches " + json.dumps({"launches": launches,
                                          "rungs": dict(engine.attn_stats.rungs)}), flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the bursts: {missing}")
    # the handoff: the port's scheduler keeps a sequence's token count, not
    # its ids, so the history handed to import_kv is that many placeholders
    u = uids[-1]
    n_seen = engine.scheduler.seqs[u].seen_tokens
    pages, lg = engine.export_kv(u)
    ids = engine.import_kv(u, np.zeros(n_seen, np.int32), pages, lg)
    spec_shape, spec_dtype = engine.page_payload_spec
    equal = bool((engine.fetch_pages(ids) == pages).all())
    print("page handoff " + json.dumps({
        "payload": [list(pages.shape), str(pages.dtype)],
        "page_payload_spec": [list(spec_shape), np.dtype(spec_dtype).name],
        "bytes_per_block": engine.kv.config.bytes_per_block(), "imported_bytes_equal": equal}),
        flush=True)
    if not equal or pages.dtype != np.uint8 or tuple(pages.shape[1:]) != spec_shape:
        raise AssertionError("the packed int8 page handoff is not byte-exact")
    return launches


# --------------------------------------------------------------------------- #
# phase 7: block-sparse attention (K9) through sparse_self_attention
# --------------------------------------------------------------------------- #

K9_NAMES = ("block_sparse_fwd", "block_sparse_dq", "block_sparse_dkv")
SPARSE_B, SPARSE_H = 2, 16      # BERT-large's attention: 16 heads of D = 64


def sparse_cases():
    """(label, config, S, D, timed): the three layouts at S = 4096, D = 64
    (A, DeepSpeed's documented fixed config, is the kernel table's row),
    then two untimed ragged shapes at D = 128 (no 64-tile divides S)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                          FixedSparsityConfig)
    H = SPARSE_H
    return [
        ("A fixed bidirectional, per head, 4 global patterns",
         FixedSparsityConfig(num_heads=H, block=16, different_layout_per_head=True,
                             num_local_blocks=4, num_global_blocks=1,
                             attention="bidirectional", num_different_global_patterns=4),
         4096, 64, True),
        ("B fixed unidirectional (causal)",
         FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=4, num_global_blocks=1,
                             attention="unidirectional"), 4096, 64, True),
        ("C BigBird defaults", BigBirdSparsityConfig(num_heads=H, block=16), 4096, 64, True),
        ("S=1040 block 16, fixed per head", FixedSparsityConfig(
            num_heads=H, block=16, different_layout_per_head=True,
            num_different_global_patterns=4), 1040, 128, False),
        ("S=1056 block 32, BigBird unidirectional", BigBirdSparsityConfig(
            num_heads=H, block=32, attention="unidirectional"), 1056, 128, False),
    ]


def head_masks(tables, H: int):
    """[H, S, S] bool: the pairs each of the H heads sees (head h reads
    layout head h % Hl)."""
    import torch
    return tables.token_mask("cuda")[torch.arange(H, device="cuda") % tables.num_layout_heads]


def check_sparse_kernels(label, cfg, S, D, timed, randn, record):
    """K9's three kernels against their plain versions (the backward ones
    fed the kernel forward's o and lse); timed for the S = 4096 layouts,
    with SDPA over the boolean token mask as the library yardstick."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from deepspeed_tpu_torch.ops.kernels import (
        block_sparse_delta, block_sparse_dkv, block_sparse_dkv_plain, block_sparse_dq,
        block_sparse_dq_plain, block_sparse_fwd, block_sparse_fwd_plain, get_tables)
    B, H = SPARSE_B, SPARSE_H
    causal = cfg.attention == "unidirectional"
    layout = cfg.make_layout(S)
    tables = get_tables(layout, cfg.block, causal, S, "cuda")
    scale = D ** -0.5
    q, k, v, do = (randn(B, H, S, D) for _ in range(4))
    o, lse = block_sparse_fwd(q, k, v, tables, scale)
    o_ref, lse_ref = block_sparse_fwd_plain(q, k, v, tables, scale)
    delta = block_sparse_delta(o, do)
    dq = block_sparse_dq(q, k, v, do, lse, delta, tables, scale)
    dq_ref = block_sparse_dq_plain(q, k, v, do, lse, delta, tables, scale)
    dk, dv = block_sparse_dkv(q, k, v, do, lse, delta, tables, scale)
    dk_ref, dv_ref = block_sparse_dkv_plain(q, k, v, do, lse, delta, tables, scale)
    torch.cuda.synchronize()
    mask = head_masks(tables, H)
    pairs = B * int(mask.sum())
    shares = {"layout": label, "S": S, "D": D, "block": cfg.block,
              "layout_heads": tables.num_layout_heads,
              "active_16_block_share": float(np.kron(
                  layout, np.ones((cfg.block // 16,) * 2, layout.dtype)).mean()),
              "active_64_tile_share": tables.active_tiles / (
                  tables.num_layout_heads * tables.num_tiles ** 2),
              "visible_pairs": pairs, "visible_pair_share": pairs / (B * H * S * S)}
    print("sparse-layout " + json.dumps(shares), flush=True)
    case = f"{label}: B={B} H={H} S={S} D={D}"
    extra = ({}, {}, {})
    if timed:
        x, stats = B * H * S * D * 2, B * H * S * 4     # one [B,H,S,D] bf16; lse
        bounds = [bound(4 * x + stats, 4 * D * pairs),
                  bound(5 * x + 2 * stats, 6 * D * pairs),
                  bound(6 * x + 2 * stats, 8 * D * pairs)]
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_f = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[None]))
            # the backward alone, on one forward's retained graph
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask[None])
            lib_b = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                                        retain_graph=True))
        del out
        covers = ("SDPA (efficient backend, bool token mask) backward alone: dq, dk and dv "
                  "together")
        extra = (
            dict(ms=time_ms(lambda: block_sparse_fwd(q, k, v, tables, scale), 10),
                 plain_ms=time_ms(lambda: block_sparse_fwd_plain(q, k, v, tables, scale),
                                  3, 1), library_ms=lib_f),
            dict(ms=time_ms(lambda: block_sparse_dq(q, k, v, do, lse, delta, tables, scale),
                            10),
                 plain_ms=time_ms(lambda: block_sparse_dq_plain(
                     q, k, v, do, lse, delta, tables, scale), 3, 1),
                 library_ms=lib_b, library_covers=covers),
            dict(ms=time_ms(lambda: block_sparse_dkv(q, k, v, do, lse, delta, tables, scale),
                            10),
                 plain_ms=time_ms(lambda: block_sparse_dkv_plain(
                     q, k, v, do, lse, delta, tables, scale), 3, 1),
                 library_ms=lib_b, library_covers=covers))
        for e, (b_ms, b_by) in zip(extra, bounds):
            e.update(bound_ms=b_ms, bound_by=b_by)
        print("sparse-library " + json.dumps({"layout": label, "sdpa_fwd_ms": lib_f,
                                              "sdpa_bwd_ms": lib_b}), flush=True)
    row = label.startswith("A ")
    record("block_sparse_fwd", case, err((o, o_ref), (lse[..., None], lse_ref[..., None])),
           row=row, **extra[0])
    record("block_sparse_dq", case, err((dq, dq_ref)), row=row, **extra[1])
    record("block_sparse_dkv", case, err((dk, dk_ref), (dv, dv_ref)), row=row, **extra[2])
    return q, k, v, do


def check_op(case, op, plain_bf16, exact, names=("o", "dq", "dk", "dv"),
             label="sparse_self_attention (autograd)"):
    """The op's (o, dq, dk, dv, ...) against its plain route in f32: for each
    tensor, the worst error share of the row scale (``err``) may be the
    kernel rule's 2^-6 or, where bf16 arithmetic itself cannot do that
    well, twice the plain route's own share in bf16. Rows of dk and dv for
    keys few queries see, and rows whose dp - delta cancels, are where a
    bf16 backward loses digits whatever the kernel does."""
    shares = []
    for name, a, b, ref in zip(names, op, plain_bf16, exact):
        e_op = err((a, ref))["max_err_over_rowmax"]
        e_bf = err((b, ref))["max_err_over_rowmax"]
        limit = max(KERNEL_RTOL, 2 * e_bf)
        shares.append({"tensor": name, "op_share": e_op, "plain_bf16_share": e_bf,
                       "limit": limit, "ok": e_op <= limit})
    print("op-check " + json.dumps({"op": label, "case": case,
                                    "vs": "plain route in f32", "tensors": shares}),
          flush=True)
    bad = [x for x in shares if not x["ok"]]
    if bad:
        raise AssertionError(f"{label} {case}: {bad}")


def run_sparse(rows):
    """Phase 7: the kernel checks, then the main path (one forward and one
    backward of ``sparse_self_attention`` per layout, each launching every
    K9 kernel once), held against the op's plain route (``check_op``);
    then the op's times at the S = 4096 layouts."""
    import torch
    from deepspeed_tpu_torch.ops import sparse_self_attention
    from deepspeed_tpu_torch.ops.kernels import (LAUNCHES, block_sparse_bwd_plain,
                                                 block_sparse_fwd_plain, get_tables,
                                                 reset_launches)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(4321)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    record = functools.partial(record_check, rows)
    cases = sparse_cases()
    inputs = [check_sparse_kernels(*c, randn, record) for c in cases]
    torch.cuda.empty_cache()

    # ---- the main path: the op's entry point, forward and backward ---- #
    torch.cuda.synchronize()
    reset_launches()
    for (label, cfg, S, D, _), (q, k, v, do) in zip(cases, inputs):
        before = {n: LAUNCHES[n] for n in K9_NAMES}
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        out = sparse_self_attention(qg, kg, vg, cfg)
        out.backward(do)
        torch.cuda.synchronize()
        per_call = {n: LAUNCHES[n] - before[n] for n in K9_NAMES}
        if per_call != {n: 1 for n in K9_NAMES}:
            raise AssertionError(f"{label}: one op call launched {per_call}, "
                                 "expected one of each K9 kernel")
        if out.shape != q.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: the op's output is malformed")
        # the same op on the plain route, in bf16 and in f32 from the same
        # bf16 values; the op is held to the f32 route
        tables = get_tables(cfg.make_layout(S), cfg.block, cfg.attention == "unidirectional",
                            S, "cuda")
        routes = {}
        for name, ins in (("bf16", (q, k, v, do)),
                          ("f32", tuple(t.float() for t in (q, k, v, do)))):
            o_p, lse_p = block_sparse_fwd_plain(*ins[:3], tables, D ** -0.5)
            routes[name] = (o_p, *block_sparse_bwd_plain(*ins[:3], o_p, lse_p, ins[3], tables,
                                                         D ** -0.5))
        check_op(f"{label}: S={S} D={D}",
                 (out.detach(), qg.grad, kg.grad, vg.grad), routes["bf16"], routes["f32"])
        del routes, o_p, lse_p
        del out, qg, kg, vg
    torch.cuda.synchronize()
    launches = {n: LAUNCHES[n] for n in K9_NAMES}
    print("main-path launches " + json.dumps(launches), flush=True)
    torch.cuda.empty_cache()

    # ---- the op's times (host layout build and table lookup included) ---- #
    for (label, cfg, S, D, timed), (q, k, v, do) in zip(cases, inputs):
        if not timed:
            continue
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

        def fwd_bwd():
            sparse_self_attention(qg, kg, vg, cfg).backward(do)

        print("sparse-op " + json.dumps({
            "layout": label,
            "op_fwd_ms": time_ms(lambda: sparse_self_attention(q, k, v, cfg), 10),
            "op_fwd_bwd_ms": time_ms(fwd_bwd, 10),
            "make_layout_ms": time_ms(lambda: cfg.make_layout(S), 3, 1)}), flush=True)
        if label.startswith("A "):
            # three calls: the profiler has dropped the window's first kernel
            device_breakdown(f"sparse_self_attention fwd+bwd x 3, {label}",
                             lambda: [fwd_bwd() for _ in range(3)], K9_NAMES)
    print(f"phase 7: peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB; {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 8: Evoformer pair-bias attention (K10) through DS4Sci_EvoformerAttention
# --------------------------------------------------------------------------- #

K10_NAMES = ("evoformer_fwd", "evoformer_dq", "evoformer_dkv", "evoformer_dbias")
# AlphaFold 2's fine-tuning Evoformer (Jumper et al. 2021, Supplementary
# Algorithms 7, 13 and 14 and the training-stage table; OpenFold's
# model.evoformer_stack): a crop of 384 residues, 512 MSA clusters, batch 1;
# MSA row attention 8 heads x 32 (c_m = 256), triangle attention 4 heads x
# 32 (c_z = 128)
EVO_RES, EVO_CLUST, EVO_D = 384, 512, 32
EVO_MSA_H, EVO_TRI_H = 8, 4


def keep_mask(g, shape, full_row):
    """[.., S] float 1 = keep, 0 = masked: about 3% of keys masked at
    random, and every key of the row ``full_row`` (a leading index)."""
    import torch
    keep = (torch.rand(*shape, generator=g, device="cuda") > 0.03).float()
    keep[full_row] = 0.0
    return keep


def evo_routes(q, k, v, mask, pair, do, R):
    """The op's plain route (forward and backward plain versions) in bf16
    and in f32 from the same bf16 values: (o, dq, dk, dv, dpair) each."""
    from deepspeed_tpu_torch.ops.kernels import evoformer_bwd_plain, evoformer_fwd_plain
    scale = q.shape[-1] ** -0.5
    routes = {}
    for name, conv in (("bf16", lambda t: t), ("f32", lambda t: t.float())):
        ins = [None if t is None else conv(t) for t in (q, k, v, mask, pair, do)]
        o, lse = evoformer_fwd_plain(*ins[:5], scale, R)
        routes[name] = (o, *evoformer_bwd_plain(*ins[:5], o, lse, ins[5], scale, R))
    return routes


def check_evo_kernels(label, L, S, H, D, R, pair_dtype, timed, randn, g, record):
    """K10's four kernels against their plain versions (the backward ones
    fed the kernel forward's o and lse) on [L, S, H, D] rows with a mask
    (3% of keys, and row 1's every key) and a pair bias [L / R, H, S, S];
    timed at the MSA row shape, with SDPA over the float bias as the
    library yardstick. Returns the inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from deepspeed_tpu_torch.ops.kernels import (
        evoformer_dbias, evoformer_dbias_plain, evoformer_delta, evoformer_dkv,
        evoformer_dkv_plain, evoformer_dq, evoformer_dq_plain, evoformer_fwd,
        evoformer_fwd_plain)
    G = L // R
    scale = D ** -0.5
    q, k, v, do = (randn(L, S, H, D) for _ in range(4))
    pair = randn(G, H, S, S).to(pair_dtype)
    mask = torch.where(keep_mask(g, (L, S), 1) > 0, 0.0, -1e9)
    o, lse = evoformer_fwd(q, k, v, mask, pair, scale, R)
    o_ref, lse_ref = evoformer_fwd_plain(q, k, v, mask, pair, scale, R)
    delta = evoformer_delta(o, do)
    args = (q, k, v, mask, pair, do, lse, delta, scale, R)
    dq, dq_ref = evoformer_dq(*args), evoformer_dq_plain(*args)
    (dk, dv), (dk_ref, dv_ref) = evoformer_dkv(*args), evoformer_dkv_plain(*args)
    dpair, dpair_ref = evoformer_dbias(*args), evoformer_dbias_plain(*args)
    torch.cuda.synchronize()
    case = f"{label}: L={L} S={S} H={H} D={D} R={R} pair {str(pair_dtype)[6:]}"
    extra = ({}, {}, {}, {})
    if timed:
        pairs = L * H * S * S
        x, stats = L * S * H * D * 2, L * H * S * 4     # one [L,S,H,D] bf16; lse
        biases = L * S * 4 + pair.numel() * pair.element_size()   # mask + pair read once
        bounds = [bound(4 * x + stats + biases, 4 * D * pairs),
                  bound(5 * x + 2 * stats + biases, 6 * D * pairs),
                  bound(6 * x + 2 * stats + biases, 8 * D * pairs),
                  bound(4 * x + 2 * stats + biases + pair.numel() * pair.element_size(),
                        4 * D * pairs)]
        # the yardstick: SDPA on [L, H, S, D] views with the bias mask[l] +
        # pair[l // R] materialised as one [L, H, S, S] bf16 tensor (the
        # efficient backend takes no broadcast of two biases); the backward
        # includes the bias gradient's reduction to d(pair)
        bhsd = lambda t: t.transpose(1, 2)
        mask_bf = mask.to(torch.bfloat16).view(G, R, 1, 1, S)
        bias = (pair.to(torch.bfloat16)[:, None] + mask_bf).view(L, H, S, S)
        qg, kg, vg = (bhsd(t).detach().requires_grad_() for t in (q, k, v))
        pg = pair.to(torch.bfloat16).detach().requires_grad_()

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            lib_f = time_ms(lambda: F.scaled_dot_product_attention(
                bhsd(q), bhsd(k), bhsd(v), attn_mask=bias), 10, 2)
            # the backward alone, on one forward's retained graph
            out = F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=(pg[:, None] + mask_bf).view(L, H, S, S))
            lib_b = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg, pg), bhsd(do),
                                                        retain_graph=True), 5, 1)
        covers = ("SDPA (efficient backend, float bias [L, H, S, S] bf16) backward alone: dq, "
                  "dk, dv and d(bias) together, with the bias's reduction to d(pair)")
        del bias, qg, kg, vg, pg, out
        extra = (
            dict(ms=time_ms(lambda: evoformer_fwd(q, k, v, mask, pair, scale, R), 10, 2),
                 plain_ms=time_ms(lambda: evoformer_fwd_plain(q, k, v, mask, pair, scale, R),
                                  3, 1),
                 library_ms=lib_f,
                 library_covers="SDPA (efficient backend, float bias [L, H, S, S] bf16) "
                                "forward"),
            dict(ms=time_ms(lambda: evoformer_dq(*args), 10, 2),
                 plain_ms=time_ms(lambda: evoformer_dq_plain(*args), 3, 1),
                 library_ms=lib_b, library_covers=covers),
            dict(ms=time_ms(lambda: evoformer_dkv(*args), 10, 2),
                 plain_ms=time_ms(lambda: evoformer_dkv_plain(*args), 3, 1),
                 library_ms=lib_b, library_covers=covers),
            dict(ms=time_ms(lambda: evoformer_dbias(*args), 10, 2),
                 plain_ms=time_ms(lambda: evoformer_dbias_plain(*args), 3, 1),
                 library_ms=lib_b, library_covers=covers))
        for e, (b_ms, b_by) in zip(extra, bounds):
            e.update(bound_ms=b_ms, bound_by=b_by)
        print("evoformer-library " + json.dumps({"case": case, "sdpa_fwd_ms": lib_f,
                                                    "sdpa_bwd_ms": lib_b}), flush=True)
    record("evoformer_fwd", case, err((o, o_ref), (lse[..., None], lse_ref[..., None])),
           row=timed, **extra[0])
    record("evoformer_dq", case, err((dq, dq_ref)), row=timed, **extra[1])
    record("evoformer_dkv", case, err((dk, dk_ref), (dv, dv_ref)), row=timed, **extra[2])
    # d(pair)'s rows are rows of its [S, S] tiles
    record("evoformer_dbias", case, err((dpair, dpair_ref)), row=timed, **extra[3])
    return q, k, v, do, pair


def evo_call(label, fn, grads_of, do, fold, routes_args, R, shape):
    """One op call on the main path: forward and backward through ``fn``,
    one launch of each K10 kernel, a finite output of ``shape``, and the
    output and gradients (``fold`` maps each to the kernels' [L, S, H, D] or
    [G, H, S, S] frame) held to the plain route in f32."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES
    before = {n: LAUNCHES[n] for n in K10_NAMES}
    out = fn()
    out.backward(do)
    torch.cuda.synchronize()
    per_call = {n: LAUNCHES[n] - before[n] for n in K10_NAMES}
    if per_call != {n: 1 for n in K10_NAMES}:
        raise AssertionError(f"{label}: one op call launched {per_call}, "
                             "expected one of each K10 kernel")
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: the op's output is malformed")
    routes = evo_routes(*routes_args, R)
    op = [fold[0](out.detach())] + [f(t.grad) for f, t in zip(fold[1:], grads_of)]
    check_op(label, op, routes["bf16"], routes["f32"],
             names=("o", "dq", "dk", "dv", "dpair"), label="evoformer attention (autograd)")


def run_evoformer(rows):
    """Phase 8: the kernel checks, then the main path at AlphaFold 2's
    widths (MSA row attention through ``DS4Sci_EvoformerAttention`` with
    ``fused=True`` and both biases, and with ``fused=None`` and the pair
    bias alone; both triangle attentions; each launching every K10 kernel
    once per call, held against the op's plain route; ``msa_col_attention``
    once, plain torch); then the op's times."""
    import torch
    from deepspeed_tpu_torch.ops import (DS4Sci_EvoformerAttention, msa_col_attention,
                                         msa_row_attention_mask_bias,
                                         triangle_attention_ending_node,
                                         triangle_attention_starting_node)
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from deepspeed_tpu_torch.ops.kernels.evoformer_attention import _mask_to_bias
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(8765)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    record = functools.partial(record_check, rows)
    Nr, Nc, D, Hm, Ht = EVO_RES, EVO_CLUST, EVO_D, EVO_MSA_H, EVO_TRI_H
    q, k, v, do, pair = check_evo_kernels("MSA row attention", Nc, Nr, Hm, D, Nc,
                                          torch.bfloat16, True, randn, g, record)
    for d in (16, 64):
        check_evo_kernels("ragged S, f32 pair", 8, 300, 4, d, 4, torch.float32, False,
                          randn, g, record)
    torch.cuda.empty_cache()

    # ---- the main path: the entry points, forward and backward ---- #
    B, msa_shape = 1, (1, Nc, Nr, Hm, D)
    msa_mask = keep_mask(g, (B, Nc, Nr), (0, 1))
    bias1 = msa_row_attention_mask_bias(msa_mask)                 # [1, N, 1, 1, S]
    Q, K, V, dO = (t.view(msa_shape) for t in (q, k, v, do))
    fold_msa = lambda t: t.reshape(Nc, Nr, Hm, D)
    fold_pair = lambda t: t.reshape(B, Hm, Nr, Nr)
    z_q, z_k, z_v, dz = (randn(B, Nr, Nr, Ht, D) for _ in range(4))
    tri_pair = randn(B, Ht, Nr, Nr)
    pair_mask = keep_mask(g, (B, Nr, Nr), (0, 1))
    fold_start = lambda t: t.reshape(Nr, Nr, Ht, D)
    fold_end = lambda t: t.transpose(1, 2).reshape(Nr, Nr, Ht, D)
    torch.cuda.synchronize()
    reset_launches()
    for label, fused, b1 in (("MSA row, fused=True, mask + pair bias", True, bias1),
                             ("MSA row, fused=None, pair bias only", None, None)):
        Qg, Kg, Vg = (t.detach().clone().requires_grad_() for t in (Q, K, V))
        b2 = pair.view(B, 1, Hm, Nr, Nr).detach().clone().requires_grad_()
        evo_call(label, lambda: DS4Sci_EvoformerAttention(Qg, Kg, Vg, [b1, b2], fused=fused),
                 (Qg, Kg, Vg, b2), dO, (fold_msa,) * 4 + (fold_pair,),
                 (q, k, v, None if b1 is None else b1.reshape(Nc, Nr), pair, do), Nc,
                 msa_shape)
        del Qg, Kg, Vg, b2
    for label, fn, fold in (("triangle, starting node", triangle_attention_starting_node,
                             fold_start),
                            ("triangle, ending node", triangle_attention_ending_node,
                             fold_end)):
        zq, zk, zv = (t.detach().clone().requires_grad_() for t in (z_q, z_k, z_v))
        pb = tri_pair.detach().clone().requires_grad_()
        pm = pair_mask if fold is fold_start else pair_mask.transpose(1, 2)
        evo_call(label, lambda: fn(zq, zk, zv, pb, pair_mask), (zq, zk, zv, pb), dz,
                 (fold,) * 4 + (lambda t: t,),
                 (fold(z_q), fold(z_k), fold(z_v), _mask_to_bias(pm).reshape(Nr, Nr),
                  tri_pair, fold(dz)), Nr, (B, Nr, Nr, Ht, D))
        del zq, zk, zv, pb
    # MSA column attention: plain torch (as the JAX package), no kernel
    before = dict(LAUNCHES)
    col = msa_col_attention(Q, K, V, msa_mask)
    torch.cuda.synchronize()
    if dict(LAUNCHES) != before or tuple(col.shape) != msa_shape \
            or not bool(torch.isfinite(col).all()):
        raise AssertionError("msa_col_attention: launched a kernel or gave a malformed output")
    del col
    launches = {n: LAUNCHES[n] for n in K10_NAMES}
    print("main-path launches " + json.dumps(launches), flush=True)
    torch.cuda.empty_cache()

    # ---- the op's times ---- #
    Qg, Kg, Vg = (t.detach().clone().requires_grad_() for t in (Q, K, V))
    b2 = pair.view(B, 1, Hm, Nr, Nr).detach().clone().requires_grad_()
    zq, zk, zv = (t.detach().clone().requires_grad_() for t in (z_q, z_k, z_v))
    pb = tri_pair.detach().clone().requires_grad_()
    msa = lambda: DS4Sci_EvoformerAttention(Qg, Kg, Vg, [bias1, b2], fused=True)
    tri = lambda: triangle_attention_starting_node(zq, zk, zv, pb, pair_mask)

    def msa_fwd_bwd():
        torch.autograd.grad(msa(), (Qg, Kg, Vg, b2), dO)

    def tri_fwd_bwd():
        torch.autograd.grad(tri(), (zq, zk, zv, pb), dz)

    print("evoformer-op " + json.dumps({
        "msa_row_fwd_ms": time_ms(msa, 5, 1), "msa_row_fwd_bwd_ms": time_ms(msa_fwd_bwd, 5, 1),
        "triangle_start_fwd_ms": time_ms(tri, 5, 1),
        "triangle_start_fwd_bwd_ms": time_ms(tri_fwd_bwd, 5, 1)}), flush=True)
    device_breakdown("DS4Sci_EvoformerAttention MSA row fwd+bwd x 3",
                     lambda: [msa_fwd_bwd() for _ in range(3)], K10_NAMES)
    print(f"phase 8: peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB; {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 9: sliding-window serving of Mistral-7B
# --------------------------------------------------------------------------- #

W_KERNELS = ("flash_packed_window", "paged_chunk_window", "paged_decode_window",
             "paged_splitk_window/2", "paged_splitk_window/4", "splitk_merge")
W_NAMES = ("flash_packed", "paged_chunk", "paged_decode", "paged_splitk", "splitk_merge")
W_SIDE_KERNELS = ("paged_splitk_side_window/4", "paged_decode_side_window")
# chunk budget 8224 - 32 = 8192 tokens: a windowed sequence takes at most
# window + block = 4224 tokens a pass, so the page ring is 66 pages
ENGINE_MISTRAL = {"kv_cache": {"block_size": 128, "num_blocks": 160},
                  "state_manager": {"max_ragged_sequence_count": 32,
                                    "max_ragged_batch_size": 8224, "max_context": 16384},
                  "attention": {"decode_splits": 4}, "seed": 0}
# prompts (the 12000-token one reaches W_CTXS[0] = 12032 tokens at the ring
# check), the oracle's self-check length and the profiled prefill pass
W_PROMPTS, W_ORACLE_T, W_PREFILL = (12000, 5000, 2000, 300), 4600, 4224


def dense_window_logits(weights, cfg, ids, rows, dt, q_block: int = 1024,
                        kv_pool: bool = False, n_full: int = 0):
    """The dense causal forward with the sliding window over one token
    sequence ``ids`` [T] in ``dt``, from the engine's weights (each cast as
    its matmul runs, so no second copy of the model exists; a quantized
    weight goes through ``_mm``'s function, plain: unpacked, f32 sum,
    column scale): each block of ``q_block`` query rows attends only the
    keys its window reaches, so no [T, T] score tensor exists. With
    ``kv_pool`` attention reads K and V at the values an int8 page stores
    (``kv_write_dequant``), except for the first ``n_full`` positions,
    which a prefill-from-zero pass attends at full precision (phase 6's
    rule). Returns f32 logits at positions ``rows``."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.models.llama import apply_rope, rms_norm, rope_tables, window_mask
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_write_dequant
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul_plain
    from deepspeed_tpu_torch.ops.quantizer import unpack_int4
    W = weights
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps, win = cfg.rms_norm_eps, cfg.sliding_window
    T = ids.shape[0]
    pos = torch.arange(T, device=ids.device)
    cos, sin = rope_tables(pos, D, cfg.rope_theta)

    def mm(x, w):
        if isinstance(w, dict):
            return quantized_matmul_plain(x, unpack_int4(w["w4"]) if "w4" in w else w["w8"],
                                          w["scale"])
        return x @ w.to(dt)

    def attend(q, k, v):
        out = torch.empty_like(q)
        n = q.shape[0]
        for a in range(0, n, q_block):
            b = min(n, a + q_block)
            lo = max(0, a - win + 1)
            kk, vv = (t[lo:b].repeat_interleave(H // Hkv, dim=1) for t in (k, v))
            s = torch.einsum("qhd,khd->hqk", q[a:b], kk).float() * D ** -0.5
            s.masked_fill_(~window_mask(pos[None, a:b], pos[None, lo:b], win),
                           torch.finfo(torch.float32).min)
            out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1).to(dt), vv)
            del s
        return out

    x = W["embed"][ids].to(dt)
    for w in W["layers"]:
        h = rms_norm(x, w["ln1"], eps, dt)
        q = apply_rope(mm(h, w["wq"]).view(T, H, D), cos, sin)
        k = apply_rope(mm(h, w["wk"]).view(T, Hkv, D), cos, sin)
        v = mm(h, w["wv"]).view(T, Hkv, D)
        if kv_pool:
            o = attend(q, kv_write_dequant(k).to(dt), kv_write_dequant(v).to(dt))
            if n_full:
                o[:n_full] = attend(q[:n_full], k[:n_full], v[:n_full])
        else:
            o = attend(q, k, v)
        x = x + mm(o.reshape(T, H * D), w["wo"])
        h = rms_norm(x, w["ln2"], eps, dt)
        x = x + mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])
    x = rms_norm(x[rows], W["final_norm"], eps, dt)
    return mm(x, W["lm_head"]).float()


def run_mistral():
    """Phase 9: Mistral-7B at full width and depth (32 layers, GQA 32/8,
    window 4096), random bf16 weights from seed 0, served with its sliding
    window through the page ring and the split ladder up to 4. Returns the
    main path's launch counts of the windowed kernels."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.ragged_model import multistep_schedule
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = lambda b: b / 2 ** 30
    cfg = LlamaConfig.mistral_7b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    engine = InferenceEngineV2(model, ENGINE_MISTRAL, model.flat_params())
    sched = engine.scheduler
    torch.cuda.synchronize()
    nb = ENGINE_MISTRAL["kv_cache"]["num_blocks"]
    print(f"model: Mistral-7B (LlamaConfig.mistral_7b: vocab {cfg.vocab_size}, hidden "
          f"{cfg.hidden_size}, FFN {cfg.intermediate_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads over {cfg.num_key_value_heads} KV heads, head_dim "
          f"{cfg.head_dim}, rope_theta {cfg.rope_theta:g}, sliding_window "
          f"{cfg.sliding_window}), random bf16 weights (seed 0); pool {nb} pages; spec.window "
          f"{engine.spec.window}, take cap {sched._pass_take_cap}, ring {sched.ring_pages} "
          f"pages, ladder {engine.attn_split_ladder}; build {time.perf_counter() - t0:.1f} s, "
          f"memory {gib(torch.cuda.memory_allocated()):.2f} GiB", flush=True)
    if engine.spec.window != MISTRAL_WINDOW or sched.ring_pages != W_RING:
        raise AssertionError(f"window {engine.spec.window} / ring {sched.ring_pages}: "
                             f"expected {MISTRAL_WINDOW} / {W_RING}")

    # ---- the oracle against the model's own dense forward (window rule),
    # on 4600 tokens: the streamed blocks compute the same function ---- #
    rng = np.random.RandomState(7)
    V = cfg.vocab_size
    ids = torch.from_numpy(rng.randint(0, V, W_ORACLE_T)).long().cuda()
    tail = torch.arange(W_ORACLE_T - 10, W_ORACLE_T, device="cuda")
    a = model.forward_logits(ids[None], compute_dtype=torch.float32)[0, tail]
    b = dense_window_logits(engine.weights, cfg, ids, tail, torch.float32, q_block=512)
    d_oracle = float((a - b).abs().max())
    print(f"oracle: streamed window forward vs forward_logits, {W_ORACLE_T} tokens fp32: max diff "
          f"{d_oracle:.3g} (limit 1e-3; |logit| max {float(a.abs().max()):.3g})", flush=True)
    if not d_oracle <= 1e-3:
        raise AssertionError(f"the streamed oracle differs from forward_logits by {d_oracle}")
    del a, b, model
    torch.cuda.empty_cache()

    prompts = [rng.randint(0, V, n).astype(np.int32) for n in W_PROMPTS]
    uids = [10, 11, 12, 13]
    launches, _, got, toks, _, t_gen, t_prefill, pipe = serve_main_path(
        engine, prompts, uids, W_KERNELS, rng)
    limit = logits_check("with the window", prompts, got, toks,
                         lambda i, seq, rows, dt: dense_window_logits(engine.weights, cfg, seq,
                                                                      rows, dt))
    rung_invariance(engine, uids, limit)

    # ---- decode rate, then the ring at 12032 tokens ---- #
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(28)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    seq0 = sched.seqs[uids[0]]
    held = set()
    for s in sched.seqs.values():
        held.update(s.blocks)
    ring = {"seen_tokens": seq0.seen_tokens, "logical_pages": len(seq0.blocks),
            "physical_pages": len(set(seq0.blocks)), "ring_pages": sched.ring_pages,
            "pool_free": engine.free_blocks, "pool_held": len(held), "pool": nb}
    print("page ring " + json.dumps(ring), flush=True)
    if seq0.seen_tokens != W_CTXS[0] or ring["physical_pages"] != W_RING \
            or ring["logical_pages"] <= W_RING or engine.free_blocks != nb - len(held):
        raise AssertionError(f"page ring: {ring}")
    n_prompt = sum(len(p) for p in prompts)
    print(f"generate() 4 prompts x 32 tokens in {t_gen:.2f} s; prefill {n_prompt} tokens in "
          f"{t_prefill * 1e3:.1f} ms = {n_prompt / t_prefill:.1f} tok/s; decode 4 x 28 tokens "
          f"at rung {engine._attn_rung()} in {t_decode * 1e3:.1f} ms = "
          f"{112 / t_decode:.1f} tok/s ({t_decode / 28 * 1e3:.2f} ms/step)", flush=True)
    prof = device_breakdown(f"Mistral decode step (4 seqs, ctx <= {W_CTXS[0] + 1}, rung "
                            f"{engine._attn_rung()})", lambda: pipe.run(1), W_NAMES)
    # ---- bursts at rungs 4 and 1: the window's side rows through the ring ---- #
    covers = sched.ring_covers(BURST + 1)
    schedule = multistep_schedule(engine.spec, BURST, 4, covers)
    reset_launches()
    for rung in (4, 1):
        engine.attn_rung_override = rung
        burst_line(f"Mistral-7B burst rung {rung}", engine, uids, BURST,
                   {"wall_ms": t_decode / 28 * 1e3, "device_ms": prof["device_ms"]}, W_NAMES,
                   profiled_steps=BURST_PROFILED, ring_covers_17=covers, schedule=schedule)
    engine.attn_rung_override = None
    torch.cuda.synchronize()
    side = {k: LAUNCHES.get(k, 0) for k in W_SIDE_KERNELS}
    held = {u: len(set(sched.seqs[u].blocks)) for u in uids}
    print("burst ring " + json.dumps({"launches": side, "physical_pages": held,
                                      "ring_pages": sched.ring_pages}), flush=True)
    if schedule != "sidebuf" or not all(side.values()):
        raise AssertionError(f"the Mistral bursts ran {schedule} with side launches {side}")
    if max(held.values()) > sched.ring_pages:
        raise AssertionError(f"a sequence holds more than the ring after the bursts: {held}")
    launches.update(side)
    engine.flush(uids + [14])
    device_breakdown(f"Mistral prefill pass ({W_PREFILL} tokens from 0, window)",
                     lambda: engine.put([20], [rng.randint(0, V, W_PREFILL).astype(np.int32)]),
                     W_NAMES)
    engine.flush([20])
    print(f"phase 9: peak device memory {gib(torch.cuda.max_memory_allocated()):.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 10: ALiBi serving of BLOOM-560M
# --------------------------------------------------------------------------- #

A_KERNELS = ("paged_chunk_alibi", "paged_decode_alibi", "paged_splitk_alibi/2",
             "paged_splitk_alibi/4", "splitk_merge")
A_NAMES = ("paged_chunk", "paged_decode", "paged_splitk", "splitk_merge")
A_SIDE_KERNELS = ("paged_decode_side_alibi", "paged_splitk_side_alibi/2")
ENGINE_BLOOM = {"kv_cache": {"block_size": 128, "num_blocks": 72},
                "state_manager": {"max_context": 2048},
                "attention": {"decode_splits": 4, "min_ctx_per_split": 512}, "seed": 0}
A_PROMPTS = (1900, 1000, 400, 60)     # the 1900-token one ends at A_CTXS[0] = 1932


def run_bloom():
    """Phase 10: BLOOM-560M at full width and depth (24 layers, 16 heads,
    D = 64, vocab 250880, tied head, ALiBi, embedding LayerNorm), random
    bf16 weights from seed 0, served through the paged pass (no packed
    prefill) and the split ladder up to 4. Returns the main path's launch
    counts of the ALiBi kernels."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = lambda b: b / 2 ** 30
    cfg = DecoderConfig.bloom_560m(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device="cuda", seed=0)
    engine = InferenceEngineV2(model, ENGINE_BLOOM, model.flat_params())
    spec = engine.spec
    torch.cuda.synchronize()
    nb = ENGINE_BLOOM["kv_cache"]["num_blocks"]
    print(f"model: BLOOM-560M (DecoderConfig.bloom_560m: vocab {cfg.vocab_size}, hidden "
          f"{cfg.hidden_size}, FFN {cfg.intermediate_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, head_dim {cfg.head_dim}, alibi, embed_norm, "
          f"tied head), random bf16 weights (seed 0); family {engine.family}; pool {nb} "
          f"pages; chunk budget {engine.config.state_manager.chunk_budget}; ladder "
          f"{engine.attn_split_ladder}; build {time.perf_counter() - t0:.1f} s, memory "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB (the tied head's f32 embedding "
          f"{gib(engine.weights['embed_f32'].numel() * 4):.2f} GiB)", flush=True)
    if not (spec.alibi and spec.tied_lm_head and spec.embed_norm) \
            or engine._pass_prefill is not None:
        raise AssertionError(f"BLOOM spec {spec}: expected ALiBi, a tied head, the "
                             "embedding norm and no packed prefill pass")

    rng = np.random.RandomState(10)
    V = cfg.vocab_size
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in A_PROMPTS]
    uids = [10, 11, 12, 13]
    launches, packed, got, toks, _, t_gen, t_prefill, pipe = serve_main_path(
        engine, prompts, uids, A_KERNELS, rng)
    if any(packed.values()):
        raise AssertionError(f"the packed prefill kernel ran for an ALiBi model: {packed}")
    limit = logits_check("with alibi_bias", prompts, got, toks,
                         lambda i, seq, rows, dt: model.head(
                             model.hidden(seq[None], compute_dtype=dt)[0, rows]))
    rung_invariance(engine, uids, limit)

    # ---- decode rate and where the time goes ---- #
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(24)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    n_prompt = sum(len(p) for p in prompts)
    print(f"generate() 4 prompts x 32 tokens in {t_gen:.2f} s; prefill {n_prompt} tokens in "
          f"{t_prefill * 1e3:.1f} ms = {n_prompt / t_prefill:.1f} tok/s; decode 4 x 24 tokens "
          f"at rung {engine._attn_rung()} in {t_decode * 1e3:.1f} ms = "
          f"{96 / t_decode:.1f} tok/s ({t_decode / 24 * 1e3:.2f} ms/step)", flush=True)
    live = max(s.seen_tokens for s in engine.scheduler.seqs.values())
    prof = device_breakdown(f"BLOOM decode step (4 seqs, ctx <= {live + 1}, rung "
                            f"{engine._attn_rung()})", lambda: pipe.run(1), A_NAMES)
    # ---- bursts at rungs 1 and 2: ALiBi side rows at D = 64 ---- #
    reset_launches()
    pipe_step = {"wall_ms": t_decode / 24 * 1e3, "device_ms": prof["device_ms"]}
    for rung in (1, 2):
        engine.attn_rung_override = rung
        burst_line(f"BLOOM-560M burst rung {rung}", engine, uids, BURST, pipe_step, A_NAMES,
                   profiled_steps=BURST_PROFILED)
    engine.attn_rung_override = None
    torch.cuda.synchronize()
    side = {k: LAUNCHES.get(k, 0) for k in A_SIDE_KERNELS}
    print("burst launches " + json.dumps(side), flush=True)
    if not all(side.values()):
        raise AssertionError(f"ALiBi side kernels never launched by the bursts: {side}")
    launches.update(side)
    engine.flush(uids + [14])
    chunk = engine.config.state_manager.chunk_budget
    device_breakdown(f"BLOOM prefill pass ({chunk} tokens from 0, paged pass, rung 1)",
                     lambda: engine.put([20], [rng.randint(0, V, chunk).astype(np.int32)]),
                     A_NAMES)
    engine.flush([20])
    print(f"phase 10: peak device memory {gib(torch.cuda.max_memory_allocated()):.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phases 11 and 12: memory-lean serving under a window (Mistral-7B, int4
# weights + int8 pages) and under ALiBi (BLOOM-7b1, int8 pages)
# --------------------------------------------------------------------------- #

def serve_main_path(engine, prompts, uids, names, rng):
    """``generate()`` (32 new tokens each), then ``put()`` of the prompts
    (noting each sequence's prefill-from-zero rows, which attend each other
    at full precision), one pipelined step at each rung of the ladder, and
    a ``put()`` mixing the decode rows with a 180-token prompt at rung 1
    (the chunk and decode kernels; rungs above 1 take the split paths).
    Fails on a malformed stream, a kernel of ``names`` never launched or a
    rung that served no step. Returns (launches, engine logits per step,
    tokens per step, prefill-from-zero rows per uid, generate s, prefill s,
    the pipeline)."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    V = engine.spec.vocab_size
    nb = engine.free_blocks
    reset_launches()
    engine.attn_stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    gen_rungs = dict(engine.attn_stats.rungs)
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + 32 or list(o[:len(p)]) != list(p) \
                or not all(0 <= t < V for t in o):
            raise AssertionError("generate() returned a malformed stream")
    if engine.free_blocks != nb:
        raise AssertionError(f"free blocks {engine.free_blocks} != {nb} after generate()")
    n_full = {}
    complete = engine.scheduler.complete_pass

    def noting(batch):
        if batch.pure_prefill:
            for u in batch.chunk_uids:
                n_full.setdefault(u, engine.scheduler.seqs[u].in_flight_tokens)
        return complete(batch)

    engine.scheduler.complete_pass = noting
    t0 = time.perf_counter()
    got = [engine.put(uids, prompts)]                       # prefill logits
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    engine.scheduler.complete_pass = complete
    pipe = engine.decode_pipeline(uids)
    toks = []
    for rung in engine.attn_split_ladder:                   # one step at each rung
        engine.attn_rung_override = rung
        toks.append(pipe.run(1)[:, 0])
        engine._materialize(uids)
        got.append(np.stack([engine._last_logits[u] for u in uids]))
    engine.attn_rung_override = 1
    nxt = np.argmax(got[-1], axis=-1).astype(np.int32)
    lg = engine.put(uids + [14], [nxt[i:i + 1] for i in range(len(uids))]
                    + [rng.randint(0, V, 180).astype(np.int32)])
    engine.attn_rung_override = None
    torch.cuda.synchronize()
    launches = {k: LAUNCHES.get(k, 0) for k in names}
    packed = {k: LAUNCHES.get(k, 0) for k in ("flash_packed", "flash_packed_window")}
    rungs = dict(engine.attn_stats.rungs)
    toks.append(nxt)
    got.append(lg[:len(uids)])
    print("main-path launches " + json.dumps({**launches, **packed}), flush=True)
    print("attn_stats rungs " + json.dumps({"generate": gen_rungs, "main_path": rungs}),
          flush=True)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    unserved = [r for r in engine.attn_split_ladder if not rungs.get(r)]
    if unserved:
        raise AssertionError(f"rungs that served no step: {unserved}")
    if lg.shape != (len(uids) + 1, V) or not np.isfinite(lg).all():
        raise AssertionError("put() logits malformed")
    return launches, packed, got, toks, n_full, t_gen, t_prefill, pipe


def logits_check(label, prompts, got, toks, dense):
    """The engine's logits at prefill and each decode step against
    ``dense(i, seq, rows, dt)`` in fp32: RMS within 2x the same forward's
    in bf16 (phase 6's rule). Returns the limit."""
    import torch
    e_eng, e_dense, m_eng, m_dense = [], [], 0.0, 0.0
    for i, p in enumerate(prompts):
        seq = torch.from_numpy(np.concatenate([p] + [t[i:i + 1] for t in toks])).long().cuda()
        rows = torch.arange(len(p) - 1, len(p) + len(toks), device="cuda")
        ref32 = dense(i, seq, rows, torch.float32)
        ref16 = dense(i, seq, rows, torch.bfloat16)
        eng = torch.from_numpy(np.stack([g_[i] for g_ in got])).cuda()
        if not torch.isfinite(eng).all():
            raise AssertionError("engine logits are not finite")
        d_eng, d_dense = eng - ref32, ref16 - ref32
        e_eng.append(float(d_eng.pow(2).mean()))
        e_dense.append(float(d_dense.pow(2).mean()))
        m_eng = max(m_eng, float(d_eng.abs().max()))
        m_dense = max(m_dense, float(d_dense.abs().max()))
        del ref32, ref16
    rms_eng, rms_dense = float(np.sqrt(np.mean(e_eng))), float(np.sqrt(np.mean(e_dense)))
    limit = 2 * rms_dense
    print(f"logits vs dense fp32 {label} (prefill + {len(toks)} decode steps x "
          f"{len(prompts)} prompts): engine rms {rms_eng:.5f} max {m_eng:.4f}; dense bf16 "
          f"rms {rms_dense:.5f} max {m_dense:.4f}; limit rms <= {limit:.5f}", flush=True)
    if not rms_eng <= limit:
        raise AssertionError(f"engine logits error {rms_eng} > 2 x dense bf16 {rms_dense}")
    return limit


def rung_invariance(engine, uids, limit):
    """One live decode step at every rung (rung 1 writes last) against rung
    1: RMS within ``limit``."""
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
    db = engine.scheduler.decode_batch(uids, 2, engine.scratch_block)
    ids = engine._sample_device_padded(uids, False, 1.0, 0)
    bt = to_device(db.block_tables, engine.device)
    pos = to_device(db.positions, engine.device)
    step = {}
    for rung in reversed(engine.attn_split_ladder):
        _, lg_r = engine._step_rungs[rung](engine.weights, engine.kv.kv, ids, pos, bt,
                                           pos + 1, kv_scales=engine.kv.scales)
        step[rung] = lg_r[:len(uids)].float()
    diffs = {r: float((step[r] - step[1]).pow(2).mean().sqrt()) for r in step}
    agree = {r: float((step[r].argmax(-1) == step[1].argmax(-1)).float().mean())
             for r in step}
    print("rung invariance " + json.dumps({"rms_vs_rung1": diffs, "limit": limit,
                                           "greedy_agreement_vs_rung1": agree}), flush=True)
    bad = {r: d for r, d in diffs.items() if not d <= limit}
    if bad:
        raise AssertionError(f"rungs {bad} differ from rung 1 by more than {limit}")


def lean_rates_and_bursts(label, engine, uids, prompts, t_gen, t_prefill, names, side_names,
                          burst_rungs, n_decode=24):
    """Decode rate on the pipeline, a device profile of one step, and
    greedy bursts at ``burst_rungs`` whose side kernels ``side_names`` must
    launch. Returns their launch counts."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    pipe = engine.decode_pipeline(uids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(n_decode)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    n_prompt = sum(len(p) for p in prompts)
    rows = len(uids)
    print(f"{label}: generate() {rows} prompts x 32 tokens in {t_gen:.2f} s; prefill "
          f"{n_prompt} tokens in {t_prefill * 1e3:.1f} ms = {n_prompt / t_prefill:.1f} tok/s; "
          f"decode {rows} x {n_decode} tokens at rung {engine._attn_rung()} in "
          f"{t_decode * 1e3:.1f} ms = {rows * n_decode / t_decode:.1f} tok/s "
          f"({t_decode / n_decode * 1e3:.2f} ms/step); {smi_line()}", flush=True)
    live = max(s.seen_tokens for s in engine.scheduler.seqs.values())
    prof = device_breakdown(f"{label} decode step ({rows} seqs, ctx <= {live + 1}, rung "
                            f"{engine._attn_rung()})", lambda: pipe.run(1), names)
    reset_launches()
    pipe_step = {"wall_ms": t_decode / n_decode * 1e3, "device_ms": prof["device_ms"]}
    for rung in burst_rungs:
        engine.attn_rung_override = rung
        burst_line(f"{label} burst rung {rung}", engine, uids, BURST, pipe_step, names,
                   profiled_steps=BURST_PROFILED)
    engine.attn_rung_override = None
    torch.cuda.synchronize()
    side = {k: LAUNCHES.get(k, 0) for k in side_names}
    print("burst launches " + json.dumps(side), flush=True)
    if not all(side.values()):
        raise AssertionError(f"{label}: side kernels never launched by the bursts: {side}")
    return side


M8_KERNELS = ("flash_packed_window", "paged_chunk_int8_window", "paged_decode_int8_window",
              "paged_splitk_int8_window/2", "paged_splitk_int8_window/4", "splitk_merge",
              "quantized_matmul_gemv", "quantized_matmul_mma")
M8_SIDE_KERNELS = ("paged_splitk_int8_side_window/4", "paged_decode_int8_side_window")
M8_NAMES = W_NAMES + ("qmm_gemv", "qmm_mma")
ENGINE_MISTRAL_LEAN = {**ENGINE_MISTRAL, "kv_quant": {"enabled": True},
                       "quantization": {"weight_bits": 4}}


def run_mistral_lean():
    """Phase 11: Mistral-7B at full width and depth (phase 9's engine) with
    packed int4 weights (quantized by the engine from random bf16 weights of
    seed 0) and int8 KV pages through the page ring. Returns the main
    path's launch counts."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = lambda b: b / 2 ** 30
    cfg = LlamaConfig.mistral_7b(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    engine = InferenceEngineV2(model, ENGINE_MISTRAL_LEAN, model.flat_params())
    del model                     # the caller's bf16 tree: the engine keeps int4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sched = engine.scheduler
    nb = ENGINE_MISTRAL_LEAN["kv_cache"]["num_blocks"]
    w4 = engine.weights["layers"][0]["w_up"]
    print(f"model: Mistral-7B (LlamaConfig.mistral_7b, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} heads, window "
          f"{cfg.sliding_window}), random bf16 weights (seed 0) packed to int4 by the engine "
          f"(w_up {list(w4['w4'].shape)} {w4['w4'].dtype}); int8 KV pool of {nb} pages; "
          f"ring {sched.ring_pages} pages; ladder {engine.attn_split_ladder}; build "
          f"{time.perf_counter() - t0:.1f} s; memory after build "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB, peak during build "
          f"{gib(torch.cuda.max_memory_allocated()):.2f} GiB", flush=True)
    if engine.spec.window != MISTRAL_WINDOW or sched.ring_pages != W_RING \
            or engine.kv.kv.dtype != torch.int8 or set(w4) != {"w4", "scale"}:
        raise AssertionError("phase 11's engine is not windowed int4 + int8 as configured")

    rng = np.random.RandomState(11)
    V = cfg.vocab_size
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in W_PROMPTS]
    uids = [10, 11, 12, 13]
    launches, _, got, toks, n_full, t_gen, t_prefill, _ = serve_main_path(
        engine, prompts, uids, M8_KERNELS, rng)
    print(f"prefill-from-zero rows per prompt: {[n_full.get(u, 0) for u in uids]}",
          flush=True)
    limit = logits_check(
        "with the window over the int4 weights and int8 pool values", prompts, got, toks,
        lambda i, seq, rows, dt: dense_window_logits(
            engine.weights, cfg, seq, rows, dt, kv_pool=True, n_full=n_full.get(uids[i], 0)))
    rung_invariance(engine, uids, limit)

    # ---- the ring at 12032 tokens after 28 more steps, rates, bursts ---- #
    side = lean_rates_and_bursts("Mistral-7B int4 + int8 KV", engine, uids, prompts, t_gen,
                                 t_prefill, M8_NAMES, M8_SIDE_KERNELS, (4, 1), n_decode=28)
    seq0 = sched.seqs[uids[0]]
    ring = {"seen_tokens": seq0.seen_tokens, "logical_pages": len(seq0.blocks),
            "physical_pages": len(set(seq0.blocks)), "ring_pages": sched.ring_pages}
    print("page ring " + json.dumps(ring), flush=True)
    if ring["physical_pages"] != W_RING or ring["logical_pages"] <= W_RING \
            or seq0.seen_tokens < W_CTXS[0]:
        raise AssertionError(f"page ring: {ring}")
    launches.update(side)
    engine.flush(uids + [14])
    print(f"phase 11: peak device memory {gib(torch.cuda.max_memory_allocated()):.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


B8_KERNELS = ("paged_chunk_int8_alibi", "paged_decode_int8_alibi",
              "paged_splitk_int8_alibi/2", "paged_splitk_int8_alibi/4", "splitk_merge")
B8_SIDE_KERNELS = ("paged_decode_int8_side_alibi", "paged_splitk_int8_side_alibi/2")
ENGINE_BLOOM_7B1 = {**ENGINE_BLOOM, "kv_quant": {"enabled": True}}


def bloom_pool_logits(model, ids, rows, dt):
    """The port's dense ``DecoderLM`` forward (``alibi_bias``) with every
    layer's K and V projections at the values an int8 page stores
    (``kv_write_dequant``): what an ALiBi engine over an int8 pool computes,
    whose every pass writes its rows before attending them. f32 logits at
    ``rows``."""
    from deepspeed_tpu_torch.models import decoder
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_write_dequant
    kv_w = {id(layer.wk) for layer in model.layers} | {id(layer.wv) for layer in model.layers}
    D = model.config.head_dim
    proj = decoder._proj

    def pooled(x, w, b, dt_):
        y = proj(x, w, b, dt_)
        if id(w) not in kv_w:
            return y
        return kv_write_dequant(y.unflatten(-1, (-1, D))).flatten(-2).to(dt_)

    decoder._proj = pooled
    try:
        return model.head(model.hidden(ids[None], compute_dtype=dt)[0, rows])
    finally:
        decoder._proj = proj


def run_bloom_7b1():
    """Phase 12: BLOOM-7b1 at full width and depth (30 layers, hidden 4096,
    32 heads, D = 128, FFN 16384, vocab 250880, tied head, ALiBi), random
    bf16 weights from seed 0, served with int8 KV pages through the paged
    pass and the split ladder up to 4. Returns the main path's launch
    counts."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = lambda b: b / 2 ** 30
    cfg = DecoderConfig.bloom_560m(hidden_size=4096, intermediate_size=16384,
                                   num_hidden_layers=30, num_attention_heads=32,
                                   dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device="cuda", seed=0)
    engine = InferenceEngineV2(model, ENGINE_BLOOM_7B1, model.flat_params())
    spec = engine.spec
    torch.cuda.synchronize()
    nb = ENGINE_BLOOM_7B1["kv_cache"]["num_blocks"]
    print(f"model: BLOOM-7b1 (DecoderConfig.bloom_560m(hidden_size={cfg.hidden_size}, "
          f"intermediate_size={cfg.intermediate_size}, num_hidden_layers="
          f"{cfg.num_hidden_layers}, num_attention_heads={cfg.num_attention_heads}): vocab "
          f"{cfg.vocab_size}, head_dim {cfg.head_dim}, alibi, embed_norm, tied head), random "
          f"bf16 weights (seed 0); int8 KV pool of {nb} pages; ladder "
          f"{engine.attn_split_ladder}; build {time.perf_counter() - t0:.1f} s, memory "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB", flush=True)
    if not (spec.alibi and spec.head_dim == 128) or engine._pass_prefill is not None \
            or engine.kv.kv.dtype != torch.int8:
        raise AssertionError(f"BLOOM-7b1 spec {spec}: expected ALiBi at D = 128 over an "
                             "int8 pool and no packed prefill pass")

    rng = np.random.RandomState(12)
    V = cfg.vocab_size
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in A_PROMPTS]
    uids = [10, 11, 12, 13]
    launches, packed, got, toks, _, t_gen, t_prefill, _ = serve_main_path(
        engine, prompts, uids, B8_KERNELS, rng)
    if any(packed.values()):
        raise AssertionError(f"the packed prefill kernel ran for an ALiBi model: {packed}")
    limit = logits_check("with alibi_bias over the int8 pool values", prompts, got, toks,
                              lambda i, seq, rows, dt: bloom_pool_logits(model, seq, rows, dt))
    rung_invariance(engine, uids, limit)
    launches.update(lean_rates_and_bursts("BLOOM-7b1 int8 KV", engine, uids, prompts, t_gen,
                                          t_prefill, A_NAMES, B8_SIDE_KERNELS, (1, 2)))
    engine.flush(uids + [14])
    print(f"phase 12: peak device memory {gib(torch.cuda.max_memory_allocated()):.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


ATTN_NAMES = ("flash_packed", "paged_chunk", "paged_decode", "flash_fwd", "flash_bwd_dq",
              "flash_bwd_dkv")
Q_NAMES = ("flash_packed", "paged_chunk", "paged_decode", "paged_splitk", "splitk_merge",
           "qmm_gemv", "qmm_mma")


def device_breakdown(label: str, fn, names=ATTN_NAMES) -> dict:
    """Run ``fn`` once under the CUDA-only profiler; print wall time, summed
    device kernel time, the device busy share, the time of the port's
    kernels ``names`` (matched as ``<name>_kernel``) and the six largest
    kernels. Returns the wall and device ms (NaN where the profiler saw no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            dev[e.key] = us / 1e3
    busy = sum(dev.values())
    ours = {n: sum(v for k, v in dev.items() if f"{n}_kernel" in k) for n in names}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:6]
    print("profile " + json.dumps({
        "phase": label, "wall_ms": wall,
        "device_ms": busy if busy else "not measured",
        "device_busy_share": busy / wall if busy else "not measured",
        "port_kernels_ms": ours,
        "top_kernels_ms": [[k[:80], v] for k, v in top]}), flush=True)
    return {"wall_ms": wall, "device_ms": busy if busy else float("nan")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.ops.kernels import _loader

    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    _loader.load_library()
    print(f"build: {_loader.last_build_seconds:.1f} s (nvcc, sm_90a; "
          f"{time.perf_counter() - t0:.1f} s with load)", flush=True)
    t_phase = time.perf_counter()
    rows = check_kernels(torch.device("cuda"))
    print(f"phase 3: {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()
    launches = run_slice()
    print(f"phase 4: {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    launches.update({k: v for k, v in run_training().items() if k in K1_NAMES})
    print(f"phase 5: {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()
    launches.update(run_13b())
    torch.cuda.empty_cache()
    launches.update(run_sparse(rows))
    torch.cuda.empty_cache()
    launches.update(run_evoformer(rows))
    torch.cuda.empty_cache()
    # the merge kernel's row keeps phase 6's count; phase 9 checks its own
    launches.update({k: v for k, v in run_mistral().items() if k != "splitk_merge"})
    torch.cuda.empty_cache()
    # likewise phase 10
    launches.update({k: v for k, v in run_bloom().items() if k != "splitk_merge"})
    torch.cuda.empty_cache()
    # phases 11 and 12: the K2 and K8 rows keep phases 9's and 6's counts
    shared = ("splitk_merge", "flash_packed_window", "quantized_matmul_gemv",
              "quantized_matmul_mma")
    launches.update({k: v for k, v in run_mistral_lean().items() if k not in shared})
    torch.cuda.empty_cache()
    launches.update({k: v for k, v in run_bloom_7b1().items() if k not in shared})
    # modules by full name: the package re-exports same-named functions
    from deepspeed_tpu_torch.ops.kernels import paged_chunk, paged_decode, paged_splitk
    from deepspeed_tpu_torch.ops.kernels.block_sparse_attention import KERNELS as K9_KERNELS
    from deepspeed_tpu_torch.ops.kernels.evoformer_attention import KERNELS as K10_KERNELS
    from deepspeed_tpu_torch.ops.kernels.flash_attention import KERNELS
    qmm = sys.modules["deepspeed_tpu_torch.ops.kernels.quantized_matmul"]
    sources = {}
    for mod in ("flash_packed", "paged_chunk", "paged_decode"):
        m = __import__(f"deepspeed_tpu_torch.ops.kernels.{mod}", fromlist=["x"])
        sources[mod] = (m.SOURCE, m.REPLACES)
    sources.update(KERNELS)
    sources.update({
        qmm.GEMV: (qmm.SOURCE, qmm.REPLACES), qmm.MMA: (qmm.SOURCE, qmm.REPLACES),
        paged_decode.NAME_INT8: (paged_decode.SOURCE, paged_decode.REPLACES_INT8),
        paged_chunk.NAME_INT8: (paged_chunk.SOURCE, paged_chunk.REPLACES_INT8),
        **{paged_splitk.kernel_name(n, quant=True): (paged_splitk.SOURCE,
                                                     paged_splitk.REPLACES)
           for n in (2, 4, 8)},
        paged_splitk.MERGE: (paged_splitk.SOURCE, paged_splitk.REPLACES_MERGE)})
    fp = sys.modules["deepspeed_tpu_torch.ops.kernels.flash_packed"]
    sources.update({
        fp.NAME_WINDOW: (fp.SOURCE, fp.REPLACES_WINDOW),
        paged_chunk.NAME_WINDOW: (paged_chunk.SOURCE, paged_chunk.REPLACES_WINDOW),
        paged_decode.NAME_WINDOW: (paged_decode.SOURCE, paged_decode.REPLACES_WINDOW),
        **{paged_splitk.kernel_name(n, MISTRAL_WINDOW): (paged_splitk.SOURCE,
                                                         paged_splitk.REPLACES_WINDOW)
           for n in (2, 4)},
        paged_chunk.NAME_ALIBI: (paged_chunk.SOURCE, paged_chunk.REPLACES_ALIBI),
        paged_decode.NAME_ALIBI: (paged_decode.SOURCE, paged_decode.REPLACES_ALIBI),
        **{paged_splitk.kernel_name(n, alibi=True): (paged_splitk.SOURCE,
                                                     paged_splitk.REPLACES_ALIBI)
           for n in (2, 4)}})
    # the side buffer of decode_steps bursts (C = 16)
    sources.update({
        paged_decode.NAME_SIDE: (paged_decode.SOURCE, paged_decode.REPLACES_SIDE),
        paged_decode.NAME_INT8_SIDE: (paged_decode.SOURCE, paged_decode.REPLACES_INT8_SIDE),
        paged_decode.launch_name(False, MISTRAL_WINDOW, False, SIDE_C): (
            paged_decode.SOURCE, paged_decode.REPLACES_WINDOW),
        paged_decode.launch_name(False, None, True, SIDE_C): (
            paged_decode.SOURCE, paged_decode.REPLACES_ALIBI),
        **{paged_splitk.kernel_name(n, side=True): (paged_splitk.SOURCE,
                                                    paged_splitk.REPLACES_SIDE)
           for n in (2, 4)},
        **{paged_splitk.kernel_name(n, side=True, quant=True): (paged_splitk.SOURCE,
                                                                paged_splitk.REPLACES_SIDE)
           for n in (2, 4, 8)},
        paged_splitk.kernel_name(4, MISTRAL_WINDOW, side=True): (
            paged_splitk.SOURCE, paged_splitk.REPLACES_WINDOW),
        paged_splitk.kernel_name(2, alibi=True, side=True): (
            paged_splitk.SOURCE, paged_splitk.REPLACES_ALIBI)})
    # the int8 pool's window and ALiBi branches (phases 11 and 12)
    sources.update({
        paged_decode.launch_name(True, MISTRAL_WINDOW, False, 1): (
            paged_decode.SOURCE, paged_decode.REPLACES_INT8_WINDOW),
        paged_decode.launch_name(True, MISTRAL_WINDOW, False, SIDE_C): (
            paged_decode.SOURCE, paged_decode.REPLACES_INT8_WINDOW),
        paged_decode.launch_name(True, None, True, 1): (
            paged_decode.SOURCE, paged_decode.REPLACES_INT8_ALIBI),
        paged_decode.launch_name(True, None, True, SIDE_C): (
            paged_decode.SOURCE, paged_decode.REPLACES_INT8_ALIBI),
        "paged_chunk_int8_window": (paged_chunk.SOURCE, paged_chunk.REPLACES_INT8_WINDOW),
        "paged_chunk_int8_alibi": (paged_chunk.SOURCE, paged_chunk.REPLACES_INT8_ALIBI),
        **{paged_splitk.kernel_name(n, MISTRAL_WINDOW, quant=True): (
            paged_splitk.SOURCE, paged_splitk.REPLACES_INT8_WINDOW) for n in (2, 4)},
        paged_splitk.kernel_name(4, MISTRAL_WINDOW, side=True, quant=True): (
            paged_splitk.SOURCE, paged_splitk.REPLACES_INT8_WINDOW),
        **{paged_splitk.kernel_name(n, alibi=True, quant=True): (
            paged_splitk.SOURCE, paged_splitk.REPLACES_INT8_ALIBI) for n in (2, 4)},
        paged_splitk.kernel_name(2, alibi=True, side=True, quant=True): (
            paged_splitk.SOURCE, paged_splitk.REPLACES_INT8_ALIBI)})
    sources.update(K9_KERNELS)
    sources.update(K10_KERNELS)
    table = []
    for name, (source, replaces) in sources.items():
        r = rows[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                      "case": r["case"],
                      **({"library_covers": r["library_covers"]}
                         if "library_covers" in r else {})})
    print(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s from the build on", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
