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
projection and the LM head, gate/up at M = 1, 2, 3, 5 and 8 and GPT-J's
LM head (50400 columns, not a multiple of 128), ``qmm_gemv``'s registers,
spills and shared memory at every M and weight type (a gemv ``k8-kernels``
line; a spill fails), ``qmm_mma`` at every projection a prefill
pass gives it (13B at M = 736, Mistral-7B's unpacked int4 weights at M =
4224, BLOOM-7b1's and phi-2's at M = 736; M = 9, 63 and 130, and K =
4128, which 64 does not divide), each rerun and required bitwise equal,
both of its token tiles timed, its registers printed (the ``k8-kernels``
line; a spill fails) and its refusals (K % 32, N % 16), the int8 decode
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
   and kernels' times with SDPA over the boolean token mask as yardstick;
   then K9's dq and dk/dv at D 16/32/64/128, causal and not, on those five
   layouts at B = 1 and on a hand-made layout (a 64-tile with a
   single active 16-block, a query band and a key band that see nothing:
   their gradients must be exactly 0), each rerun and required bitwise
   equal, and the ``k9-kernels`` line (registers, spills; a spill fails).

8. Evoformer pair-bias attention (K10) at AlphaFold 2's fine-tuning
   Evoformer widths (crop 384 residues, 512 MSA clusters, B = 1; MSA row
   attention 8 heads x 32, triangle attention 4 heads x 32), bf16, through
   ``DS4Sci_EvoformerAttention`` (MSA row attention with ``fused=True``,
   the -1e9 mask bias and the pair bias; and ``fused=None`` with the pair
   bias alone) and both triangle attentions, forward and ``.backward``;
   each kernel (forward, dq, dk/dv, d(pair)) against its plain version at
   the MSA row shape and at a ragged S = 300 (R = 4, D 16 to 128, bf16 and
   f32 pair bias, mask or none), an odd S = 301 and R = 1, each rerun and
   required bitwise equal (the ``k10-kernels`` line: registers, spills),
   one launch of each per op call, the op's output and four
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
   kernel (C = 1 and 16) and K7 (2 and 4 splits, the side piece at 4), of
   K8's gemv on the packed int4 bytes (decode) and of ``qmm_mma`` on the
   unpacked weights (prefill); next-token logits at prefill and
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
piece at 2 splits); and ``_mm`` over packed int4 weights at Mistral-7B's
gate/up projection: at M = 4 K8's gemv reads the packed bytes and must
give the bits of unpack + ``qmm_gemv``, at M = 4224 unpack + ``qmm_mma``,
each timed beside the unpack and K8 on the unpacked values.

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

13. serving phi-2 at full width and depth (32 layers, 2560 wide, 32 heads
   of D = 80, partial rotary 0.4, parallel blocks, vocab 51200; random bf16
   weights from seed 0): pages of 128, max_context 2048, 40 pages, the
   default chunk budget (736), the split ladder up to 2; ``generate()`` on
   prompts of 1500/600/200/40 tokens (32 new tokens each), a step at each
   pinned rung 1/2 and a mixed ``put()`` at rung 1; launches of K2, K5, the
   decode kernel and K7 at D = 80; next-token logits at prefill and three
   decode steps against the port's dense fp32 ``DecoderLM`` (RMS within 2x
   the same forward's in bf16); rung invariance; rates, a device profile,
   peak memory.

Phase 3 also holds K2 (on the tensor cores) against its plain version at
Llama-2-7B's prefill pass (768 rows) at D = 16, 32 and 64, phi-2's D = 80,
GPT-NeoX-20B's D = 96 (64 heads), GPT-J-6B's D = 256 (16 heads) and
Falcon-7B's 71/1 heads, each timed beside SDPA; the engine's slot layout
(padding rows between segments, all rows compared, with and without a
window); its lse output (the
``flash_packed_lse`` row; |lse - ref| <= 2^-10 x max(1, |ref|)) without
and under the window of 4096; two NaN poison checks (the K and V rows of a
first segment ending on a 64-row boundary, and keys below a window of
200: the other rows' outputs stay bitwise equal, so the tiles K2 skips are
never read); prints the ``k2-kernels`` line (registers, spill bytes and
shared memory per head dim, times) and fails on a spill. ``check_head_dims``
holds K5, the decode kernel and K7 at D = 80 (32 heads) and D = 96 (64
heads) against their plain versions.

Phase 3 runs every call of the paged chunk kernel's (K5), the paged
decode kernel's and K7's wrappers twice and requires the same bits
(``bitwise_reruns``); holds the decode kernel and K7 at pages of 16 and
64, at G = 8 with D = 256 and at D = 40, over bf16 and int8 pages, under a
window of 200 and ALiBi, with one and 16 side rows
(``check_paged_shapes``); holds K5 at pages of 16, 64 and 128, at every
head dim it is built for (bf16 16 to 256, int8 128 and 256), at G = 1, 2,
4, 8 and Falcon-7B's 71, over bf16 and int8 pages, with no window, a
window of 200 over ring tables and ALiBi, on slots whose rows straddle
pages, a slot whose rows run past its context and an empty slot
(``check_chunk_shapes``); and prints the ``paged-kernels`` line: each
instance's registers, spill bytes and shared memory (K5's too), the decode
kernel's cluster size and K5's block count at each main path's shape, and
the count of bitwise reruns (a spill fails the run).

Every serving phase (4, 6 and 9 to 14) also prints a ``continuation pass``
line: the device and wall ms of one paged pass made only of continuation
chunks (a prompt of two passes' take, its second pass) at each rung of the
phase's ladder, with the port kernels' share (``continuation_pass``).

14. MoE serving of Mixtral-8x7B at full width and depth (32 layers, 8
   experts, top-2; 46.7B parameters, 93.4 GB in bf16) on one card with
   ``quantization.weight_bits = 8`` and bf16 KV pages: the parameters are
   made on the card from seed 0 one tensor at a time as the engine reads
   them (``SeededParams``), each projection and expert stack quantized as
   it lands, so no bf16 copy of the model exists; ``_moe_ffn`` at a
   prefill pass's and a decode step's rows under
   ``torch.cuda.set_sync_debug_mode("error")``; the main path
   (``generate()`` on prompts of 2000/900/300/60 tokens, a step at each
   pinned rung 1/2/4, a mixed ``put()``) with K8's grouped entries among
   its launches; next-token logits against a dense fp32 forward over the
   engine's own int8 experts (RMS within 2x the same forward's in bf16),
   and the share of (layer, token) top-2 sets that the engine and the
   dense bf16 forward route as the fp32 one does; rung invariance; rates,
   a profiled decode step beside its bound (the routed experts' bytes),
   bursts at rungs 1 and 4, a profiled prefill pass, a continuation pass;
   peak device memory under 80 GiB.

15. Qwen2-7B (biased q/k/v, 28 query heads over 4 kv heads: G = 7) and
16. Gemma-7B (head dim 256, GeGLU, RMSNorm by 1 + weight, the embedding
   scaled by sqrt(hidden)) at full width and depth in bf16, their weights
   made on the card from seed 0 (random nonzero biases, norm weights
   around 0): prompts of 1500/600/200/40 tokens through the main path,
   logits against the dense fp32 ``LlamaForCausalLM`` forward (RMS within
   2x its bf16 pass's), rung invariance, rates, a profiled step and bursts
   at rungs 1 and 2.

Phase 3 also holds K8's grouped entries (``quantized_matmul_grouped``: the
grouped gemv and the grouped ``qmm_mma``) against their plain version at
Mixtral-8x7B's expert shapes (decode steps of 4 and 1 sequences, 32 rows
in one expert, 11 and 33 rows, a 736-token prefill pass, skewed and all
in one expert, a K that 64 does not divide), each rerun bitwise, timed at
the table's rows beside ``torch._grouped_mm`` over bf16 experts (the
``k8-grouped`` line: registers and spills; a spill fails); and K5 and the
decode kernel at Qwen2-7B's G = 7 and Gemma-7B's D = 256 on pages of 128.

17. the prefix cache and speculative decoding on Llama-2-7B at full width
   and depth (random bf16 weights from seed 0), over bf16 and then int8 KV
   pages, the engines built one after another. Prefix cache on and off:
   ``generate()`` (64 new tokens each) of a 1024-token prefix + 128-token
   tail, then 7 requests sharing the prefix, a request ending mid-page and
   one extending it (a copy-on-write adoption whose page must equal its
   source byte for byte, the int8 values and the scale tile); prefill
   tokens computed, hit rate, tokens saved, COW copies, the 7 requests'
   prefill ms; streams equal or parting at a near-tie; a fully cached
   prompt prefilling >= 1 token; (bf16) the hits' continuation logits
   against the dense fp32 forward (RMS within 2x the dense bf16
   forward's). Spec decode at k = 3 and 7: 4 prompts repeating a 64-token
   span 8 times and 4 random ones, 128 new tokens through ``generate()``
   against the plain pipeline (streams equal or parting at a near-tie;
   K5's launches from the verify steps; the pool at its baseline), one
   ``decode_pipeline`` run with an oracle proposer replaying the plain
   streams (every draft accepted up to a row's first near-tie), a
   reject-heavy run, and a verify step (under
   ``set_sync_debug_mode("error")`` once) beside a plain step, wall and
   device ms with K5's share. Phase 3 holds K5 at the verify step's shapes
   (8 slots of 2, 4 and 8 rows, Hkv 32 and 8, bf16 and int8, one slot
   across a page edge; the ``k5-verify`` line times k = 3 beside k = 2).
18. multi-tenant LoRA on Llama-2-7B at full width and depth (random bf16
   weights from seed 0): all four targets, max_rank 16, a 48-page pool (96
   MiB); six adapters of ranks 4, 8, 8, 16, 16, 16 (68 pages) whose delta
   has a quarter of the base projection's rms; two mixed runs of 8 prompts
   (256-1024 tokens, 64 new tokens), the second evicting idle adapters and
   faulting the first back in. Checks: (a) every bound row's stream and
   logits bit-equal to its run with every other row unbound; (b) a hit's
   logits after every step within 2x the dense bf16 rms of a dense fp32
   forward with the adapter's merged delta in the decode scope, the dense
   forward without the delta and with another tenant's failing that
   limit; (c) unbound rows bit-equal to a LoRA-off engine's; (d) an
   evicted adapter's pages and stream back bit for bit; (e) spec decode
   (k = 3, an oracle replaying run 1) equal to the plain LoRA streams or
   apart at a near-tie, its final rows within (b)'s limit; (f) run 1's
   pipeline under ``set_sync_debug_mode("error")``; (g) pool, pinned
   buffers and KV pool at baseline after a drain; (h) int8 weights (K8)
   under the deltas, (a) and (b) again. Printed on the ``lora`` line:
   decode tok/s LoRA against LoRA-off, the LoRA and base steps' wall and
   device ms and kernels, the delta's and the gather's device ms, every
   fault-in and eviction (ms, bytes).

The last two lines are the kernel table (58 rows, K5 at the verify step's
shape among them) and ``{"ok": true,
"device": ...}`` as JSON. Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import collections.abc
import contextlib
import functools
import gc
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


# GPU clock cycles that time_ms sleeps on the stream per timed launch
# (~0.15 ms at the H100's ~2 GHz): the host enqueues the launches meanwhile,
# so a kernel shorter than its host launch (~0.03-0.05 ms through a
# wrapper) is timed on the device, not at the host's launch rate
SLEEP_CYCLES_PER_ITER = 300_000


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a GPU sleep, so they run back to back."""
    import torch
    RERUNS["timing"] = True
    try:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES_PER_ITER * iters)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
    finally:
        RERUNS["timing"] = False
    return t0.elapsed_time(t1) / iters


# Phase 3 runs every call of K5's, the decode kernel's and K7's wrappers
# twice (outside time_ms) and requires the same bits (bitwise_reruns)
RERUNS = {"timing": False, "checked": 0}


def _bits(x):
    import torch
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@contextlib.contextmanager
def bitwise_reruns():
    """Within the block, each call of ``paged_chunk_attention_batched``,
    ``paged_decode_attention`` and ``splitk_attention`` (through the
    package or their modules) outside ``time_ms`` runs twice and fails
    unless both give the same bits."""
    import torch
    import deepspeed_tpu_torch.ops.kernels as pkg
    kernels = "deepspeed_tpu_torch.ops.kernels."
    mods = {"paged_chunk_attention_batched": sys.modules[kernels + "paged_chunk"],
            "paged_decode_attention": sys.modules[kernels + "paged_decode"],
            "splitk_attention": sys.modules[kernels + "paged_splitk"]}
    saved = {name: getattr(mod, name) for name, mod in mods.items()}

    def twice(name, fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            out = fn(*args, **kw)
            if RERUNS["timing"]:
                return out
            again = fn(*args, **kw)
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            agains = again if isinstance(again, tuple) else (again,)
            if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(outs, agains)):
                raise AssertionError(f"{name}: two runs on the same inputs differ")
            RERUNS["checked"] += 1
            return out
        return run

    for name, mod in mods.items():
        wrapped = twice(name, saved[name])
        setattr(mod, name, wrapped)
        setattr(pkg, name, wrapped)
    try:
        yield
    finally:
        for name, mod in mods.items():
            setattr(mod, name, saved[name])
            setattr(pkg, name, saved[name])


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
    R, H, D = K2_R, 32, 128
    seg_lens = K2_SEGS
    seg = packed_segments(R, seg_lens, dev)
    q, k, v = randn(R, H, D), randn(R, H, D), randn(R, H, D)
    out = flash_attention_packed(q, k, v, seg)
    ref = flash_attention_packed_plain(q, k, v, seg)
    torch.cuda.synchronize()
    pairs = packed_pairs(R, seg_lens)
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
    del q, k, v, k8, v8, mask, qt, kt, vt
    check_packed(dev, randn, record, {"Llama-2-7B": rows["flash_packed"]})

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
    check_head_dims(dev, randn, record)
    check_side_kernels(dev, randn, record)
    check_quant_window_kernels(dev, g, randn, record)
    check_quant_alibi_kernels(dev, g, randn, record)
    check_int4_matmul(dev, g, randn, record)
    check_grouped_matmul(dev, g, randn, record)
    check_paged_shapes(dev, g, randn, record)
    check_chunk_shapes(dev, g, randn, record)
    check_verify_shapes(dev, g, randn, record)
    paged_attributes(dev)
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


# K2 beside its table row (phase 3): Llama-2-7B's prefill pass of 768 rows
# (segments 300/200/150/100 + 18 padding rows) at every head dim the kernel
# takes, with the head counts of the models that have it
K2_R, K2_SEGS = 768, [300, 200, 150, 100]
K2_CASES = (("D=16", 32, 32, 16), ("D=32", 32, 32, 32), ("D=64", 32, 32, 64),
            ("phi-2", 32, 32, 80), ("GPT-NeoX-20B", 64, 64, 96),
            ("GPT-J-6B", 16, 16, 256), ("Falcon-7B", 71, 1, 64))
K2_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
# K2's lse against its plain version: |lse - ref| <= LSE_RTOL x max(1, |ref|)
LSE_RTOL = 2.0 ** -10


def packed_segments(R, seg_lens, dev):
    """Segment ids [R] int32 on ``dev``: ``seg_lens`` rows of segments 0,
    1, ... in order, then padding rows (-1)."""
    import torch
    seg = torch.full((R,), -1, dtype=torch.int32, device=dev)
    o = 0
    for i, n in enumerate(seg_lens):
        seg[o:o + n] = i
        o += n
    return seg


def slot_segments(slot, lens, n_slots, dev):
    """Segment ids of the engine's packed layout: ``n_slots`` slots of
    ``slot`` rows, each prompt's chunks from a slot's start (a prompt longer
    than a slot takes consecutive slots), padding (-1) to each slot's end."""
    import torch
    seg = torch.full((slot * n_slots,), -1, dtype=torch.int32, device=dev)
    s = 0
    for i, n in enumerate(lens):
        for c in range(0, n, slot):
            seg[s * slot:s * slot + min(slot, n - c)] = i
            s += 1
    return seg


def packed_pairs(R, seg_lens, window=None):
    """Visible (row, key) pairs of one head: each segment's causal pairs,
    the padding rows' among themselves, within ``window`` if given."""
    w = window or R
    return sum(sum(min(r + 1, w) for r in range(n)) for n in seg_lens + [R - sum(seg_lens)])


def lse_err(lse, ref):
    """K2's lse against its plain version: ok where |lse - ref| <=
    LSE_RTOL x max(1, |ref|) everywhere."""
    d = (lse.float() - ref.float()).abs()
    lim = LSE_RTOL * ref.float().abs().clamp(min=1.0)
    return {"lse_max_abs_err": float(d.max()), "lse_max_err_over_limit": float((d / lim).max()),
            "lse_rtol": LSE_RTOL, "lse_ok": bool((d <= lim).all())}


def with_lse_check(e, le):
    """err()'s result for o with the lse check folded into ``ok``."""
    return {**e, **le, "ok": e["ok"] and le["lse_ok"]}


def k2_attributes() -> dict:
    """K2 as compiled at each head dim, through ``dstorch_flash_packed_attrs``."""
    return {f"flash_packed/D{D}": read_attributes("dstorch_flash_packed_attrs", D)
            for D in K2_HEAD_DIMS}


def check_packed(dev, randn, record, timed):
    """K2 against its plain version beyond the table's row: D = 16/32/64,
    phi-2's D = 80 at 32 heads, GPT-NeoX-20B's D = 96 at 64 heads, GPT-J-6B's
    D = 256 at 16 heads and Falcon-7B's 71/1 heads at D = 64, each timed
    beside SDPA over the same boolean mask; the engine's slot layout
    (padding rows between segments, every row compared; also windowed);
    the lse output (the
    ``flash_packed_lse`` row, timed beside the efficient SDPA kernel that
    returns its log-sum-exp); the poison checks: K and V rows of tiles that
    no row of a q-block sees (a first segment ending on a 64-row boundary,
    and keys below a window of 200) filled with NaN leave the other rows'
    outputs bitwise equal, so the skipped tiles are not read. Prints the
    ``k2-kernels`` line (registers, spills, shared memory per head dim;
    times) and fails on a spill. ``timed`` holds the table row's case."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import (flash_attention_packed,
                                                 flash_attention_packed_plain)
    R, seg_lens = K2_R, K2_SEGS
    seg = packed_segments(R, seg_lens, dev)
    idx = torch.arange(R, device=dev)
    mask = (idx[:, None] >= idx[None]) & (seg[:, None] == seg[None])
    pairs = packed_pairs(R, seg_lens)
    timed = {k: {"ms": r["ms"], "sdpa_ms": r["library_ms"], "bound_ms": r["bound_ms"]}
             for k, r in timed.items()}
    for label, H, Hkv, D in K2_CASES:
        q, k, v = randn(R, H, D), randn(R, Hkv, D), randn(R, Hkv, D)
        out = flash_attention_packed(q, k, v, seg)
        ref = flash_attention_packed_plain(q, k, v, seg)
        torch.cuda.synchronize()
        qt = q.transpose(0, 1)[None]
        kt, vt = (x.repeat_interleave(H // Hkv, dim=1).transpose(0, 1)[None] for x in (k, v))
        b_ms, b_by = bound((2 * R * H + 2 * R * Hkv) * D * 2 + R * 4, 4 * D * H * pairs)
        ms = time_ms(lambda: flash_attention_packed(q, k, v, seg))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        timed[label] = {"ms": ms, "sdpa_ms": lib, "bound_ms": b_ms}
        record("flash_packed", f"{label}: R={R} H={H} Hkv={Hkv} D={D} segs={seg_lens}+pad",
               err((out, ref)), ms=ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        del q, k, v, qt, kt, vt, out, ref

    # the engine's slot layout (6 slots of 128 rows): padding rows between
    # segments, every row compared (padding sees all earlier padding)
    sg = slot_segments(128, [300, 120, 40], 6, dev)
    q, k, v = randn(len(sg), 32, 128), randn(len(sg), 8, 128), randn(len(sg), 8, 128)
    for w in (None, 200):
        record("flash_packed" if w is None else "flash_packed_window",
               f"slots of 128, segs [300, 120, 40] + padding between, H=32 Hkv=8 D=128 "
               f"window={w} (all rows)",
               err((flash_attention_packed(q, k, v, sg, window=w),
                    flash_attention_packed_plain(q, k, v, sg, window=w))))
    del q, k, v

    # the lse output at the table's shape (32 heads, D = 128)
    H, D = 32, 128
    q, k, v = randn(R, H, D), randn(R, H, D), randn(R, H, D)
    o, lse = flash_attention_packed(q, k, v, seg, with_lse=True)
    o_ref, lse_ref = flash_attention_packed_plain(q, k, v, seg, with_lse=True)
    torch.cuda.synchronize()
    b_ms, b_by = bound(4 * R * H * D * 2 + R * 4 + R * H * 4, 4 * D * H * pairs)
    qt, kt, vt = (x.transpose(0, 1)[None] for x in (q, k, v))
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=dev).masked_fill(~mask, -torch.inf)
    bias = bias[None, None].expand(1, H, R, R)
    try:   # a private op: the yardstick is null where this build lacks it
        lib = time_ms(lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, bias, True))
    except (RuntimeError, AttributeError) as exc:
        print(f"flash_packed_lse: no library yardstick ({type(exc).__name__}: "
              f"{str(exc).splitlines()[0][:200]})", flush=True)
        lib = None
    record("flash_packed_lse", f"R={R} H={H} D={D} segs={seg_lens}+pad",
           with_lse_check(err((o, o_ref)), lse_err(lse, lse_ref)), row=True,
           ms=time_ms(lambda: flash_attention_packed(q, k, v, seg, with_lse=True)),
           plain_ms=time_ms(lambda: flash_attention_packed_plain(q, k, v, seg, with_lse=True),
                            5, 1),
           library_ms=lib, library_covers="aten._scaled_dot_product_efficient_attention "
           "(o and lse) with the mask as a -inf float bias",
           bound_ms=b_ms, bound_by=b_by)
    del q, k, v, qt, kt, vt, bias, o, lse, o_ref, lse_ref

    # the poison checks: tiles no row of a q-block sees are never read
    def poisoned(seg_lens, window, dead, rows):
        H, Hkv, D = 32, 8, 128
        sg = packed_segments(R, seg_lens, dev)
        q, k, v = randn(R, H, D), randn(R, Hkv, D), randn(R, Hkv, D)
        clean = flash_attention_packed(q, k, v, sg, window=window)
        k[dead], v[dead] = float("nan"), float("nan")
        dirty = flash_attention_packed(q, k, v, sg, window=window)
        torch.cuda.synchronize()
        same = torch.equal(clean[rows].view(torch.int16), dirty[rows].view(torch.int16))
        case = (f"segs={seg_lens}+pad window={window}: K/V rows {dead.start}..{dead.stop - 1} "
                f"NaN, rows {rows.start}..{rows.stop - 1} bitwise equal")
        print("k2-poison " + json.dumps({"case": case, "bitwise_equal": same,
                                         "finite": bool(torch.isfinite(dirty[rows]).all())}),
              flush=True)
        if not same:
            raise AssertionError(f"flash_packed read tiles it should skip: {case}")

    # segment 0 ends at row 128: later segments' warps start at its end, and
    # the warps with padding rows (from row 728) at the first padding key
    poisoned([128, 300, 200, 100], None, slice(0, 128), slice(128, 728))
    # one 700-row segment, window 200: q-blocks from row 512 start at key 256
    poisoned([700], 200, slice(0, 256), slice(512, 700))

    attrs = k2_attributes()
    print("k2-kernels " + json.dumps({"attributes": attrs, "timed": timed,
                                      "device": torch.cuda.get_device_name(0)}), flush=True)
    spills = {k: a["local_bytes"] for k, a in attrs.items() if a["local_bytes"]}
    if spills:
        raise AssertionError(f"K2 spills to local memory: {spills}")


# K5, the decode kernel and K7 at phi-2's head dim (32/32 heads, D = 80) and
# GPT-NeoX-20B's (64/64, D = 96): pages of 128, contexts at phase 13's
# prompts' ends
HD_CASES = (("phi-2", 32, 32, 80), ("GPT-NeoX-20B", 64, 64, 96))
HD_CTXS = [1532, 632, 232, 72]
HD_BS, HD_MB = 128, 16


def check_head_dims(dev, randn, record):
    """K5 (4 slots x 128 rows), the decode kernel (pages only and one side
    row) and K7 (2 splits with one side row; pages only with the merged
    lse) against their plain versions at head dims 80 and 96."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import (
        paged_chunk_attention_batched, paged_chunk_attention_batched_plain,
        paged_decode_attention, paged_decode_attention_plain,
        splitk_attention, splitk_attention_plain)
    bs, S = HD_BS, len(HD_CTXS)
    for label, H, Hkv, D in HD_CASES:
        NB = sum(-(-c // bs) for c in HD_CTXS) + 1
        bt = block_tables(HD_CTXS, bs, HD_MB, NB, dev)
        pool = randn(NB, 2, Hkv, bs, D)
        ctx = torch.tensor(HD_CTXS, dtype=torch.int32, device=dev)
        case = f"{label}: S={S} H={H} Hkv={Hkv} D={D} ctx={HD_CTXS} bs={bs}"
        Cs = 128
        qc = randn(S, Cs, H, D)
        q0 = torch.clamp(ctx - Cs, min=0)
        fn = lambda: paged_chunk_attention_batched(qc, pool, bt, q0, ctx)
        out = fn()
        ref = paged_chunk_attention_batched_plain(qc, pool, bt, q0, ctx)
        torch.cuda.synchronize()
        record("paged_chunk", f"{case} {S}x{Cs} rows", err((out, ref)), ms=time_ms(fn))
        qd = randn(S, H, D)
        lens1 = torch.clamp(ctx - 1, min=0)
        side = (randn(S, Hkv, D), randn(S, Hkv, D))
        for C in (0, 1):
            lens, sd = (lens1, side) if C else (ctx, ())
            record("paged_decode", f"{case} C={C}", err((
                paged_decode_attention(qd, pool, bt, lens, *sd),
                paged_decode_attention_plain(qd, pool, bt, lens, *sd))))
        record("paged_splitk/2", f"{case} 1 side row", err((
            splitk_attention(qd, pool, bt, lens1, 2, *side),
            splitk_attention_plain(qd, pool, bt, lens1, 2, *side))))
        o, lse = splitk_attention(qd, pool, bt, ctx, 2, with_lse=True)
        o_ref, lse_ref = splitk_attention_plain(qd, pool, bt, ctx, 2, with_lse=True)
        record("paged_splitk/2", f"{case} pages only, with lse",
               err((o, o_ref), (lse[..., None], lse_ref[..., None])))
        del pool
    torch.cuda.empty_cache()


# The decode kernel and K7's partials at shapes no main path gives them:
# pages of 16 and 64 (the CPU tests' engines) at Mistral-7B's heads (GQA
# 32/8, D = 128; bf16 and int8 pages), G = 8 at D = 256 (64 query heads
# over 8 kv heads; bf16 and int8) and D = 40 (padded to 64 in the
# kernels), each with a window of 200 and with ALiBi, pages only, one side
# row and C = 16 side rows; contexts with a row of one page and an empty
# row; and phases 15's and 16's heads (Qwen2-7B's G = 7 of the kernel's n =
# 8 columns, Gemma-7B's D = 256 at G = 1) on their pages of 128
PR_CTXS = [2000, 777, 130, 0]
PR_CASES = (("bs=16", 32, 8, 128, 16, False), ("bs=16 int8", 32, 8, 128, 16, True),
            ("bs=64", 32, 8, 128, 64, False), ("bs=64 int8", 32, 8, 128, 64, True),
            ("G=8 D=256", 64, 8, 256, 128, False), ("G=8 D=256 int8", 64, 8, 256, 128, True),
            ("D=40", 8, 4, 40, 64, False), ("G=7 (Qwen2-7B)", 28, 4, 128, 128, False),
            ("D=256 G=1 (Gemma-7B)", 16, 16, 256, 128, False))
PR_WINDOW = 200
PR_MODES = (({}, 0, 0), ({}, 1, 0), ({"window": PR_WINDOW}, 0, 0),
            ({"window": PR_WINDOW}, 16, 7), ({"alibi": True}, 0, 0),
            ({"alibi": True}, 16, 15))
PR_SPLITS = (2, 4, 8)
# block-table entries the paged-kernels line's attributes stage (phase 9's
# 128 pages at one piece)
PAGED_ATTR_CAP = 130
PAGED_DIMS = {0: (16, 32, 64, 80, 96, 128, 256), 1: (128, 256)}


def check_paged_shapes(dev, g, randn, record):
    """The decode kernel and K7 (2/4/8 splits) on PR_CASES x PR_MODES
    against their plain versions."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.kv_quant import (kv_quantize_rows,
                                                          kv_write_dequant,
                                                          scales_to_tiles)
    from deepspeed_tpu_torch.ops.kernels.paged_decode import (
        launch_name, paged_decode_attention, paged_decode_attention_plain)
    from deepspeed_tpu_torch.ops.kernels.paged_splitk import (
        kernel_name, splitk_attention, splitk_attention_plain)
    S = len(PR_CTXS)
    for label, H, Hkv, D, bs, quant in PR_CASES:
        MB = -(-max(PR_CTXS) // bs) + 1
        NB = sum(-(-c // bs) for c in PR_CTXS) + 2
        bt = block_tables(PR_CTXS, bs, MB, NB, dev)
        kw = {}
        if quant:
            x = torch.randn(NB, 2, Hkv, bs, D, generator=g, device=dev)
            pool, scl = kv_quantize_rows(x)
            kw["kv_scales"] = scales_to_tiles(scl).contiguous()
            del x, scl
        else:
            pool = randn(NB, 2, Hkv, bs, D)
        qd = randn(S, H, D)
        for mode, C, j in PR_MODES:
            lens = torch.tensor([max(c - C, 0) for c in PR_CTXS], dtype=torch.int32,
                                device=dev)
            side = ()
            if C:
                side = tuple(randn(S, C * Hkv, D) for _ in range(2))
                if quant:
                    side = tuple(kv_write_dequant(t.float()) for t in side)
            args = (qd, pool, bt, lens)
            case = (f"{label}: S={S} H={H} Hkv={Hkv} D={D} bs={bs} ctx={PR_CTXS} C={C} j={j} "
                    f"{mode}")
            name = launch_name(quant, mode.get("window"), mode.get("alibi", False), C)
            record(name, case, err((
                paged_decode_attention(*args, *side, j=j, **mode, **kw),
                paged_decode_attention_plain(*args, *side, j=j, **mode, **kw))))
            for n in PR_SPLITS:
                name = kernel_name(n, mode.get("window"), mode.get("alibi", False),
                                   side=C > 1, quant=quant)
                if C:
                    e = err((splitk_attention(*args, n, *side, j=j, **mode, **kw),
                             splitk_attention_plain(*args, n, *side, j=j, **mode, **kw)))
                else:
                    o, lse = splitk_attention(*args, n, with_lse=True, **mode, **kw)
                    o_ref, lse_ref = splitk_attention_plain(*args, n, with_lse=True, **mode,
                                                            **kw)
                    keep = lens > 0
                    e = err((o, o_ref), (lse[keep][..., None], lse_ref[keep][..., None]))
                record(name, case, e)
        del pool
    torch.cuda.empty_cache()


# K5 at shapes beside the main paths': pages of 16, 64 and 128, every head
# dim it is built for, G = 1, 2, 4, 8 and 71 (Falcon-7B's heads over one kv
# head), bf16 and int8 pages. Chunks of 96 rows (a q-tile of 64 (row, head)
# pairs does not divide them): slot 0 ends at its context, slot 1's rows run
# 56 past its context (a pass's unfilled slot), slot 2 starts at 34 (its
# rows straddle pages at every bs), slot 3 is empty. Each case runs with no
# window, a window of 200 over ring tables, and ALiBi. The last two are
# phases 15's and 16's heads on their pages of 128: Qwen2-7B's G = 7 (16 /
# G is no whole number of positions a warp) and Gemma-7B's D = 256.
CH_CTXS = [2000, 777, 130, 0]
CH_Q0 = [1904, 737, 34, 0]
CH_CS = 96
CH_CASES = (("bs=16 G=4", 32, 8, 128, 16, False), ("bs=16 G=4 int8", 32, 8, 128, 16, True),
            ("bs=64 G=4", 32, 8, 128, 64, False), ("bs=64 G=4 int8", 32, 8, 128, 64, True),
            ("D=16", 8, 8, 16, 16, False), ("D=32 G=4", 8, 2, 32, 16, False),
            ("D=64 G=71", 71, 1, 64, 64, False), ("D=80 G=4", 16, 4, 80, 16, False),
            ("D=96 G=2", 16, 8, 96, 64, False), ("G=8 D=256", 64, 8, 256, 128, False),
            ("G=8 D=256 int8", 64, 8, 256, 128, True),
            ("D=256 int8 bs=16 G=2", 16, 8, 256, 16, True),
            ("G=7 (Qwen2-7B)", 28, 4, 128, 128, False),
            ("D=256 G=1 (Gemma-7B)", 16, 16, 256, 128, False))
CH_WINDOW = 200
CH_MODES = ({}, {"window": CH_WINDOW}, {"alibi": True})


def check_chunk_shapes(dev, g, randn, record):
    """K5 on CH_CASES x CH_MODES against its plain version (the windowed
    mode through ring tables that repeat physical pages), and the empty
    slot's rows exactly zero."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import _loader
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_quantize_rows, scales_to_tiles
    from deepspeed_tpu_torch.ops.kernels.paged_chunk import (
        NAME, NAME_INT8, paged_chunk_attention_batched, paged_chunk_attention_batched_plain)
    S, Cs = len(CH_CTXS), CH_CS
    ctx = torch.tensor(CH_CTXS, dtype=torch.int32, device=dev)
    q0 = torch.tensor(CH_Q0, dtype=torch.int32, device=dev)
    for label, H, Hkv, D, bs, quant in CH_CASES:
        MB = -(-max(CH_CTXS) // bs) + 1
        ring = -(-(CH_WINDOW + Cs) // bs) + 1
        plain_bt = block_tables(CH_CTXS, bs, MB, sum(-(-c // bs) for c in CH_CTXS) + 2, dev)
        ring_bt, ring_nb = ring_tables(CH_CTXS, bs, MB, ring, dev)
        NB = max(int(plain_bt.max()), ring_nb) + 1
        kw = {}
        if quant:
            x = torch.randn(NB, 2, Hkv, bs, D, generator=g, device=dev)
            pool, scl = kv_quantize_rows(x)
            kw["kv_scales"] = scales_to_tiles(scl).contiguous()
            del x, scl
        else:
            pool = randn(NB, 2, Hkv, bs, D)
        qc = randn(S, Cs, H, D)
        for mode in CH_MODES:
            bt = ring_bt if "window" in mode else plain_bt
            args = (qc, pool, bt, q0, ctx)
            out = paged_chunk_attention_batched(*args, **mode, **kw)
            ref = paged_chunk_attention_batched_plain(*args, **mode, **kw)
            torch.cuda.synchronize()
            if float(out[-1].float().abs().max()) != 0.0:
                raise AssertionError(f"paged_chunk {label} {mode}: the empty slot is not zero")
            name = _loader.variant(NAME_INT8 if quant else NAME, mode.get("window"),
                                   mode.get("alibi", False))
            record(name, f"{label}: S={S}x{Cs} rows H={H} Hkv={Hkv} D={D} bs={bs} "
                         f"ctx={CH_CTXS} q0={CH_Q0} {mode}", err((out, ref)))
        del pool, kw
    torch.cuda.empty_cache()


# K5 at the verify step's shapes (phase 17): S = 8 sequences of k + 1 rows
# (Cs = 2, 4, 8: k = 1, 3, 7), 32 query heads over 32 or 8 kv heads, pages of
# 128, bf16 and int8. Slot 1 starts mid-page with its rows across the page
# boundary at 128; the others sit at the contexts of phase 17's sequences.
# The k = 3 case (Hkv = 32, bf16) is the kernel table's verify row; Cs = 3
# (k = 2) is timed beside it, the k + 1 that is no power of two.
V_Q0 = [575, None, 1090, 1250, 700, 513, 1023, 640]
V_CS = (2, 4, 8)
V_BS = 128


def verify_starts(Cs):
    return [q if q is not None else V_BS - Cs // 2 for q in V_Q0]


def check_verify_shapes(dev, g, randn, record):
    """K5 over verify-shaped slots against its plain version (each rerun
    bitwise under ``bitwise_reruns``); times the k = 3 row and Cs = 3 beside
    it, and prints the ``k5-verify`` line."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_quantize_rows, scales_to_tiles
    from deepspeed_tpu_torch.ops.kernels.paged_chunk import (
        paged_chunk_attention_batched, paged_chunk_attention_batched_plain)
    H, D, S = 32, 128, len(V_Q0)
    times = {}
    for Hkv in (32, 8):
        for quant in (False, True):
            for Cs in V_CS + ((3,) if Hkv == 32 and not quant else ()):
                q0 = verify_starts(Cs)
                ctxs = [q + Cs for q in q0]
                MB = -(-max(ctxs) // V_BS) + 1
                NB = sum(-(-c // V_BS) for c in ctxs) + 2
                bt = block_tables(ctxs, V_BS, MB, NB, dev)
                kw = {}
                if quant:
                    x = torch.randn(NB, 2, Hkv, V_BS, D, generator=g, device=dev)
                    pool, scl = kv_quantize_rows(x)
                    kw["kv_scales"] = scales_to_tiles(scl).contiguous()
                    del x, scl
                else:
                    pool = randn(NB, 2, Hkv, V_BS, D)
                qc = randn(S, Cs, H, D)
                args = (qc, pool, bt, torch.tensor(q0, dtype=torch.int32, device=dev),
                        torch.tensor(ctxs, dtype=torch.int32, device=dev))
                out = paged_chunk_attention_batched(*args, **kw)
                ref = paged_chunk_attention_batched_plain(*args, **kw)
                torch.cuda.synchronize()
                name = "paged_chunk_int8" if quant else "paged_chunk"
                case = (f"verify k={Cs - 1}: S={S}x{Cs} rows H={H} Hkv={Hkv} D={D} bs={V_BS} "
                        f"q0={q0}")
                timed = Hkv == 32 and not quant and Cs in (3, 4)
                extra = {}
                if timed:
                    vis = sum(q + r + 1 for q in q0 for r in range(Cs))
                    nbytes = 2 * qc.numel() * 2 + sum(ctxs) * Hkv * D * 2 * 2 \
                        + bt.numel() * 4 + 2 * S * 4
                    b_ms, b_by = bound(nbytes, 4 * D * H * vis)
                    extra = dict(ms=time_ms(lambda: paged_chunk_attention_batched(*args)),
                                 plain_ms=time_ms(lambda: paged_chunk_attention_batched_plain(
                                     *args), 5, 1),
                                 library_ms=None, bound_ms=b_ms, bound_by=b_by)
                    times[f"Cs={Cs}"] = extra
                if Cs == 4 and timed:
                    record("paged_chunk_verify", case, err((out, ref)), row=True, **extra)
                record(name, case, err((out, ref)))
                del pool, kw
    print("k5-verify " + json.dumps({"cases": times, "nvidia_smi": smi_line()}), flush=True)
    torch.cuda.empty_cache()


def paged_attributes(dev):
    """The ``paged-kernels`` line: each instance of K5 (with and without
    ALiBi), the decode kernel and K7's partials kernel (registers, spill
    bytes, shared memory, blocks an SM at PAGED_ATTR_CAP table entries),
    the decode kernel's cluster size and K5's block count at each main
    path's shape, and the bitwise reruns phase 3 made; a spill fails the
    run."""
    from deepspeed_tpu_torch.ops.kernels import _loader
    from deepspeed_tpu_torch.ops.kernels.paged_chunk import chunk_grid
    from deepspeed_tpu_torch.ops.kernels.paged_decode import cluster_ranks
    attrs = {}
    for int8, dims in PAGED_DIMS.items():
        for D in dims:
            for alibi in (0, 1):
                attrs[f"chunk/{'int8' if int8 else 'bf16'}/D{D}{'/alibi' if alibi else ''}"] = \
                    read_attributes("dstorch_paged_chunk_attrs", int8, D, alibi,
                                    PAGED_ATTR_CAP)
    for kind in ("decode", "splitk"):
        for int8, dims in PAGED_DIMS.items():
            for D in dims:
                attrs[f"{kind}/{'int8' if int8 else 'bf16'}/D{D}"] = read_attributes(
                    f"dstorch_paged_{kind}_attrs", int8, D, PAGED_ATTR_CAP)
    # K5's blocks at each main path's pass: (slots, rows a slot, H, Hkv)
    passes = (("Llama-2-7B", 6, 128, 32, 32), ("Llama-2-7B verify k=3", 8, 4, 32, 32),
              ("Llama-2-7B verify k=7", 8, 8, 32, 32), ("Llama-2-13B int8", 6, 128, 40, 40),
              ("Mistral-7B", 64, 128, 32, 8), ("BLOOM-560M", 6, 128, 16, 16),
              ("BLOOM-7b1 int8", 6, 128, 32, 32), ("phi-2", 6, 128, 32, 32))
    blocks = {f"{k} {NC}x{Cs} H={H} Hkv={Hkv}": int(np.prod(chunk_grid(NC, Cs, H, Hkv)))
              for k, NC, Cs, H, Hkv in passes}
    sms = _loader.sm_count(dev)
    shapes = (("Llama-2-7B", 4, 32, False), ("Llama-2-13B int8", 4, 40, True),
              ("Mistral-7B", 4, 8, False), ("Mistral-7B int8", 4, 8, True),
              ("BLOOM-560M", 4, 16, False), ("BLOOM-7b1 int8", 4, 32, True),
              ("phi-2", 4, 32, False), ("S=32", 32, 32, False), ("G=8 D=256", 4, 8, False))
    print("paged-kernels " + json.dumps({
        "sms": sms, "cluster_ranks": {f"{k} S={S} Hkv={Hkv}": cluster_ranks(S, Hkv, sms, q8)
                                      for k, S, Hkv, q8 in shapes},
        "chunk_blocks": blocks, "bitwise_reruns": RERUNS["checked"],
        "attributes": attrs}), flush=True)
    spills = {k: a["local_bytes"] for k, a in attrs.items() if a["local_bytes"]}
    if spills:
        raise AssertionError(f"paged kernels spill to local memory: {spills}")


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


def read_attributes(entry: str, *args) -> dict:
    """One kernel's ``cudaFuncGetAttributes`` (registers, local spill bytes,
    shared memory) and resident blocks per SM, through the C entry
    ``entry(*args, int[6])``."""
    import ctypes
    from deepspeed_tpu_torch.ops.kernels import _loader
    buf = (ctypes.c_int * len(K1_ATTRS))()
    rc = getattr(_loader.load_library(), entry)(*args, ctypes.cast(buf, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{entry}{args}: {rc}")
    return dict(zip(K1_ATTRS, list(buf)))


def k1_attributes() -> dict:
    """K1's three kernels as compiled, at each head dim, through
    ``dstorch_flash_kernel_attrs``."""
    return {f"{name}/D{D}": read_attributes("dstorch_flash_kernel_attrs", i, D)
            for i, name in enumerate(K1_NAMES) for D in K1_HEAD_DIMS}


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
# q/k/v/o, gate/up, down and the LM head, and gate/up at M = 1, 2, 3, 5 and
# 8; GPT-J's LM head (4096 -> 50400: 50400 columns are not a multiple of
# the gemv's 128-column blocks); then qmm_mma at every projection
# a prefill pass gives it: 13B's q/k/v/o, gate/up and down at M = 736, the
# unpacked int4 weights of Mistral-7B (q/o, k/v, gate/up, down) at M = 4224,
# BLOOM-7b1's (qkv, o, fc1, fc2) and phi-2's (q/k/v/dense, fc1, fc2) at M =
# 736; M = 9, 63 and 130, and a K (4128) that 64 does not divide. The
# kernel table keeps one shape per kernel.
QMM_SHAPES = ((4, 5120, 5120), (4, 5120, 13824), (4, 13824, 5120), (4, 5120, 32000),
              (1, 5120, 13824), (2, 5120, 13824), (3, 5120, 13824), (5, 5120, 13824),
              (8, 5120, 13824), (4, 4096, 50400),
              (736, 5120, 5120), (736, 5120, 13824), (736, 13824, 5120),
              (4224, 4096, 4096), (4224, 4096, 1024), (4224, 4096, 14336),
              (4224, 14336, 4096),
              (736, 4096, 12288), (736, 4096, 4096), (736, 4096, 16384), (736, 16384, 4096),
              (736, 2560, 2560), (736, 2560, 10240), (736, 10240, 2560),
              (9, 5120, 5120), (63, 5120, 13824), (130, 5120, 13824), (736, 4128, 5120))
QMM_ROWS = {"quantized_matmul_gemv": (4, 5120, 13824),
            "quantized_matmul_mma": (736, 5120, 13824)}
QMM_TILES = (128, 256)     # qmm_mma's token tiles, both timed at the row's shape
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
        again = quantized_matmul(a, w8, sc)
        torch.cuda.synchronize()
        name = GEMV if M <= GEMV_MAX_M else MMA
        if not torch.equal(out, again):
            raise AssertionError(f"{name} M={M} K={K} N={N}: two runs differ")
        row = (M, K, N) == QMM_ROWS[name]
        b_ms, b_by = bound(K * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
        record(name, f"M={M} K={K} N={N}", err((out, ref)), row=row,
               ms=time_ms(lambda: quantized_matmul(a, w8, sc)),
               plain_ms=(time_ms(lambda: quantized_matmul_plain(a, w8, sc), 5, 1)
                         if row else None),
               library_ms=time_ms(lambda: torch.matmul(a, wb)),
               library_covers="torch.matmul on the bf16 weight of the same shape "
                              "(twice the weight bytes)",
               bound_ms=b_ms, bound_by=b_by, bitwise_equal_rerun=True)
        if row and name == MMA:
            qmm_tiles(a, w8, sc, out)
        del w8, sc, wb
    gemv_attributes(dev)
    qmm_refusals(dev)
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


def qmm_tiles(a, w8, sc, want):
    """qmm_mma at each token tile (``dstorch_qmm_mma_tiled``) on the kernel
    row's inputs: the same bits as the entry's pick, each tile's time, and
    the kernel's registers and spills (a spill fails the run)."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import _loader
    lib, P = _loader.load_library(), _loader.ptr
    M, K = a.shape
    N = w8.shape[1]
    s = sc.reshape(N)
    line = {}
    for tm in QMM_TILES:
        out = torch.empty_like(want)

        def run():
            rc = lib.dstorch_qmm_mma_tiled(P(a), P(w8), P(s), P(out), M, K, N, tm,
                                           torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"qmm_mma tile {tm}: {rc}")

        run()
        torch.cuda.synchronize()
        line[f"tile_{tm}"] = {"same_as_entry": bool(torch.equal(out, want)) if tm == (
            128 if M <= 128 else 256) else None, "ms": time_ms(run),
            "attributes": read_attributes("dstorch_qmm_mma_attrs", tm)}
    print("k8-kernels " + json.dumps({"kernel": "qmm_mma", "shape": [M, K, N], **line}),
          flush=True)
    if any(v["same_as_entry"] is False for v in line.values()):
        raise AssertionError("qmm_mma: the tiled entry differs from dstorch_qmm_mma")
    spills = {k: v["attributes"]["local_bytes"] for k, v in line.items()
              if v["attributes"]["local_bytes"]}
    if spills:
        raise AssertionError(f"qmm_mma spills to local memory: {spills}")


def gemv_attributes(dev):
    """The ``k8-kernels`` line of qmm_gemv: every instance's attributes
    (int8 and packed int4 at M 1..8, with the split plan at the kernel
    row's K and N); a spill fails the run."""
    from deepspeed_tpu_torch.ops.kernels import _loader
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import (
        GEMV, GEMV_MAX_M, gemv_splits)
    _, K, N = QMM_ROWS[GEMV]
    attrs = {f"M={M}/{v}": read_attributes("dstorch_qmm_gemv_attrs", M, int4)
             for M in range(1, GEMV_MAX_M + 1) for v, int4 in (("int8", 0), ("int4", 1))}
    print("k8-kernels " + json.dumps({"kernel": "qmm_gemv", "shape": [K, N],
                                      "splits": list(gemv_splits(K, N, _loader.sm_count(dev))),
                                      "attributes": attrs}), flush=True)
    spills = {k: a["local_bytes"] for k, a in attrs.items() if a["local_bytes"]}
    if spills:
        raise AssertionError(f"qmm_gemv spills to local memory: {spills}")


def qmm_refusals(dev):
    """The shapes qmm_mma refuses (K % 32, N % 16) raise and count nothing."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul
    before = dict(LAUNCHES)
    for M, K, N in ((64, 48, 128), (64, 64, 40)):
        a = torch.zeros(M, K, dtype=torch.bfloat16, device=dev)
        w8 = torch.zeros(K, N, dtype=torch.int8, device=dev)
        try:
            quantized_matmul(a, w8, torch.ones(N, device=dev))
        except RuntimeError as e:
            print(f"refusal ok: qmm_mma M={M} K={K} N={N}: {e}", flush=True)
        else:
            raise AssertionError(f"qmm_mma took K={K} N={N} without raising")
    if dict(LAUNCHES) != before:
        raise AssertionError("a refused K8 call counted a launch")


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
    seg = packed_segments(R, seg_lens, dev)
    q, k, v = randn(R, H, D), randn(R, Hkv, D), randn(R, Hkv, D)
    idx = torch.arange(R, device=dev)
    for w in (W, W_SHORT):
        out = flash_attention_packed(q, k, v, seg, window=w)
        ref = flash_attention_packed_plain(q, k, v, seg, window=w)
        torch.cuda.synchronize()
        case = f"R={R} H={H} Hkv={Hkv} D={D} segs={seg_lens}+pad window={w}"
        extra = {}
        if w == W:
            pairs = packed_pairs(R, seg_lens, w)
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
    # the lse output under the window of 4096 (counts as flash_packed_window_lse)
    out, lse = flash_attention_packed(q, k, v, seg, window=W, with_lse=True)
    ref, lse_ref = flash_attention_packed_plain(q, k, v, seg, window=W, with_lse=True)
    torch.cuda.synchronize()
    record("flash_packed_lse", f"R={R} H={H} Hkv={Hkv} D={D} segs={seg_lens}+pad window={W}",
           with_lse_check(err((out[rows_], ref[rows_])), lse_err(lse[rows_], lse_ref[rows_])))
    del q, k, v, out, ref, lse, lse_ref
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
    lse_launches = launches["flash_packed_lse"]
    launches = {k: launches[k] for k in ("flash_packed", "paged_chunk", "paged_decode")}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    # no caller in the engine asks K2 for its lse: 0 launches on the main path
    launches["flash_packed_lse"] = lse_launches
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
    continuation_pass(engine, "Llama-2-7B", P_NAMES)
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


# K8 over packed int4 weights at Mistral-7B's gate/up projection: M = 4
# (the decode batch: qmm_gemv reads the packed bytes) and M = 4224 (the
# windowed prefill pass: unpack, then qmm_mma)
QMM4_SHAPES = ((4, 4096, 14336), (4224, 4096, 14336))


def check_int4_matmul(dev, g, randn, record):
    """``_mm`` over a packed int4 weight against the plain version, timed
    beside the unpack (torch ops), K8 on the unpacked values and both
    together. At M = 4 the kernel reads the packed bytes
    (``quantized_matmul_int4``, the kernel table's row), and must give the
    bits of unpack + ``qmm_gemv`` and of its own rerun; at M = 4224 it is
    unpack + ``qmm_mma``. The bound counts the packed weight's K*N/2
    bytes."""
    import torch
    from deepspeed_tpu_torch.inference.v2.ragged_model import _mm, quantize_weight_int4
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import (
        GEMV_INT4, GEMV_MAX_M, MMA, quantized_matmul, quantized_matmul_int4_plain,
        quantized_matmul_plain)
    from deepspeed_tpu_torch.ops.quantizer import unpack_int4
    for M, K, N in QMM4_SHAPES:
        a = randn(M, K)
        w = torch.randn(K, N, generator=g, device=dev) * K ** -0.5
        qd = quantize_weight_int4(w)
        wb = w.to(torch.bfloat16)
        del w
        w4, sc = qd["w4"], qd["scale"]
        w8 = unpack_int4(w4)
        out, ref = _mm(a, qd), quantized_matmul_plain(a, w8, sc)
        unpacked, again = quantized_matmul(a, w8, sc), _mm(a, qd)
        torch.cuda.synchronize()
        fused = M <= GEMV_MAX_M
        same = bool(torch.equal(out, unpacked) and torch.equal(out, again))
        if fused and not same:
            raise AssertionError(f"int4 gemv M={M} K={K} N={N}: not the bits of unpack + "
                                 "qmm_gemv and of its own rerun")
        b_ms, b_by = bound(K * N // 2 + 4 * N + 2 * M * K + 2 * M * N, 2 * M * K * N)
        record(GEMV_INT4 if fused else MMA,
               f"int4 M={M} K={K} N={N} " + ("packed, in the kernel" if fused else "unpacked"),
               err((out, ref)), row=fused, ms=time_ms(lambda: _mm(a, qd)),
               plain_ms=time_ms(lambda: quantized_matmul_int4_plain(a, w4, sc), 5, 1),
               library_ms=time_ms(lambda: torch.matmul(a, wb)),
               library_covers="torch.matmul on the bf16 weight of the same shape (four "
                              "times the packed weight's bytes)",
               bound_ms=b_ms, bound_by=b_by, bitwise_equal_unpacked_route=same,
               unpack_ms=time_ms(lambda: unpack_int4(w4)),
               k8_unpacked_ms=time_ms(lambda: quantized_matmul(a, w8, sc)),
               unpack_then_k8_ms=time_ms(lambda: quantized_matmul(a, unpack_int4(w4), sc)))
        del qd, wb, w8, w4


# K8's grouped entries at Mixtral-8x7B's expert shapes (hidden 4096, FFN
# 14336, 8 experts): rows per expert (sorted by expert) as a decode step of
# 4 sequences routes them top-2 (5 experts routed, 3 with none), one
# sequence (2 rows), 32 rows in one expert (four passes of 8), 11 rows over
# two experts, and a prefill pass of 736 tokens (1472 rows, skewed, one
# expert with none; one expert with all); 33 rows (the first past the
# gemv); a K that 64 does not divide. The kernel table keeps the decode
# step's gate/up for the gemv and the prefill pass's gate/up for qmm_mma.
MOE_HID, MOE_FF, MOE_E = 4096, 14336, 8
GROUPED_CASES = (
    ("decode S=4 gate/up", (2, 0, 1, 1, 3, 0, 1, 0), MOE_HID, MOE_FF),
    ("decode S=4 down", (2, 0, 1, 1, 3, 0, 1, 0), MOE_FF, MOE_HID),
    ("decode S=1 gate/up", (0, 0, 1, 0, 0, 0, 1, 0), MOE_HID, MOE_FF),
    ("decode S=1 down", (0, 0, 1, 0, 0, 0, 1, 0), MOE_FF, MOE_HID),
    ("32 rows in one expert", (0, 0, 0, 32, 0, 0, 0, 0), MOE_HID, MOE_FF),
    ("11 rows", (3, 0, 8, 0, 0, 0, 0, 0), MOE_FF, MOE_HID),
    ("33 rows", (1, 0, 0, 32, 0, 0, 0, 0), MOE_HID, MOE_FF),
    ("prefill 736 gate/up", (400, 0, 300, 172, 100, 250, 150, 100), MOE_HID, MOE_FF),
    ("prefill 736 down", (400, 0, 300, 172, 100, 250, 150, 100), MOE_FF, MOE_HID),
    ("prefill all in one expert", (0, 0, 0, 0, 0, 0, 0, 1472), MOE_FF, MOE_HID),
    ("K=4128 (64 does not divide)", (100, 0, 200, 3), 4128, 256),
)
GROUPED_ROWS = {"quantized_matmul_grouped_gemv": "decode S=4 gate/up",
                "quantized_matmul_grouped_mma": "prefill 736 gate/up"}


def check_grouped_matmul(dev, g, randn, record):
    """K8's grouped entries against their plain version (each expert's rows
    through ``quantized_matmul_plain``) at GROUPED_CASES, each rerun and
    required bitwise equal; timed at the table's rows beside
    ``torch._grouped_mm`` on the bf16 weights, with the bound counted over
    the routed experts' bytes; the ``k8-grouped`` attributes line (a spill
    fails the run)."""
    import torch
    from deepspeed_tpu_torch.inference.v2.ragged_model import quantize_weight_int8
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import (
        GROUPED_GEMV, GROUPED_GEMV_MAX_R, GROUPED_MMA, quantized_matmul_grouped,
        quantized_matmul_grouped_plain)
    weights = {}
    for label, counts, K, N in GROUPED_CASES:
        E, R = len(counts), sum(counts)
        if (E, K, N) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            w = torch.randn(E, K, N, generator=g, device=dev) * K ** -0.5
            weights[(E, K, N)] = (quantize_weight_int8(w), w.to(torch.bfloat16))
            del w
        qd, wb = weights[(E, K, N)]
        w8, sc = qd["w8"], qd["scale"]
        a = randn(R, K)
        ends = torch.tensor(np.cumsum(counts), dtype=torch.int32, device=dev)
        out = quantized_matmul_grouped(a, ends, w8, sc)
        again = quantized_matmul_grouped(a, ends, w8, sc)
        ref = quantized_matmul_grouped_plain(a, ends, w8, sc)
        torch.cuda.synchronize()
        name = GROUPED_GEMV if R <= GROUPED_GEMV_MAX_R else GROUPED_MMA
        if not torch.equal(out, again):
            raise AssertionError(f"{name} {label}: two runs differ")
        row = GROUPED_ROWS[name] == label
        routed = sum(1 for c in counts if c)
        b_ms, b_by = bound(routed * (K * N + 4 * N) + 2 * R * K + 2 * R * N + 4 * E,
                           2 * R * K * N)
        extra = {}
        if row:
            extra = dict(ms=time_ms(lambda: quantized_matmul_grouped(a, ends, w8, sc)),
                         plain_ms=time_ms(lambda: quantized_matmul_grouped_plain(
                             a, ends, w8, sc), 5, 1),
                         library_ms=time_ms(lambda: torch._grouped_mm(a, wb, offs=ends)),
                         library_covers="torch._grouped_mm on the bf16 expert weights "
                                        "(twice the weight bytes)",
                         bound_ms=b_ms, bound_by=b_by)
        record(name, f"{label}: R={R} K={K} N={N} rows per expert {list(counts)}",
               err((out, ref)), row=row, routed_experts=routed, bitwise_equal_rerun=True,
               **extra)
    weights.clear()
    attrs = {n: read_attributes("dstorch_qmm_grouped_attrs", k)
             for k, n in enumerate((GROUPED_GEMV, GROUPED_MMA))}
    print("k8-grouped " + json.dumps({"gemv_max_rows": GROUPED_GEMV_MAX_R,
                                      "attributes": attrs}), flush=True)
    spills = {k: a_["local_bytes"] for k, a_ in attrs.items() if a_["local_bytes"]}
    if spills:
        raise AssertionError(f"K8's grouped kernels spill to local memory: {spills}")


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


def dense_quant_logits(engine, cfg, ids, rows, dt, n_full=0, kv_int8=True, routes=None,
                       forced=None):
    """What the engine computes, as a dense causal forward over one token
    sequence ``ids`` [T]: every projection is ``_mm``'s function over the
    engine's own weights (int8: f32 sum, column scale, result in ``dt``; a
    plain weight cast to ``dt`` as its matmul runs),
    and attention reads K and V at the values the int8 pages store
    (``kv_write_dequant``; at full precision with ``kv_int8=False``, a
    model-dtype pool), except for the first ``n_full`` positions when
    the sequence began in a prefill-from-zero pass of that many tokens:
    that pass attends its own rows at full precision and only writes the
    pages quantized (as the JAX engine does). An MoE layer routes each
    token to its top-k experts by f32 router logits (softmax over the k)
    and adds their FFNs over the engine's own int8 expert stacks, one
    expert at a time (:func:`dense_moe`; ``forced`` [L, T, k], the experts
    to use instead, and ``routes`` as there). Weights dequantize one
    matmul at a time, so no f32 copy of the model exists. Returns f32
    logits at positions ``rows``."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.models.llama import apply_rope, rms_norm, rope_tables
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_write_dequant
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul_plain

    def mm(x, w):
        if isinstance(w, dict):
            return quantized_matmul_plain(x, w["w8"], w["scale"])
        return x @ w.to(dt)

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
    for l, w in enumerate(W["layers"]):
        h = rms_norm(x, w["ln1"], eps, dt)
        q = apply_rope(mm(h, w["wq"]).view(T, H, D), cos, sin)
        k = apply_rope(mm(h, w["wk"]).view(T, Hkv, D), cos, sin)
        v = mm(h, w["wv"]).view(T, Hkv, D)
        if kv_int8:
            o = attend(q, kv_write_dequant(k).to(dt), kv_write_dequant(v).to(dt))
            if n_full:
                o[:n_full] = attend(q[:n_full], k[:n_full], v[:n_full])
        else:
            o = attend(q, k, v)
        x = x + mm(o.reshape(T, H * D), w["wo"])
        h = rms_norm(x, w["ln2"], eps, dt)
        if "moe" in w:
            x = x + dense_moe(h, w["moe"], cfg.num_experts_per_tok, mm, routes,
                              None if forced is None else forced[l])
        else:
            x = x + mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])
    x = rms_norm(x[rows], W["final_norm"], eps, dt)
    return mm(x, W["lm_head"]).float()


def dense_moe(h, m, k, mm, routes=None, forced=None):
    """One MoE layer over rows ``h`` [T, hidden] in h's dtype: f32 router
    logits, the top ``k`` (or the experts ``forced`` [T, k]) with a
    softmax over their logits, each expert's rows through ``mm`` over its
    int8 weights ``m[key]["w8"][e]``, weighted in h's dtype and added per
    token. ``routes``, a list, gets this layer's own choice: ``{"own": top
    k ids [T, k], "margin": the k-th logit less the next [T]}``."""
    import torch
    import torch.nn.functional as F
    logits = h.float() @ m["router"].float()
    top = torch.topk(logits, min(k + 1, logits.shape[-1]), dim=-1)
    ids = top.indices[:, :k] if forced is None else forced
    gates = torch.softmax(logits.gather(1, ids), dim=-1)
    if routes is not None:
        routes.append({"own": top.indices[:, :k],
                       "margin": top.values[:, k - 1] - top.values[:, -1]})
    out = torch.zeros_like(h)
    for e in range(m["w_gate"]["w8"].shape[0]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            ex = {key: {"w8": m[key]["w8"][e], "scale": m[key]["scale"][e]}
                  for key in ("w_gate", "w_up", "w_down")}
            xe = h[tok]
            y = mm(F.silu(mm(xe, ex["w_gate"])) * mm(xe, ex["w_up"]), ex["w_down"])
            out.index_add_(0, tok, y * gates[tok, slot, None].to(h.dtype))
    return out


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
    continuation_pass(engine, "Llama-2-13B int8", Q_NAMES)
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
    same_bits(label, (dq, dk, dv), (block_sparse_dq(q, k, v, do, lse, delta, tables, scale),
                                    *block_sparse_dkv(q, k, v, do, lse, delta, tables, scale)))
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


def same_bits(label, first, second):
    """The K9 and K10 kernels are deterministic: a rerun gives the same bits."""
    import torch
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{label}: two runs of the kernels differ")


# K9 per head dim and mask: the layouts of sparse_cases (A, B and C at S =
# 4096, the two ragged shapes) at B = 1, D 16/32/64/128, with and without
# causal (the layout's own tables with the flag flipped), and a hand-made
# layout (S = 256, blocks of 16) where one 64-tile holds a single active
# 16-block and one query band, and the keys of one band, see nothing at all
K9_DIMS = (16, 32, 64, 128)


def handmade_layout():
    """[1, 16, 16]: the diagonal but block 6; one block (5, 11) in tile
    (1, 2); row 12 over blocks 0-3; block (0, 15) above the diagonal. Band
    2 of q-tile 1 (queries 96-111) sees no key, and no query sees keys
    96-111."""
    layout = np.eye(16, dtype=np.int64)
    layout[6, 6] = 0
    layout[5, 11] = 1
    layout[12, 0:4] = 1
    layout[0, 15] = 1
    return layout[None]


def check_sparse_dims(randn, record):
    """K9's forward (o, lse), dq and dk/dv against their plain versions (the
    backward ones fed the kernel forward's lse) at every head dim, causal
    and not, on phase 7's layouts and the hand-made one (whose empty rows
    must get exactly o = 0 and lse = -1e30, and whose empty rows and keys
    exactly zero gradients); each rerun and required bitwise equal. Prints
    the ``k9-kernels`` line (registers, spills, shared memory) and fails on
    a spill."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import (
        block_sparse_delta, block_sparse_dkv, block_sparse_dkv_plain, block_sparse_dq,
        block_sparse_dq_plain, block_sparse_fwd, block_sparse_fwd_plain, get_tables)
    H = SPARSE_H
    layouts = [(label, cfg.make_layout(S), cfg.block) for label, cfg, S, _, _ in sparse_cases()]
    layouts.append(("hand-made", np.repeat(handmade_layout(), H, 0), 16))
    for label, layout, block in layouts:
        S = layout.shape[1] * block
        for causal, D in itertools.product((False, True), K9_DIMS):
            if label == "hand-made" and D not in (64, 128):
                continue
            tables = get_tables(layout, block, causal, S, "cuda")
            scale = D ** -0.5
            q, k, v, do = (randn(1, H, S, D) for _ in range(4))
            o, lse = block_sparse_fwd(q, k, v, tables, scale)
            case = f"{label}: B=1 H={H} S={S} D={D} {'causal' if causal else 'full'}"
            same_bits(case, (o, lse), block_sparse_fwd(q, k, v, tables, scale))
            o_ref, lse_ref = block_sparse_fwd_plain(q, k, v, tables, scale)
            record("block_sparse_fwd", case, err((o, o_ref), (lse[..., None], lse_ref[..., None])))
            if label == "hand-made":
                empty = o[:, :, 96:112]
                dead = {"max_abs_o": float(empty.abs().max()),
                        "lse": sorted({float(x) for x in lse[:, :, 96:112].flatten()})}
                print("k9-empty-rows " + json.dumps({"case": case, "forward": dead}),
                      flush=True)
                if dead["max_abs_o"] != 0.0 or dead["lse"] != [float(np.float32(-1e30))]:
                    raise AssertionError(f"{case}: rows that see nothing got {dead}")
            delta = block_sparse_delta(o, do)
            dq = block_sparse_dq(q, k, v, do, lse, delta, tables, scale)
            dk, dv = block_sparse_dkv(q, k, v, do, lse, delta, tables, scale)
            same_bits(case, (dq, dk, dv), (
                block_sparse_dq(q, k, v, do, lse, delta, tables, scale),
                *block_sparse_dkv(q, k, v, do, lse, delta, tables, scale)))
            record("block_sparse_dq", case, err((dq, block_sparse_dq_plain(
                q, k, v, do, lse, delta, tables, scale))))
            record("block_sparse_dkv", case, err(*zip(
                (dk, dv), block_sparse_dkv_plain(q, k, v, do, lse, delta, tables, scale))))
            if label == "hand-made":
                zero = (float(dq[:, :, 96:112].abs().max()), float(dk[:, :, 96:112].abs().max()),
                        float(dv[:, :, 96:112].abs().max()))
                print("k9-empty-rows " + json.dumps({"case": case, "max_abs_dq_dk_dv": zero}),
                      flush=True)
                if any(zero):
                    raise AssertionError(f"{case}: rows or keys that see nothing got "
                                         f"gradients {zero}")
            del q, k, v, do, o, lse, o_ref, lse_ref, delta, dq, dk, dv
    attrs = {f"block_sparse_fwd/D{D}": read_attributes("dstorch_block_sparse_fwd_attrs", D)
             for D in K9_DIMS}
    attrs.update({f"{name}/D{D}": read_attributes("dstorch_block_sparse_bwd_attrs", i, D)
                  for i, name in ((1, "block_sparse_dq"), (3, "block_sparse_dq_causal"),
                                  (2, "block_sparse_dkv"))
                  for D in K9_DIMS})
    print("k9-kernels " + json.dumps({"attributes": attrs,
                                      "device": torch.cuda.get_device_name(0)}), flush=True)
    spills = {k: a["local_bytes"] for k, a in attrs.items() if a["local_bytes"]}
    if spills:
        raise AssertionError(f"K9's kernels spill to local memory: {spills}")


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
    check_sparse_dims(randn, record)
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


# K10 per head dim, pair-bias type and mask (3% of keys and every key of row
# 1, or none): (label, L, S, H, R, D, pair dtype name, masked, timed). A
# ragged S = 300 (no 64-tile divides it) at every combination; the MSA row
# shape at each head dim, its D = 32, bf16, masked case the kernel table's
# row; an odd S and one row a group
EVO_DIMS = (16, 32, 64, 128)


def evo_cases():
    Nr, Nc, Hm = EVO_RES, EVO_CLUST, EVO_MSA_H
    msa = [("MSA row attention", Nc, Nr, Hm, Nc, EVO_D, "bfloat16", True, True),
           ("MSA row attention", Nc, Nr, Hm, Nc, 16, "float32", True, False),
           ("MSA row attention", Nc, Nr, Hm, Nc, 32, "float32", False, False),
           ("MSA row attention", Nc, Nr, Hm, Nc, 64, "bfloat16", False, False),
           ("MSA row attention", Nc, Nr, Hm, Nc, 128, "bfloat16", True, False)]
    ragged = [("ragged S", 8, 300, 4, 4, D, pt, masked, False)
              for D, pt, masked in itertools.product(EVO_DIMS, ("bfloat16", "float32"),
                                                     (True, False))]
    # an odd S: a bf16 pair-bias row starts 2-byte aligned (no cp.async);
    # R = 1: one chunk a group in d(pair)
    odd = [("odd S", 8, 301, 4, 4, 32, "bfloat16", True, False),
           ("one row a group", 4, 200, 4, 1, 64, "float32", False, False)]
    return msa + ragged + odd


def check_evo_kernels(label, L, S, H, R, D, pair_dtype, masked, timed, randn, g, record):
    """K10's four kernels against their plain versions (the backward ones
    fed the kernel forward's o and lse) on [L, S, H, D] rows with a mask
    (3% of keys, and row 1's every key) or none and a pair bias [L / R, H,
    S, S] of ``pair_dtype``; all four run twice and required bitwise equal;
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
    mask = torch.where(keep_mask(g, (L, S), 1) > 0, 0.0, -1e9) if masked else None
    o, lse = evoformer_fwd(q, k, v, mask, pair, scale, R)
    o_ref, lse_ref = evoformer_fwd_plain(q, k, v, mask, pair, scale, R)
    delta = evoformer_delta(o, do)
    args = (q, k, v, mask, pair, do, lse, delta, scale, R)
    dq, (dk, dv), dpair = evoformer_dq(*args), evoformer_dkv(*args), evoformer_dbias(*args)
    case = (f"{label}: L={L} S={S} H={H} D={D} R={R} pair {str(pair_dtype)[6:]} "
            f"{'masked' if masked else 'no mask'}")
    same_bits(case, (o, lse, dq, dk, dv, dpair),
              (*evoformer_fwd(q, k, v, mask, pair, scale, R), evoformer_dq(*args),
               *evoformer_dkv(*args), evoformer_dbias(*args)))
    dq_ref = evoformer_dq_plain(*args)
    dk_ref, dv_ref = evoformer_dkv_plain(*args)
    dpair_ref = evoformer_dbias_plain(*args)
    torch.cuda.synchronize()
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
    for c in evo_cases():
        ins = check_evo_kernels(*c[:6], getattr(torch, c[6]), *c[7:], randn, g, record)
        if c[8]:
            q, k, v, do, pair = ins
        del ins
        torch.cuda.empty_cache()
    attrs = {f"evoformer_fwd/D{d}/pair {pt}": read_attributes(
        "dstorch_evoformer_fwd_attrs", d, int(pt == "f32"))
        for d in EVO_DIMS for pt in ("bf16", "f32")}
    attrs.update({f"{name}/D{d}/pair {pt}": read_attributes("dstorch_evoformer_bwd_attrs", i, d,
                                                            int(pt == "f32"))
                  for i, name in ((1, "evoformer_dq"), (2, "evoformer_dkv"),
                                  (3, "evoformer_dbias"))
                  for d in EVO_DIMS for pt in ("bf16", "f32")})
    print("k10-kernels " + json.dumps({"attributes": attrs,
                                       "device": torch.cuda.get_device_name(0)}), flush=True)
    spills = {k: a["local_bytes"] for k, a in attrs.items() if a["local_bytes"]}
    if spills:
        raise AssertionError(f"K10's kernels spill to local memory: {spills}")

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
    continuation_pass(engine, "Mistral-7B", W_NAMES)
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
    continuation_pass(engine, "BLOOM-560M", A_NAMES)
    print(f"phase 10: peak device memory {gib(torch.cuda.max_memory_allocated()):.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phases 11 and 12: memory-lean serving under a window (Mistral-7B, int4
# weights + int8 pages) and under ALiBi (BLOOM-7b1, int8 pages)
# --------------------------------------------------------------------------- #

CONT_UID = 9999


def continuation_pass(engine, label, names):
    """One paged pass made only of continuation chunks, at each rung of the
    engine's ladder: a prompt of two passes' take (the chunk budget, or the
    take cap under a window) from an empty sequence, its first pass run,
    its second timed (wall, with a device sync) and profiled (device ms in
    all and of the port's kernels ``names``), the rest drained and the
    sequence flushed. Prints one ``continuation pass`` line; a rung the
    pool cannot hold is "not measured". Needs no live sequence."""
    import torch
    sched, sm = engine.scheduler, engine.config.state_manager
    take = sm.num_chunk_slots * sm.chunk_slot_size
    if sched.window is not None:
        take = min(take, sched._pass_take_cap)
    n = min(2 * take, sm.max_context - 1)
    rng = np.random.RandomState(n)

    def second_pass(measure):
        """The prompt's first pass, ``measure(engine._run_pass)`` on its
        second, then the rest drained and the sequence flushed."""
        sched.add_tokens(CONT_UID, rng.randint(0, engine.spec.vocab_size, n).astype(np.int32))
        engine._run_pass()
        torch.cuda.synchronize()
        out = measure(engine._run_pass)
        while sched.has_pending():
            engine._run_pass()
        engine.flush([CONT_UID])
        return out

    def wall_ms(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rungs = {}
    for rung in engine.attn_split_ladder:
        if not engine.can_schedule([CONT_UID], [n]):
            rungs[rung] = "not measured"
            continue
        engine.attn_rung_override = rung
        wall = second_pass(wall_ms)
        r = second_pass(lambda fn: device_time(fn, names))
        rungs[rung] = {"wall_ms": wall, "device_ms": r["device_ms"],
                       "port_kernels_ms": r["port_kernels_ms"]}
    engine.attn_rung_override = None
    print("continuation pass " + json.dumps({
        "phase": label, "prompt_tokens": n, "rows": n - take, "q_start": take,
        "rungs": rungs}), flush=True)


def serve_main_path(engine, prompts, uids, names, rng, step_probe=None):
    """``generate()`` (32 new tokens each), then ``put()`` of the prompts
    (noting each sequence's prefill-from-zero rows, which attend each other
    at full precision), one pipelined step at each rung of the ladder
    (inside ``step_probe()``, a context manager, when one is given), and
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
        with step_probe() if step_probe else contextlib.nullcontext():
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
    in bf16 (phase 6's rule). Two controls must fail that limit, or the
    check could not tell a wrong engine: zero logits, and the engine's
    logits a row late (another position's). Returns the limit."""
    import torch
    e_eng, e_dense, m_eng, m_dense = [], [], 0.0, 0.0
    e_ref, e_late = [], []
    for i, p in enumerate(prompts):
        seq = torch.from_numpy(np.concatenate([p] + [t[i:i + 1] for t in toks])).long().cuda()
        rows = torch.arange(len(p) - 1, len(p) + len(toks), device="cuda")
        ref32 = dense(i, seq, rows, torch.float32)
        ref16 = dense(i, seq, rows, torch.bfloat16)
        eng = torch.from_numpy(np.stack([g_[i] for g_ in got])).cuda()
        if not torch.isfinite(eng).all():
            raise AssertionError("engine logits are not finite")
        d_eng, d_dense = eng - ref32, ref16 - ref32
        e_ref.append(float(ref32.pow(2).mean()))
        e_late.append(float((eng.roll(1, 0) - ref32).pow(2).mean()))
        e_eng.append(float(d_eng.pow(2).mean()))
        e_dense.append(float(d_dense.pow(2).mean()))
        m_eng = max(m_eng, float(d_eng.abs().max()))
        m_dense = max(m_dense, float(d_dense.abs().max()))
        del ref32, ref16
    rms_eng, rms_dense = float(np.sqrt(np.mean(e_eng))), float(np.sqrt(np.mean(e_dense)))
    rms_ref, rms_late = float(np.sqrt(np.mean(e_ref))), float(np.sqrt(np.mean(e_late)))
    limit = 2 * rms_dense
    print(f"logits vs dense fp32 {label} (prefill + {len(toks)} decode steps x "
          f"{len(prompts)} prompts): engine rms {rms_eng:.5f} max {m_eng:.4f}; dense bf16 "
          f"rms {rms_dense:.5f} max {m_dense:.4f}; limit rms <= {limit:.5f}; logits rms "
          f"{rms_ref:.5f}; controls (must exceed the limit): zero logits {rms_ref:.5f}, "
          f"a row late {rms_late:.5f}", flush=True)
    if not rms_eng <= limit:
        raise AssertionError(f"engine logits error {rms_eng} > 2 x dense bf16 {rms_dense}")
    if not min(rms_ref, rms_late) > limit:
        raise AssertionError(f"the logits check cannot fail: a control ({rms_ref}, "
                             f"{rms_late}) is within its limit {limit}")
    return limit


def rung_invariance(engine, uids, limit):
    """One live decode step at every rung (rung 1 writes last) against rung
    1: RMS within ``limit``. An MoE model's rung 1 runs first as well, and
    every rung follows its expert choices (:func:`moe_routes`), so what is
    compared is the attention at each rung, not a routing near-tie's
    flip."""
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
    db = engine.scheduler.decode_batch(uids, 2, engine.scratch_block)
    ids = engine._sample_device_padded(uids, False, 1.0, 0)
    bt = to_device(db.block_tables, engine.device)
    pos = to_device(db.positions, engine.device)
    step, rung1_routes = {}, []
    order = list(reversed(engine.attn_split_ladder))
    if engine.spec.moe is not None:
        order = [1] + order
    for j, rung in enumerate(order):
        routing = (contextlib.nullcontext() if engine.spec.moe is None
                   else moe_routes(record=rung1_routes) if j == 0
                   else moe_routes(force=rung1_routes))
        with routing:
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
              "quantized_matmul_gemv_int4", "quantized_matmul_mma")
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
    continuation_pass(engine, "Mistral-7B int4 + int8 KV", M8_NAMES)
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
    continuation_pass(engine, "BLOOM-7b1 int8 KV", A_NAMES)
    print(f"phase 12: peak device memory {gib(torch.cuda.max_memory_allocated()):.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 13: serving phi-2 (head dim 80) at full width and depth
# --------------------------------------------------------------------------- #

P_KERNELS = ("flash_packed", "paged_chunk", "paged_decode", "paged_splitk/2", "splitk_merge")
P_NAMES = ("flash_packed", "paged_chunk", "paged_decode", "paged_splitk", "splitk_merge")
ENGINE_PHI2 = {"kv_cache": {"block_size": HD_BS, "num_blocks": 40},
               "state_manager": {"max_context": 2048},
               "attention": {"decode_splits": 2, "min_ctx_per_split": 512}, "seed": 0}
P_PROMPTS = (1500, 600, 200, 40)     # they end at HD_CTXS (+32 new tokens each)


def run_phi2():
    """Phase 13: phi-2 at full width and depth (32 layers, 2560 wide, 32
    heads of D = 80, partial rotary 0.4, parallel blocks, vocab 51200),
    random bf16 weights from seed 0, through the packed prefill (K2), the
    chunk kernel (K5), the decode kernel and K7 at 2 splits, all at D = 80.
    Returns the main path's launch counts."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = lambda b: b / 2 ** 30
    cfg = DecoderConfig.phi_2(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device="cuda", seed=0)
    engine = InferenceEngineV2(model, ENGINE_PHI2, model.flat_params())
    spec = engine.spec
    torch.cuda.synchronize()
    print(f"model: phi-2 (DecoderConfig.phi_2: vocab {cfg.vocab_size}, hidden "
          f"{cfg.hidden_size}, FFN {cfg.intermediate_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, head_dim {cfg.head_dim}, rotary_dim "
          f"{spec.rotary_dim}, parallel block), random bf16 weights (seed 0); family "
          f"{engine.family}; pool {ENGINE_PHI2['kv_cache']['num_blocks']} pages; chunk budget "
          f"{engine.config.state_manager.chunk_budget}; ladder {engine.attn_split_ladder}; "
          f"build {time.perf_counter() - t0:.1f} s, memory "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB", flush=True)
    if spec.head_dim != 80 or spec.alibi or engine._pass_prefill is None:
        raise AssertionError(f"phi-2 spec {spec}: expected D = 80, rotary and the packed "
                             "prefill pass")

    rng = np.random.RandomState(13)
    V = cfg.vocab_size
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in P_PROMPTS]
    uids = [10, 11, 12, 13]
    launches, _, got, toks, _, t_gen, t_prefill, pipe = serve_main_path(
        engine, prompts, uids, P_KERNELS, rng)
    limit = logits_check("phi-2, D = 80", prompts, got, toks,
                         lambda i, seq, rows, dt: model.head(
                             model.hidden(seq[None], compute_dtype=dt)[0, rows]))
    rung_invariance(engine, uids, limit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(8)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    n_prompt = sum(len(p) for p in prompts)
    print(f"generate() 4 prompts x 32 tokens in {t_gen:.2f} s; prefill {n_prompt} tokens in "
          f"{t_prefill * 1e3:.1f} ms = {n_prompt / t_prefill:.1f} tok/s; decode 4 x 8 tokens "
          f"in {t_decode * 1e3:.1f} ms = {32 / t_decode:.1f} tok/s", flush=True)
    engine.flush(uids + [14])
    chunk = engine.config.state_manager.chunk_budget
    device_breakdown(f"phi-2 prefill pass ({chunk} tokens from 0, packed prefill)",
                     lambda: engine.put([20], [rng.randint(0, V, chunk).astype(np.int32)]),
                     P_NAMES)
    engine.flush([20])
    continuation_pass(engine, "phi-2", P_NAMES)
    print(f"phase 13: peak device memory {gib(torch.cuda.max_memory_allocated()):.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 14: Mixtral-8x7B MoE serving with int8 weights on one card
# --------------------------------------------------------------------------- #

MX_KERNELS = ("flash_packed", "paged_chunk", "paged_decode", "paged_splitk/2",
              "paged_splitk/4", "splitk_merge", "quantized_matmul_gemv",
              "quantized_matmul_mma", "quantized_matmul_grouped_gemv",
              "quantized_matmul_grouped_mma")
MX_SIDE_KERNELS = ("paged_decode_side", "paged_splitk_side/4")
MX_NAMES = P_NAMES + ("qmm_gemv", "qmm_gemv_grouped", "qmm_mma")
ENGINE_MIXTRAL = {"quantization": {"weight_bits": 8},
                  "kv_cache": {"block_size": 128, "num_blocks": 64},
                  "state_manager": {"max_context": 4096},
                  "attention": {"decode_splits": 4, "min_ctx_per_split": 512}, "seed": 0}
MX_PROMPTS = (2000, 900, 300, 60)
CARD_BYTES = 80 * 2 ** 30          # the H100's device memory


class SeededParams(collections.abc.Mapping):
    """A flat parameter tree whose tensors are made on the card from a seed
    one at a time as they are read, in ``dtype``: norm weights 1 (or, with
    ``norm_plus_one``, normal(0.1) around 0), embeddings normal(1 /
    sqrt(hidden)), kernels normal(1 / sqrt(fan_in)), MoE expert stacks
    normal(0.02) (the JAX package's initialiser), biases normal(0.5)
    (nonzero: a dropped bias shows). Nothing is kept: the engine quantizes
    each projection as it lands, so no bf16 copy of the model exists."""

    def __init__(self, shapes, dtype, seed, norm_plus_one=False):
        self.shapes, self.dtype, self.seed, self.p1 = shapes, dtype, seed, norm_plus_one
        self.index = {n: i for i, n in enumerate(sorted(shapes))}

    def __getitem__(self, name):
        import torch
        shape = self.shapes[name]
        g = torch.Generator(device="cuda").manual_seed(self.seed * 100003 + self.index[name])
        t = torch.randn(shape, generator=g, device="cuda", dtype=self.dtype)
        if name.endswith("weight"):
            return t.mul_(0.1) if self.p1 else t.fill_(1.0)
        if name.endswith("bias"):
            return t.mul_(0.5)
        if name.endswith("embedding"):
            return t.mul_(shape[1] ** -0.5)
        if name.endswith(("w_gate", "w_up", "w_down")):
            return t.mul_(0.02)
        return t.mul_(shape[-2] ** -0.5)

    def __contains__(self, name):      # Mapping's would make the tensor
        return name in self.shapes

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self):
        return len(self.shapes)


def moe_sync_free(engine):
    """``_moe_ffn`` over the engine's first layer at a prefill pass's rows
    (the chunk budget) and a decode step's (4) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in it waits on the
    device."""
    import torch
    from deepspeed_tpu_torch.inference.v2.ragged_model import _moe_ffn
    moe = engine.weights["layers"][0]["moe"]
    hid, k = engine.spec.hidden_size, engine.spec.moe["top_k"]
    rows = {}
    for label, T in (("prefill", engine.config.state_manager.chunk_budget), ("decode", 4)):
        x = torch.randn(T, hid, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = _moe_ffn(x, moe, k, torch.bfloat16)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if out.shape != x.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"_moe_ffn at {label}: malformed output")
        rows[label] = T
    print("moe sync-free " + json.dumps({"rows": rows, "sync_debug_mode": "error",
                                         "raised": False}), flush=True)


@contextlib.contextmanager
def moe_routes(record=None, force=None):
    """Within the block every MoE layer's routing
    (``ragged_model._moe_route``) appends its expert ids [T, k] to
    ``record``; or, given ``force`` (one step's ids, a layer each), the
    l-th call routes its rows to ``force[l % len(force)]``, gated by their
    own f32 router logits as the engine gates its choice."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import ragged_model as prm
    inner, calls = prm._moe_route, itertools.count()

    def route(x, router, top_k):
        if force is not None:
            ids = force[next(calls) % len(force)]
            return torch.softmax((x.float() @ router.float()).gather(1, ids), dim=-1), ids
        gates, ids = inner(x, router, top_k)
        record.append(ids)
        return gates, ids

    prm._moe_route = route
    try:
        yield
    finally:
        prm._moe_route = inner


class EngineRoutes:
    """The engine's top-k experts at every (uid, layer, position) it
    computes inside :meth:`recording`: a pass's rows through its batch
    (chunk slots, then decode rows), a pipelined step's (inside
    :meth:`step`) through the uids and positions given."""

    def __init__(self, engine):
        self.engine, self.calls, self.log, self.table = engine, [], [], {}

    @contextlib.contextmanager
    def recording(self):
        eng = self.engine
        schedule, run_pass, batches = eng.scheduler.schedule_pass, eng._run_pass, []

        def scheduled():
            batches.append(schedule())
            return batches[-1]

        def recorded_pass():
            batches.clear()
            self.calls.clear()
            run_pass()
            b = batches[0] if batches else None
            if b is not None:
                NC, Cs = len(b.slot_uid), b.slot_size
                for s, u in enumerate(b.slot_uid):
                    r = np.arange(s * Cs, s * Cs + int(b.chunk_ntok[s]))
                    self._put(u, r, b.chunk_positions[r])
                for i, u in enumerate(b.decode_uids):
                    self._put(u, [NC * Cs + i], b.decode_positions[i:i + 1])

        eng.scheduler.schedule_pass, eng._run_pass = scheduled, recorded_pass
        try:
            with moe_routes(record=self.calls):
                yield
        finally:
            del eng.scheduler.schedule_pass, eng._run_pass

    @contextlib.contextmanager
    def step(self, uids, positions):
        self.calls.clear()
        yield
        for i, (u, p) in enumerate(zip(uids, positions)):
            self._put(u, [i], [p])

    def _put(self, uid, rows, positions):
        """Notes which rows of this forward's calls are ``uid``'s positions;
        the table is filled when first read, so serving does no extra
        device work."""
        L = self.engine.spec.num_layers
        if len(self.calls) != L:
            raise AssertionError(f"{len(self.calls)} MoE calls in a forward of {L} layers")
        self.log.append((uid, np.asarray(rows), np.asarray(positions), list(self.calls)))

    def ids(self, uid, T):
        """[L, T, k]: the experts of positions 0..T-1 (each recorded; a
        later forward over a position overwrites an earlier one)."""
        import torch
        for u, rows, pos, calls in self.log:
            t = self.table.get(u)
            if t is None:
                t = self.table[u] = torch.full(
                    (len(calls), self.engine.config.state_manager.max_context,
                     calls[0].shape[1]), -1, dtype=torch.long, device=self.engine.device)
            r, p = (torch.as_tensor(a, dtype=torch.long, device=t.device) for a in (rows, pos))
            for l, c in enumerate(calls):
                t[l, p] = c[r].long()
        self.log.clear()
        t = self.table[uid][:, :T]
        if bool((t < 0).any()):
            raise AssertionError(f"uid {uid}: positions with no recorded routing")
        return t


def run_mixtral():
    """Phase 14: Mixtral-8x7B at full width and depth (32 layers, 8 experts,
    top-2) with int8 weights and bf16 KV pages on one card: the parameters
    are made on the card from seed 0 as the engine reads them, each
    projection and expert stack quantized as it lands. Returns the main
    path's launch counts."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = lambda b: b / 2 ** 30
    cfg = MixtralConfig.mixtral_8x7b(dtype=torch.bfloat16)
    meta = MixtralForCausalLM(cfg, device="meta")
    shapes = {n.replace(".", "/"): tuple(p.shape) for n, p in meta.named_parameters()}
    n_params = sum(int(np.prod(sh)) for sh in shapes.values())
    t0 = time.perf_counter()
    engine = InferenceEngineV2(meta, ENGINE_MIXTRAL, SeededParams(shapes, torch.bfloat16, 0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak_build = torch.cuda.max_memory_allocated()
    w_up = engine.weights["layers"][0]["moe"]["w_up"]
    print(f"model: Mixtral-8x7B (MixtralConfig.mixtral_8x7b: vocab {cfg.vocab_size}, hidden "
          f"{cfg.hidden_size}, FFN {cfg.intermediate_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} heads, "
          f"{cfg.num_local_experts} experts top-{cfg.num_experts_per_tok}; {n_params / 1e9:.2f}B "
          f"parameters = {n_params * 2 / 1e9:.1f} GB in bf16), random weights (seed 0) made on "
          f"the card as the engine reads them and quantized to int8 as they land (w_up "
          f"{list(w_up['w8'].shape)} {w_up['w8'].dtype}, scale {list(w_up['scale'].shape)}); "
          f"bf16 KV pool of {ENGINE_MIXTRAL['kv_cache']['num_blocks']} pages; ladder "
          f"{engine.attn_split_ladder}; build {build_s:.1f} s; memory after build "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB, peak during build "
          f"{gib(peak_build):.2f} GiB; {smi_line()}", flush=True)
    if engine.spec.moe != {"num_experts": 8, "top_k": 2} or w_up["w8"].dtype != torch.int8 \
            or tuple(w_up["w8"].shape) != (8, cfg.hidden_size, cfg.intermediate_size):
        raise AssertionError("phase 14's engine is not Mixtral-8x7B with int8 experts")
    rng = np.random.RandomState(14)
    moe_sync_free(engine)

    V, L = cfg.vocab_size, cfg.num_hidden_layers
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in MX_PROMPTS]
    uids = [10, 11, 12, 13]
    routes, steps = EngineRoutes(engine), itertools.count()

    def probe():
        j = next(steps)
        return routes.step(uids, [len(p) + j for p in prompts])

    with routes.recording():
        launches, _, got, toks, _, t_gen, t_prefill, _ = serve_main_path(
            engine, prompts, uids, MX_KERNELS, rng, step_probe=probe)
    # the dense forwards follow the engine's experts at every (layer,
    # position), so a near-tie that the engine breaks one way and fp32 the
    # other moves neither the logits compared nor what comes after; each
    # forward's own top-2 is kept to see where it would have routed
    own = {torch.float32: {}, torch.bfloat16: {}}

    def dense(i, seq, rows, dt):
        layers = []
        out = dense_quant_logits(engine, cfg, seq, rows, dt, kv_int8=False, routes=layers,
                                 forced=routes.ids(uids[i], len(seq)))
        own[dt][i] = layers
        return out

    limit = logits_check("of Mixtral-8x7B over the int8 weights, routed as the engine "
                         "routed", prompts, got, toks, dense)
    # routing: the engine's top-2 set at every (layer, position) against
    # the fp32 forward's own choice on those inputs, beside the dense bf16
    # forward's; where they differ, the fp32 margin between the 2nd and 3rd
    # logits shows whether it was a near-tie
    same = lambda a, b: (a.sort(-1).values == b.sort(-1).values).all(-1)
    differ = {"engine": 0, "dense_bf16": 0}
    margins, differ_margins, total = [], [], 0
    for i, p in enumerate(prompts):
        T = len(p) + len(toks)
        eng_ids = routes.ids(uids[i], T)
        for l in range(L):
            ref = own[torch.float32][i][l]
            ok_eng = same(eng_ids[l], ref["own"])
            differ["engine"] += int((~ok_eng).sum())
            differ["dense_bf16"] += int((~same(own[torch.bfloat16][i][l]["own"],
                                               ref["own"])).sum())
            margins.append(ref["margin"])
            differ_margins.append(ref["margin"][~ok_eng])
            total += T
    margins, differ_margins = torch.cat(margins), torch.cat(differ_margins)
    q = lambda t: ({f"p{int(f * 100)}": float(t.quantile(f)) for f in (0.5, 0.9, 1.0)}
                   if t.numel() else {})
    print("routing vs dense fp32 " + json.dumps({
        "layer_position_top2_sets": total, "differing": differ,
        "share_agreeing": {k: 1 - v / total for k, v in differ.items()},
        "fp32_margin_2nd_3rd": q(margins), "fp32_margin_where_engine_differs":
        q(differ_margins), "limit": "engine differs <= 2 x max(dense bf16's, 1)"}),
        flush=True)
    if not differ["engine"] <= 2 * max(differ["dense_bf16"], 1):
        raise AssertionError(f"the engine routes {differ['engine']} of {total} top-2 sets "
                             f"off the fp32 choice; the dense bf16 forward "
                             f"{differ['dense_bf16']}")
    rung_invariance(engine, uids, limit)

    # ---- rates, a profiled step beside its bound, bursts ---- #
    side = lean_rates_and_bursts("Mixtral-8x7B int8", engine, uids, prompts, t_gen, t_prefill,
                                 MX_NAMES, MX_SIDE_KERNELS, (1, 4))
    step_ids = []
    pipe = engine.decode_pipeline(uids)
    with moe_routes(record=step_ids):
        pipe.run(1)
    torch.cuda.synchronize()
    routed = [len(set(ids[:len(uids)].reshape(-1).tolist())) for ids in step_ids]
    H, Hkv, D, hid = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                      cfg.hidden_size)
    ctx = sum(engine.scheduler.seqs[u].seen_tokens for u in uids)
    attn_w = hid * (H + 2 * Hkv) * D + H * D * hid
    ff = cfg.intermediate_size
    # int8 weights and their f32 column scales, each read once: the routed
    # experts' stacks, every layer's attention projections, the head; the
    # bf16 KV of every live token
    step_bytes = (sum(r * (3 * hid * ff + 4 * (2 * ff + hid)) for r in routed)
                  + cfg.num_hidden_layers * (attn_w + 4 * (H * D + 2 * Hkv * D + hid))
                  + hid * V + 4 * V + ctx * cfg.num_hidden_layers * 2 * Hkv * D * 2)
    step = device_time(lambda: pipe.run(1), MX_NAMES)
    print("moe decode step " + json.dumps({
        "rows": len(uids), "routed_experts_per_layer_mean": float(np.mean(routed)),
        "bytes_read": step_bytes, "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
        "device_ms": step["device_ms"], "port_kernels_ms": step["port_kernels_ms"],
        "nvidia_smi": smi_line()}), flush=True)
    launches.update(side)
    engine.flush(uids + [14])
    chunk = engine.config.state_manager.chunk_budget
    device_breakdown(f"Mixtral-8x7B prefill pass ({chunk} tokens from 0, int8)",
                     lambda: engine.put([20], [rng.randint(0, V, chunk).astype(np.int32)]),
                     MX_NAMES)
    engine.flush([20])
    continuation_pass(engine, "Mixtral-8x7B int8", MX_NAMES)
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 14: peak device memory {gib(peak):.2f} GiB (build {gib(peak_build):.2f} "
          f"GiB; the card's 80 GiB); {time.perf_counter() - t_phase:.1f} s; {smi_line()}",
          flush=True)
    if not peak < CARD_BYTES:
        raise AssertionError(f"phase 14 peak memory {gib(peak):.2f} GiB >= 80 GiB")
    return launches


# --------------------------------------------------------------------------- #
# phases 15 and 16: Qwen2-7B and Gemma-7B through the Llama adapter's flags
# --------------------------------------------------------------------------- #

LF_KERNELS = ("flash_packed", "paged_chunk", "paged_decode", "paged_splitk/2",
              "splitk_merge")
LF_SIDE_KERNELS = ("paged_decode_side", "paged_splitk_side/2")
ENGINE_LLAMA_FLAGS = {"kv_cache": {"block_size": 128, "num_blocks": 48},
                      "state_manager": {"max_context": 4096},
                      "attention": {"decode_splits": 2, "min_ctx_per_split": 512}, "seed": 0}
LF_PROMPTS = (1500, 600, 200, 40)


def run_llama_flags(phase, label, cfg, check):
    """One bf16 Llama-lineage model at full width and depth, its weights
    made on the card from seed 0 (``SeededParams``: random nonzero biases,
    norm weights around 0 under ``norm_plus_one``): ``put``/``generate``
    through the main path, the logits check against the dense forward,
    rung invariance, rates, a profiled step and bursts at rungs 1 and 2.
    ``check(engine)`` fails on a spec that lost the lineage's flags.
    Returns the main path's launch counts."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gib = lambda b: b / 2 ** 30
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="meta")
    shapes = {n.replace(".", "/"): tuple(p.shape) for n, p in model.named_parameters()}
    model = model.to_empty(device="cuda")
    flat = model.flat_params()
    src = SeededParams(shapes, torch.bfloat16, 0, cfg.norm_plus_one)
    with torch.no_grad():
        for n in shapes:
            flat[n].copy_(src[n])
    engine = InferenceEngineV2(model, ENGINE_LLAMA_FLAGS, model.flat_params())
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(sh)) for sh in shapes.values())
    print(f"model: {label} (vocab {cfg.vocab_size}, hidden {cfg.hidden_size}, FFN "
          f"{cfg.intermediate_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} heads, head_dim {cfg.head_dim}, "
          f"{n_params / 1e9:.2f}B parameters), random bf16 weights (seed 0); spec activation "
          f"{engine.spec.activation}, norm_plus_one {engine.spec.norm_plus_one}, embed scale "
          f"{engine.spec.embed_scale_by_sqrt_dim}, q/k/v biases "
          f"{'bq' in engine.weights['layers'][0]}; pool "
          f"{ENGINE_LLAMA_FLAGS['kv_cache']['num_blocks']} pages; ladder "
          f"{engine.attn_split_ladder}; build {time.perf_counter() - t0:.1f} s, memory "
          f"{gib(torch.cuda.memory_allocated()):.2f} GiB; {smi_line()}", flush=True)
    check(engine)
    rng = np.random.RandomState(phase)
    V = cfg.vocab_size
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in LF_PROMPTS]
    uids = [10, 11, 12, 13]
    launches, _, got, toks, _, t_gen, t_prefill, _ = serve_main_path(
        engine, prompts, uids, LF_KERNELS, rng)
    limit = logits_check(label, prompts, got, toks, lambda i, seq, rows, dt: model.lm_head(
        model.hidden(seq[None], compute_dtype=dt)[0, rows], dt).float())
    rung_invariance(engine, uids, limit)
    launches.update(lean_rates_and_bursts(label, engine, uids, prompts, t_gen, t_prefill,
                                          P_NAMES, LF_SIDE_KERNELS, (1, 2)))
    engine.flush(uids + [14])
    print(f"phase {phase}: peak device memory {gib(torch.cuda.max_memory_allocated()):.2f} GiB; "
          f"{time.perf_counter() - t_phase:.1f} s; {smi_line()}", flush=True)
    return launches


# Qwen/Qwen2-7B's config.json (no sliding window: use_sliding_window false)
QWEN2_7B = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
                num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
                max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-6,
                qkv_bias=True)
# google/gemma-7b's config.json, with a separate head (the JAX package's
# adapter reads one)
GEMMA_7B = dict(vocab_size=256000, hidden_size=3072, intermediate_size=24576,
                num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=16,
                head_dim_override=256, max_position_embeddings=8192, rope_theta=10000.0,
                rms_norm_eps=1e-6, embed_scale_by_sqrt_dim=True, norm_plus_one=True,
                mlp_act="gelu")


def run_qwen2():
    """Phase 15: Qwen2-7B (biased q/k/v, 28 query heads over 4 kv heads:
    G = 7)."""
    import torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig(**QWEN2_7B, dtype=torch.bfloat16)

    def check(engine):
        b = engine.weights["layers"][0].get("bk")
        if b is None or not bool(b.abs().max() > 0) or \
                engine.spec.num_heads // engine.spec.num_kv_heads != 7:
            raise AssertionError("phase 15's engine lost Qwen2's q/k/v biases or its G = 7")

    return run_llama_flags(15, "Qwen2-7B", cfg, check)


def run_gemma():
    """Phase 16: Gemma-7B (head dim 256, GeGLU (tanh), RMSNorm by 1 +
    weight, the embedding scaled by sqrt(hidden))."""
    import torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig(**GEMMA_7B, dtype=torch.bfloat16)

    def check(engine):
        sp = engine.spec
        if not (sp.head_dim == cfg.head_dim and sp.activation == "geglu" and sp.norm_plus_one
                and sp.embed_scale_by_sqrt_dim):
            raise AssertionError(f"phase 16's engine lost Gemma's flags: {sp}")

    return run_llama_flags(16, "Gemma-7B", cfg, check)


# --------------------------------------------------------------------------- #
# phase 17: the prefix cache and speculative decoding on Llama-2-7B
# --------------------------------------------------------------------------- #

# phase 4's pages of 128 (they meet the int8 pool's alignment gate at Hkv 32);
# 80 pages hold the cache-off engine's seven 1216-token sequences at once
P17_POOL = {"kv_cache": {"block_size": 128, "num_blocks": 80}, "seed": 0}
P17_PREFIX, P17_TAIL, P17_NEW = 1024, 128, 64
P17_SHARED = 7            # requests after the first that share its prefix
P17_SEED_TAIL = 64        # a request ending mid-page: its flush files a partial page
P17_COW_TAIL = 100        # the COW request: the seed's tokens, then its own
P17_DENSE = 3             # cache hits whose continuation logits meet the dense forward
SPEC_KS = (3, 7)
SPEC_SPAN, SPEC_REPEATS, SPEC_NEW = 64, 8, 128
P17_NAMES = ("flash_packed", "paged_chunk", "paged_decode", "paged_splitk", "splitk_merge")


class OracleProposer:
    """Drafts that replay known greedy streams (prompt + stream): while a
    row's history is a prefix of its stream, every draft is right."""

    def __init__(self, prompts, streams):
        self.fulls = [np.concatenate([p, np.asarray(s, np.int32)]) for p, s in zip(prompts, streams)]

    def propose(self, history, k):
        h = np.asarray(history, np.int32)
        for full in self.fulls:
            if len(full) >= len(h) and np.array_equal(full[:len(h)], h):
                return full[len(h):len(h) + k]
        return h[:0]


@contextlib.contextmanager
def put_timer(engine, reset=False):
    """Within the block, each prefill of ``generate`` (the engine's
    ``_put_nofetch``) is timed on the host clock between two device syncs,
    its wall ms appended to the yielded list; ``reset`` zeroes the launch
    counts after it, so they hold the decode's launches only."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import reset_launches
    put = engine._put_nofetch
    times = []

    def timed(uids, toks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        put(uids, toks)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if reset:
            reset_launches()

    engine._put_nofetch = timed
    try:
        yield times
    finally:
        del engine._put_nofetch


@contextlib.contextmanager
def noting_full(engine):
    """Within the block, each sequence's prefill-from-zero pass is noted in
    the yielded dict, uid -> that pass's rows, which attend each other at
    full precision (phase 6's rule for :func:`dense_quant_logits`)."""
    n_full = {}
    complete = engine.scheduler.complete_pass

    def noting(batch):
        if batch.pure_prefill:
            for u in batch.chunk_uids:
                n_full.setdefault(u, engine.scheduler.seqs[u].in_flight_tokens)
        return complete(batch)

    engine.scheduler.complete_pass = noting
    try:
        yield n_full
    finally:
        del engine.scheduler.complete_pass


def dense_rows(engine, model, seq, rows, int8, n_full=0):
    """The dense fp32 and bf16 forwards' logits [len(rows), V] at ``rows``
    of the token sequence ``seq``: the model's own forward for bf16 pages;
    :func:`dense_quant_logits` over the engine's int8 pages, ``n_full``
    the rows of the sequence's prefill-from-zero pass."""
    import torch
    ids = torch.from_numpy(np.asarray(seq, np.int64)).cuda()
    r = torch.as_tensor(rows, device="cuda")
    if int8:
        return tuple(dense_quant_logits(engine, model.config, ids, r, dt, n_full)
                     for dt in (torch.float32, torch.bfloat16))
    return tuple(model.forward_logits(ids[None], compute_dtype=dt)[0, r]
                 for dt in (torch.float32, torch.bfloat16))


def rows_vs_dense(label, engine, model, seqs, rows, eng, int8, n_full):
    """Engine logits ``eng`` [N, V], row ``rows[i]`` of sequence ``seqs[i]``
    each, against the dense forward (:func:`dense_rows`, ``n_full[i]``):
    rms within 2x the dense bf16 forward's own against fp32. A control,
    the same logits held one row late (against the fp32 row before), must
    break that limit. Returns the numbers to print."""
    import torch
    if not torch.isfinite(eng).all():
        raise AssertionError(f"{label}: logits are not finite")
    r32, r16, late = [], [], []
    for seq, r, nf in zip(seqs, rows, n_full):
        a, b = dense_rows(engine, model, seq, [r - 1, r], int8, nf)
        r32.append(a[1])
        r16.append(b[1])
        late.append(a[0])
        del a, b
    r32, r16, late = torch.stack(r32), torch.stack(r16), torch.stack(late)

    def rms(d):
        return float(d.pow(2).mean().sqrt())

    out = {"engine_rms": rms(eng - r32), "dense_bf16_rms": rms(r16 - r32),
           "dense_bf16_max": float((r16 - r32).abs().max()),
           "one_row_late_rms": rms(eng - late), "n_full": list(n_full)}
    out["limit"] = 2 * out["dense_bf16_rms"]
    if not out["engine_rms"] <= out["limit"]:
        raise AssertionError(f"{label}: logits rms {out['engine_rms']} > 2 x dense bf16 "
                             f"{out['dense_bf16_rms']}")
    if not out["one_row_late_rms"] > out["limit"]:
        raise AssertionError(f"{label}: the control (logits one row late, rms "
                             f"{out['one_row_late_rms']}) passed the limit {out['limit']}")
    return out


def p17_model():
    import torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    return model


def p17_engine(model, int8=False, **conf):
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    conf = {**P17_POOL, **conf}
    if int8:
        conf["kv_quant"] = {"enabled": True}
    return InferenceEngineV2(model, conf, model.flat_params())


def p17_free(engine):
    import torch
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def dense_gap(model, seq):
    """Top-2 gap of the dense fp32 forward's logits after ``seq``."""
    import torch
    ids = torch.from_numpy(np.asarray(seq, np.int64)).cuda()[None]
    top = torch.topk(model.forward_logits(ids, compute_dtype=torch.float32)[0, -1], 2).values
    return float(top[0] - top[1])


def stream_tie(label, model, prompts, got, ref, limit):
    """``same_or_near_tie`` over generated streams (prompt stripped; equal
    lengths compared)."""
    n = min(min(len(g), len(r)) for g, r in zip(got, ref))
    a = np.array([g[:n] for g in got])
    b = np.array([r[:n] for r in ref])
    same_or_near_tie(label, a, b, lambda i, step: dense_gap(
        model, np.concatenate([prompts[i], b[i, :step]])), limit)


def prefix_requests(V):
    rng = np.random.RandomState(17)

    def toks(n):
        return rng.randint(0, V, n).astype(np.int32)

    prefix = toks(P17_PREFIX)
    first = np.concatenate([prefix, toks(P17_TAIL)])
    shared = [np.concatenate([prefix, toks(P17_TAIL)]) for _ in range(P17_SHARED)]
    seed = np.concatenate([prefix, toks(P17_SEED_TAIL)])
    cow = np.concatenate([seed, toks(P17_COW_TAIL)])
    return first, shared, seed, cow


def serve_prefix(model, requests, cache, int8):
    """One engine, cache on or off: ``generate`` (64 new tokens each) of the
    first request, then the 7 sharing its prefix, the seed, the COW request;
    then ``put`` of the first P17_DENSE shared prompts again (fully cached
    but for their last page: a continuation pass), and the first request
    again. With the cache on, the hits' logits are held to the dense
    forward (:func:`rows_vs_dense`). Returns what phase 17 prints and
    checks."""
    import torch
    engine = p17_engine(model, int8, prefix_cache={"enabled": cache})
    first, shared, seed, cow = requests
    cow_bytes = []
    if cache:
        kv, copy = engine.kv, engine.prefix_cache.cow_fn

        def checked(src, dst):
            copy(src, dst)
            same = torch.equal(kv.kv[:, src], kv.kv[:, dst])
            if kv.scales is not None:
                same = same and torch.equal(kv.scales[:, src].view(torch.int32),
                                            kv.scales[:, dst].view(torch.int32))
            cow_bytes.append(bool(same))

        engine.prefix_cache.cow_fn = checked
    with put_timer(engine) as put_ms, noting_full(engine) as n_full:
        streams = engine.generate([first], max_new_tokens=P17_NEW)
        streams += engine.generate(shared, max_new_tokens=P17_NEW)
        streams += engine.generate([seed], max_new_tokens=P17_NEW)
        streams += engine.generate([cow], max_new_tokens=P17_NEW)
    prompts = [first] + shared + [seed, cow]
    for p, s in zip(prompts, streams):
        if len(s) != len(p) + P17_NEW or list(s[:len(p)]) != list(p):
            raise AssertionError("phase 17: generate() returned a malformed stream")
    sched = engine.scheduler
    out = {"streams": [s[len(p):] for p, s in zip(prompts, streams)],
           "prefill_tokens": sched.prefill_tokens_completed, "put_ms_shared": put_ms[1],
           "cow_bytes_equal": cow_bytes}
    before = sched.prefill_tokens_completed
    uids = [200 + i for i in range(P17_DENSE)]
    out["hit_logits"] = engine.put(uids, shared[:P17_DENSE])
    if cache:
        # the hits' prefix pages are the first request's, whose
        # prefill-from-zero pass (the first noted) attended its own rows at
        # full precision; each hit's tail attends every row at pool values
        nf = next(iter(n_full.values()))
        out["hit_dense"] = rows_vs_dense(
            f"phase 17 {'int8 KV' if int8 else 'bf16'} continuation after a hit", engine,
            model, shared[:P17_DENSE], [len(p) - 1 for p in shared[:P17_DENSE]],
            torch.from_numpy(out["hit_logits"]).cuda(), int8, [nf] * P17_DENSE)
    engine.flush(uids)
    again = sched.prefill_tokens_completed
    out["refill_logits"] = engine.put([210], [first])
    out["full_prompt_prefill"] = sched.prefill_tokens_completed - again
    out["hit_prefill"] = again - before
    engine.flush([210])
    if cache:
        st = engine.prefix_cache.stats
        out.update(hit_rate=st.hit_rate, tokens_saved=st.tokens_saved,
                   cow_copies=st.cow_copies, evictions=st.evictions)
        engine.prefix_cache.evict(engine.allocator.total_blocks)
    if engine.free_blocks != engine.allocator.total_blocks:
        raise AssertionError(f"phase 17: free blocks {engine.free_blocks} != "
                             f"{engine.allocator.total_blocks} after the prefix runs")
    p17_free(engine)
    return out


def prefix_phase(model, int8, tie):
    """The prefix cache on and off (bf16 or int8 pages): counters, the
    shared requests' put() ms, streams equal or parting at a near-tie, the
    COW page byte for byte, a fully cached prompt prefilling >= 1 token,
    and the hits' continuation logits against the dense forward. Returns
    the tie limit (bf16: 2x the dense bf16 forward's largest logit error
    at those rows; the int8 pages' streams are held to the bf16 one)."""
    label = "int8 KV" if int8 else "bf16"
    requests = prefix_requests(model.config.vocab_size)
    on = serve_prefix(model, requests, True, int8)
    off = serve_prefix(model, requests, False, int8)
    first, shared, seed, cow = requests
    if not int8:
        tie = 2 * on["hit_dense"]["dense_bf16_max"]
    on_off = float(np.abs(on["hit_logits"] - off["hit_logits"]).max())
    print("prefix-cache " + json.dumps({
        "pool": label, "prefill_tokens": {"on": on["prefill_tokens"],
                                          "off": off["prefill_tokens"]},
        "hit_rate": on["hit_rate"], "tokens_saved": on["tokens_saved"],
        "cow_copies": on["cow_copies"], "cow_bytes_equal": on["cow_bytes_equal"],
        "evictions": on["evictions"],
        "put_ms_7_shared": {"on": on["put_ms_shared"], "off": off["put_ms_shared"]},
        "hit_prefill_tokens": {"on": on["hit_prefill"], "off": off["hit_prefill"]},
        "fully_cached_prompt_prefill": on["full_prompt_prefill"],
        "hit_logits_on_vs_off_max": on_off, "continuation_vs_dense": on["hit_dense"],
        "tie_limit": tie, "nvidia_smi": smi_line()}), flush=True)
    if on["cow_copies"] < 1 or on["cow_bytes_equal"] != [True] * on["cow_copies"]:
        raise AssertionError(f"phase 17 {label}: COW copies {on['cow_bytes_equal']}")
    if not 1 <= on["full_prompt_prefill"] <= P17_TAIL:
        raise AssertionError(f"phase 17 {label}: a fully cached prompt prefilled "
                             f"{on['full_prompt_prefill']} tokens")
    if not on["prefill_tokens"] < off["prefill_tokens"] or on["tokens_saved"] <= 0:
        raise AssertionError(f"phase 17 {label}: the cache saved no prefill")
    prompts = [first] + shared + [seed, cow]
    stream_tie(f"Llama-2-7B {label} prefix cache on vs off", model, prompts,
               on["streams"], off["streams"], tie)
    return tie


def spec_prompts(V):
    rng = np.random.RandomState(18)
    rep = [np.tile(rng.randint(0, V, SPEC_SPAN), SPEC_REPEATS).astype(np.int32)
           for _ in range(4)]
    rand = [rng.randint(0, V, SPEC_SPAN * SPEC_REPEATS).astype(np.int32) for _ in range(4)]
    return rep + rand


def timed_generate(engine, prompts):
    """``generate`` (SPEC_NEW new tokens) with its prefill timed apart and
    the launch counts of its decode only. Returns (streams, decode s,
    launches)."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES
    torch.cuda.synchronize()
    with put_timer(engine, reset=True) as put_ms:
        t0 = time.perf_counter()
        outs = engine.generate(prompts, max_new_tokens=SPEC_NEW)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    launches = {k: v for k, v in LAUNCHES.items() if v}
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + SPEC_NEW or list(o[:len(p)]) != list(p):
            raise AssertionError("phase 17: generate() returned a malformed stream")
    return [o[len(p):] for p, o in zip(prompts, outs)], total - put_ms[0] / 1e3, launches


def step_times(engine, model, prompts, streams, k, int8):
    """The verify step at draft length ``k`` beside the plain decode step,
    on the phase's 8 sequences, each drafting the next k tokens of its
    plain stream in ``streams``: one verify call under
    ``set_sync_debug_mode("error")``, its final logits (each row's last
    accepted) held to the dense forward (:func:`rows_vs_dense`); then each
    step's wall ms (host clock between syncs: median and least of 5 calls
    after 2 warm-up calls) and device ms with the port's kernels' share
    (``device_time``)."""
    import torch
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
    n = len(prompts)
    uids = list(range(300, 300 + n))
    with noting_full(engine) as n_full:
        engine.put(uids, prompts)
    db = engine.scheduler.decode_batch(uids, k + 2, engine.scratch_block)
    dev = engine.device
    bt, pos = to_device(db.block_tables, dev), to_device(db.positions, dev)
    ids = engine._sample_device_padded(uids, False, 1.0, 0)
    rng = np.random.RandomState(k)
    draft_h = rng.randint(0, engine.spec.vocab_size, (db.bucket, k)).astype(np.int32)
    for i, row in enumerate(streams):
        draft_h[i] = row[1:k + 1]
    draft = to_device(draft_h, dev)
    n_draft = to_device(np.full((db.bucket,), k, np.int32), dev)
    fn = engine._verify_fn(k)

    def verify():
        return fn(engine.weights, engine.kv.kv, ids, draft, n_draft, pos, bt, pos + 1,
                  kv_scales=engine.kv.scales)

    def plain():
        return engine._step_rungs[1](engine.weights, engine.kv.kv, ids, pos, bt, pos + 1,
                                     engine.generator, False, 0, 1.0,
                                     kv_scales=engine.kv.scales)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        accept_row, _, final_logits = verify()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if tuple(accept_row.shape) != (2, db.bucket):
        raise AssertionError(f"phase 17: accept row {tuple(accept_row.shape)}")
    accepted = accept_row[0, :n].cpu().numpy()
    first = ids[:n].cpu().numpy()
    seqs = [np.concatenate([p, first[i:i + 1], draft_h[i]]) for i, p in enumerate(prompts)]
    check = rows_vs_dense(
        f"phase 17 {'int8 KV' if int8 else 'bf16'} k={k} verify", engine, model, seqs,
        [len(p) + int(a) for p, a in zip(prompts, accepted)], final_logits[:n].float(),
        int8, [n_full.get(u, 0) for u in uids])
    out = {"verify_vs_dense": {**check, "accepted": accepted.tolist()}}
    for label, step in (("verify", verify), ("plain", plain)):
        walls = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i >= 2:                      # two warm-up calls
                walls.append((time.perf_counter() - t0) * 1e3)
        prof = device_time(step, P17_NAMES)
        out[label] = {"wall_ms_median": float(np.median(walls)), "wall_ms_min": min(walls),
                      "device_ms": prof["device_ms"],
                      "port_kernels_ms": prof["port_kernels_ms"]}
    v = out["verify"]
    v["paged_chunk_share"] = v["port_kernels_ms"]["paged_chunk"] / v["device_ms"]
    engine.flush(uids)
    return out


def gap_share(model, prompts, streams, rows, limit):
    """The near-tie check's reach: over the plain streams of ``rows``, the
    dense fp32 forward's top-2 gap at every generated position (median, and
    the share under ``limit``, where two streams may part)."""
    import torch
    gaps = []
    for i in rows:
        seq = np.concatenate([prompts[i], np.asarray(streams[i], np.int32)])
        ids = torch.from_numpy(seq.astype(np.int64)).cuda()[None]
        lg = model.forward_logits(ids, compute_dtype=torch.float32)[0, len(prompts[i]) - 1:-1]
        top = torch.topk(lg, 2, dim=-1).values
        gaps.append((top[:, 0] - top[:, 1]).cpu().numpy())
    gaps = np.concatenate(gaps)
    return {"positions": int(gaps.size), "median_top2_gap": float(np.median(gaps)),
            "share_under_limit": float((gaps < limit).mean()), "limit": limit}


def spec_phase(model, int8, tie):
    """Speculative decoding at k = 3 and 7 against the plain pipeline over
    one pool type. Returns the k = 3 run's K5 launches (bf16)."""
    import torch
    label = "int8 KV" if int8 else "bf16"
    prompts = spec_prompts(model.config.vocab_size)
    n = len(prompts)
    engine = p17_engine(model, int8)
    plain, t_plain, _ = timed_generate(engine, prompts)
    p17_free(engine)
    if not int8:
        print("near-tie reach " + json.dumps(
            gap_share(model, prompts, plain, (0, n - 1), tie)), flush=True)
    k5 = "paged_chunk_int8" if int8 else "paged_chunk"
    verify_launches = None
    for k in SPEC_KS:
        engine = p17_engine(model, int8, spec_decode={"enabled": True, "k": k})
        total = engine.allocator.total_blocks
        engine.spec_stats.reset()
        got, t_spec, launches = timed_generate(engine, prompts)
        st = engine.spec_stats
        gen_stats = {"steps": st.steps, "acceptance_rate": st.acceptance_rate,
                     "tokens_per_step": st.tokens_per_step,
                     "tokens_per_row_step": st.tokens / max(1, st.rows)}
        if not launches.get(k5):
            raise AssertionError(f"phase 17 k={k} {label}: no {k5} launch in the verify steps")
        if engine.free_blocks != total:
            raise AssertionError(f"phase 17 k={k} {label}: free blocks {engine.free_blocks} "
                                 f"!= {total} after generate()")
        stream_tie(f"Llama-2-7B {label} spec k={k} vs plain", model, prompts, got, plain, tie)
        # the oracle replays the plain streams: every draft is accepted up
        # to the first near-tie a row meets
        uids = list(range(100, 100 + n))
        engine.put(uids, prompts)
        pipe = engine.decode_pipeline(uids)
        pipe.proposer = OracleProposer(prompts, plain)
        per_step = []
        engine.spec_stats.reset()
        steps = SPEC_NEW // (k + 1) - 1
        oracle = pipe.run(steps, on_tokens=lambda j, u, toks: per_step.append(
            [len(t) for t in toks]))
        ost = {"steps": steps, "acceptance_rate": engine.spec_stats.acceptance_rate,
               "tokens_per_step": engine.spec_stats.tokens_per_step}
        full_until_tie = []
        for i in range(n):
            diff = np.flatnonzero(np.asarray(oracle[i]) != np.asarray(plain[i][:len(oracle[i])]))
            cut = int(diff[0]) if diff.size else len(oracle[i])
            done = 0
            for j in range(steps):
                # a step that emits the token before the first difference
                # rejected the draft the difference replaced
                if done + per_step[j][i] >= cut:
                    break
                if per_step[j][i] != k + 1:
                    raise AssertionError(f"phase 17 k={k}: the oracle's row {i} accepted "
                                         f"{per_step[j][i] - 1} of {k} at step {j} before any "
                                         "difference from the plain stream")
                done += per_step[j][i]
            full_until_tie.append(cut)
        stream_tie(f"Llama-2-7B {label} spec k={k} oracle vs plain", model, prompts,
                   oracle, plain, tie)
        for u in uids:
            seq = engine.scheduler.seqs[u]
            if len(seq.blocks) != -(-seq.seen_tokens // 128):
                raise AssertionError(f"phase 17 k={k}: reserved pages not rolled back")
        engine.flush(uids)
        # the reject-heavy run: garbage drafts on every row at full k
        engine.put(uids, prompts)
        pipe = engine.decode_pipeline(uids)
        pipe.proposer = type("Garbage", (), {"propose": lambda self, h, kk: np.arange(
            1, kk + 1, dtype=np.int32)})()
        pipe.run(8)
        engine.flush(uids)
        if engine.free_blocks != total:
            raise AssertionError(f"phase 17 k={k}: free blocks {engine.free_blocks} != "
                                 f"{total} after the reject-heavy run")
        times = step_times(engine, model, prompts, plain, k, int8)
        row = {"pool": label, "k": k, "generate": gen_stats,
               "decode_tok_s": {"spec": n * SPEC_NEW / t_spec, "plain": n * SPEC_NEW / t_plain},
               "oracle": {**ost, "tokens_equal_to_plain": full_until_tie},
               "decode_launches": launches, "step_ms": times, "nvidia_smi": smi_line()}
        print("spec-decode " + json.dumps(row), flush=True)
        if k == 3 and not int8:
            verify_launches = launches.get(k5, 0)
        p17_free(engine)
    return verify_launches


def run_prefix_spec():
    """Phase 17: the prefix cache and speculative decoding on Llama-2-7B at
    full width and depth (random bf16 weights from seed 0), over bf16 and
    int8 KV pages. Returns the K5 verify row's launch count."""
    import torch
    t0 = time.perf_counter()
    model = p17_model()
    tie = prefix_phase(model, False, None)
    launches = spec_phase(model, False, tie)
    prefix_phase(model, True, tie)
    spec_phase(model, True, tie)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 18: multi-tenant LoRA serving on Llama-2-7B
# --------------------------------------------------------------------------- #

# phase 17's pages of 128; 80 pages hold the 8 sequences (at most 1088 tokens
# each: 9 pages) and a spec run's reservation ahead of them
P18_POOL = {"kv_cache": {"block_size": 128, "num_blocks": 80}, "seed": 0}
# all four targets at max_rank 16: one page is 32 layers x 4 x 8192 bf16 = 2
# MiB, so 48 pages (96 MiB) hold 48 of the 68 the six adapters need
P18_LORA = {"enabled": True, "targets": ("q", "k", "v", "o"), "max_rank": 16,
            "pool_pages": 48, "swap_buffers": 64}
P18_RANKS = (4, 8, 8, 16, 16, 16)
P18_LENS = (256, 1024, 384, 896, 512, 768, 640, 320)
P18_NEW = 64
P18_DELTA_RMS = 0.25      # the delta's rms against the base projection's
# run 1 binds t0-t3 (36 pages) and leaves rows 5 and 7 unbound; run 2 binds
# t4 and t5 first (32 pages: t0, t2 and t3 are evicted LRU), then t0 again
# (faulted back in from its pinned buffers) on run 1's row 0 and prompt
P18_RUN1 = ("t0", "t0", "t1", "t2", "t3", None, "t1", None)
P18_RUN2 = ("t0", None, "t4", "t5", None, "t4", None, "t5")
P18_ORDER2 = (2, 3, 5, 7, 0)
# rows held to the dense forward (b), each with another tenant for a control
P18_DENSE = ((1, 0, "t1"), (1, 4, "t2"), (2, 2, "t5"))
P18_INT8_NEW = 16
P18_NAMES = ("flash_packed", "paged_chunk", "paged_decode", "quantized_matmul_gemv",
             "quantized_matmul_mma")


def p18_sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def p18_adapters(engine, scale_rms=P18_DELTA_RMS):
    """Six adapters t0..t5 of ranks P18_RANKS with per-layer random leaves
    made from seed 18 on the engine's device: A ~ N(0, 1 / d_in), B ~ N(0,
    (s * std_w)^2 d_in / r), so the delta (x A) B has about ``s`` times the
    rms of the base projection x W (``std_w``: the layer-0 weight's std).
    Loaded through ``load_lora_adapter``; returns the scales printed (B's
    std is ``B_std_x_sqrt_r / sqrt(r)``) and the delta's measured rms
    ratio."""
    import torch
    from deepspeed_tpu_torch.inference.v2.ragged_model import lora_target_dims
    from deepspeed_tpu_torch.module_inject import load_lora_adapter
    spec, dev = engine.spec, engine.device
    L = spec.num_layers
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    keys = {"q": "wq", "k": "wk", "v": "wv", "o": "wo"}
    w0 = engine.weights["layers"][0]
    std = {t: float(_p18_dequant(w0[keys[t]]).std()) for t in keys}
    targets = engine.config.lora.targets
    scales = {"A_std": {t: lora_target_dims(spec, t)[0] ** -0.5 for t in targets},
              "B_std_x_sqrt_r": {t: scale_rms * std[t] * lora_target_dims(spec, t)[0] ** 0.5
                                 for t in targets}}
    for i, r in enumerate(P18_RANKS):
        state = {"alpha": float(r)}
        for t in targets:
            din, dout = lora_target_dims(spec, t)
            state[t] = {"A": torch.randn(L, din, r, generator=g, device=dev) * scales["A_std"][t],
                        "B": torch.randn(L, r, dout, generator=g, device=dev)
                        * (scales["B_std_x_sqrt_r"][t] / r ** 0.5)}
        load_lora_adapter(engine, f"t{i}", state)
    # the delta's rms against the base projection's on random rows, layer 0
    x = {t: torch.randn(64, lora_target_dims(spec, t)[0], generator=g, device=dev)
         for t in targets}
    delta = p18_delta(engine, f"t{len(P18_RANKS) - 1}")
    scales["measured_ratio"] = {
        t: float((x[t] @ delta(0, t)).pow(2).mean().sqrt()
                 / (x[t] @ _p18_dequant(w0[keys[t]])).pow(2).mean().sqrt())
        for t in targets}
    return scales


def _p18_dequant(w):
    """A serving weight as f32: a plain tensor, or an int8 dict dequantized
    (``w8 * scale``)."""
    return w["w8"].float() * w["scale"] if isinstance(w, dict) else w.float()


def p18_delta(engine, name):
    """``delta(l, t) -> [d_in, d_out]`` f32: adapter ``name``'s merged
    delta A @ B at layer l and target t, read back from the registry's
    master pages (the bytes the engine serves, alpha / r folded in)."""
    from deepspeed_tpu_torch.inference.v2.ragged_model import lora_target_dims
    pool, spec = engine.lora.pool, engine.spec
    targets = engine.config.lora.targets
    ad = engine.lora._adapters[name]
    m = ad.master.to(engine.device).float().view(ad.rank, spec.num_layers, len(targets),
                                                 pool.in_max + pool.out_max)

    def delta(l, t):
        p = targets.index(t)
        din, dout = lora_target_dims(spec, t)
        return m[:, l, p, :din].t() @ m[:, l, p, pool.in_max:pool.in_max + dout]

    return delta


def p18_dense(engine, seq, start, dt, delta=None):
    """Logits [len(seq) - start, V] (f32) at rows ``start..`` of a dense
    causal forward over ``seq`` in ``dt``, on the engine's own weights
    (int8 dequantized) with the adapter's merged delta (``delta(l, t)``,
    :func:`p18_delta`) added to the targeted projections' weights only at
    rows ``>= start``: the decode scope, where the prompt ran base-only."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.models.llama import apply_rope, rms_norm, rope_tables
    spec, W, dev = engine.spec, engine.weights, engine.device
    targets = engine.config.lora.targets if engine.lora is not None else ()
    H, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    ids = torch.as_tensor(np.asarray(seq, np.int64), device=dev)
    T = ids.shape[0]
    cos, sin = rope_tables(torch.arange(T, device=dev), D, spec.rope_theta)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()

    def mm(x, w, l=None, t=None):
        f = _p18_dequant(w)
        if delta is None or t not in targets:
            return x @ f.to(dt)
        return torch.cat([x[:start] @ f.to(dt), x[start:] @ (f + delta(l, t)).to(dt)])

    def attend(q, k, v):
        k, v = (a.repeat_interleave(H // Hkv, dim=1) for a in (k, v))
        s = torch.einsum("qhd,khd->hqk", q, k).float() * D ** -0.5
        s.masked_fill_(~causal, torch.finfo(torch.float32).min)
        p = torch.softmax(s, -1)
        del s
        return torch.einsum("hqk,khd->qhd", p.to(dt), v)

    x = W["embed"][ids].to(dt)
    for l, w in enumerate(W["layers"]):
        h = rms_norm(x, w["ln1"], spec.eps, dt)
        q = apply_rope(mm(h, w["wq"], l, "q").view(T, H, D), cos, sin)
        k = apply_rope(mm(h, w["wk"], l, "k").view(T, Hkv, D), cos, sin)
        v = mm(h, w["wv"], l, "v").view(T, Hkv, D)
        x = x + mm(attend(q, k, v).reshape(T, H * D), w["wo"], l, "o")
        h = rms_norm(x, w["ln2"], spec.eps, dt)
        x = x + mm(F.silu(mm(h, w["w_gate"])) * mm(h, w["w_up"]), w["w_down"])
    x = rms_norm(x[start:], W["final_norm"], spec.eps, dt)
    return mm(x, W["lm_head"]).float()


@contextlib.contextmanager
def p18_logged(engine):
    """Within the block, every decode and verify step the engine's
    pipelines launch appends its (row-sliced later) logits to the yielded
    list: the decode step's [bucket, V] logits, a verify step's final
    logits. A copy on the device: nothing waits."""
    log = []
    step_fn, verify_fn = engine._decode_step_fn, engine._verify_fn

    def logging(fn, pick):
        def call(*a, **kw):
            out = fn(*a, **kw)
            log.append(pick(out).clone())
            return out
        return call

    engine._decode_step_fn = lambda rb=0: logging(step_fn(rb), lambda o: o[1])
    engine._verify_fn = lambda k, rb=0: logging(verify_fn(k, rb), lambda o: o[2])
    try:
        yield log
    finally:
        del engine._decode_step_fn, engine._verify_fn


def p18_run(engine, prompts, binds, n, order=None, sync_check=False, proposer=None,
            logged=True):
    """One run of ``prompts`` under ``binds`` (acquired in ``order``, row
    order by default): prefill, a pipeline of ``n`` steps (the engine's
    ``decode_pipeline``: spec decode with ``proposer`` when the engine has
    it), flush, release. ``sync_check`` runs the pipeline under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns the streams, each
    step's logits of the live rows [steps, S, V] (device; with
    ``logged``), the tokens each step emitted (spec), the decode's wall
    seconds, its kernel launches and those of the prefill."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    reset_launches()
    S = len(prompts)
    uids = list(range(100, 100 + S))
    for i in (range(S) if order is None else order):
        if binds[i] is not None:
            engine.lora.acquire(uids[i], binds[i])
    per_step = []
    try:
        engine._put_nofetch(uids, [np.asarray(p, np.int32) for p in prompts])
        pipe = engine.decode_pipeline(uids)
        if proposer is not None:
            pipe.proposer = proposer
        p18_sync(engine.device)
        prefill = {k: v for k, v in LAUNCHES.items() if v}
        reset_launches()
        check = sync_check and engine.device.type == "cuda"
        with (p18_logged(engine) if logged else contextlib.nullcontext([])) as log:
            t0 = time.perf_counter()
            if check:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = pipe.run(n, on_tokens=(lambda j, u, toks: per_step.append(
                    [len(t) for t in toks])) if proposer is not None else None)
            finally:
                if check:
                    torch.cuda.set_sync_debug_mode(0)
            p18_sync(engine.device)
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        engine.flush(uids)
    finally:
        for u, b in zip(uids, binds):
            if b is not None:
                engine.lora.release(u)
    streams = [list(map(int, o)) for o in out]
    return {"streams": streams, "logits": torch.stack([x[:S] for x in log]) if log else None,
            "per_step": per_step, "wall_s": wall, "launches": launches,
            "prefill_launches": prefill}


def p18_bitwise(label, run, ref, rows):
    """Rows ``rows`` of two runs: the same streams and the same logits at
    every step, bit for bit."""
    import torch
    for i in rows:
        if run["streams"][i] != ref["streams"][i]:
            raise AssertionError(f"{label}: row {i}'s stream differs")
        if not torch.equal(run["logits"][:, i], ref["logits"][:, i]):
            d = float((run["logits"][:, i] - ref["logits"][:, i]).abs().max())
            raise AssertionError(f"{label}: row {i}'s logits differ (max {d})")


def p18_dense_check(label, engine, prompt, run, i, name, other):
    """(b): row ``i`` of ``run`` (bound to ``name``) after each step, held
    to the dense fp32 forward with ``name``'s delta in the decode scope:
    each step's rms within 2x the dense bf16 forward's. Two controls, the
    dense fp32 forward without the delta and with tenant ``other``'s, must
    fail that limit (pooled over the steps). Returns the numbers to print
    and the dense fp32 and bf16 logits (for the near-tie checks and spec's
    final rows)."""
    import torch
    n = run["logits"].shape[0]
    seq = np.concatenate([prompt, np.asarray(run["streams"][i][:n], np.int32)])
    start = len(prompt)
    delta = p18_delta(engine, name)
    f32 = p18_dense(engine, seq, start, torch.float32, delta)
    bf16 = p18_dense(engine, seq, start, torch.bfloat16, delta)
    base = p18_dense(engine, seq, start, torch.float32)
    wrong = p18_dense(engine, seq, start, torch.float32, p18_delta(engine, other))
    eng = run["logits"][:, i].float()
    if not bool(torch.isfinite(eng).all()):
        raise AssertionError(f"{label}: logits are not finite")

    def rms(d, dim=None):
        return d.pow(2).mean(dim).sqrt() if dim is not None else float(d.pow(2).mean().sqrt())

    step_eng, step_bf16 = rms(eng - f32, -1), rms(bf16 - f32, -1)
    out = {"row": i, "adapter": name, "steps": n, "engine_rms": rms(eng - f32),
           "dense_bf16_rms": rms(bf16 - f32), "dense_bf16_max": float((bf16 - f32).abs().max()),
           "worst_step_ratio": float((step_eng / step_bf16).max()),
           "no_delta_rms": rms(eng - base), "other_tenant_rms": rms(eng - wrong),
           "other_tenant": other}
    out["limit"] = 2 * out["dense_bf16_rms"]
    if not bool((step_eng <= 2 * step_bf16).all()):
        raise AssertionError(f"{label}: a step's logits rms exceeds 2x the dense bf16's "
                             f"(worst ratio {out['worst_step_ratio']})")
    for c in ("no_delta_rms", "other_tenant_rms"):
        if not out[c] > out["limit"]:
            raise AssertionError(f"{label}: the control {c} {out[c]} passed the limit "
                                 f"{out['limit']}")
    return out, (f32, bf16)


def p18_profile(fn):
    """``fn`` once under the CUDA profiler: device ms, kernel count and
    (count, ms) by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            c = by.setdefault(e.name(), [0, 0.0])
            c[0] += 1
            c[1] += e.duration_ns() / 1e6
    return {"device_ms": sum(v[1] for v in by.values()),
            "kernels": sum(v[0] for v in by.values()), "by_name": by}


def p18_step_times(engine, prompts, binds):
    """The LoRA decode step at rank bucket 16 beside the base step (rank
    bucket 0) of the same engine, on the same 8 rows under ``binds``: wall
    ms (host clock between syncs, median and least of 5 calls after 2
    warm-up calls) and device ms and kernels (profiled once); the delta's
    device ms, share and launches a step are the difference. The gather
    (``lora_layer_operands`` over every layer, as a step runs it) is
    profiled alone."""
    import torch
    from deepspeed_tpu_torch.inference.v2.ragged.ragged_batch import to_device
    from deepspeed_tpu_torch.inference.v2.ragged_model import lora_layer_operands
    uids = list(range(300, 300 + len(prompts)))
    for u, b in zip(uids, binds):
        if b is not None:
            engine.lora.acquire(u, b)
    engine.put(uids, prompts)
    db = engine.scheduler.decode_batch(uids, 2, engine.scratch_block)
    dev = engine.device
    bt, pos = to_device(db.block_tables, dev), to_device(db.positions, dev)
    ids = engine._sample_device_padded(uids, False, 1.0, 0)
    rb = engine.lora_rank_bucket
    lora = engine._lora_operands(uids, db.bucket, rb)
    steps = {"lora": lambda: engine._decode_step_fn(rb)(
                 engine.weights, engine.kv.kv, ids, pos, bt, pos + 1, kv_scales=engine.kv.scales,
                 **lora),
             "base": lambda: engine._decode_step_fn(0)(
                 engine.weights, engine.kv.kv, ids, pos, bt, pos + 1,
                 kv_scales=engine.kv.scales)}
    out = {}
    for label, step in steps.items():
        walls = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
        prof = p18_profile(step)
        out[label] = {"wall_ms_median": float(np.median(walls)), "wall_ms_min": min(walls),
                      "device_ms": prof["device_ms"], "kernels": prof["kernels"],
                      "by_name": prof["by_name"]}
    lo, ba = out["lora"], out["base"]
    added = {k: [v[0] - ba["by_name"].get(k, [0, 0.0])[0],
                 v[1] - ba["by_name"].get(k, [0, 0.0])[1]] for k, v in lo["by_name"].items()}
    targets = engine.config.lora.targets
    gather = p18_profile(lambda: [lora_layer_operands(engine.spec, targets, lora["lora_pool"],
                                                      lora["adapter_pt"], l)
                                  for l in range(engine.spec.num_layers)])
    delta_ms = lo["device_ms"] - ba["device_ms"]
    res = {"rank_bucket": rb, "rows": len(uids), "bucket": db.bucket,
           "lora_step": {k: v for k, v in lo.items() if k != "by_name"},
           "base_step": {k: v for k, v in ba.items() if k != "by_name"},
           "delta_device_ms": delta_ms, "delta_share_of_lora_step": delta_ms / lo["device_ms"],
           "delta_launches_per_step": lo["kernels"] - ba["kernels"],
           "gather_device_ms": gather["device_ms"], "gather_kernels": gather["kernels"],
           "top_added_kernels_ms": sorted([[k[:120], v[0], v[1]] for k, v in added.items()],
                                          key=lambda r: -r[2])[:8]}
    engine.flush(uids)
    for u, b in zip(uids, binds):
        if b is not None:
            engine.lora.release(u)
    return res


def p18_tok_s(engine, prompts, binds, n=32):
    """Decode tok/s of one unlogged pipeline run of ``n`` steps."""
    run = p18_run(engine, prompts, binds, n, logged=False)
    return len(prompts) * n / run["wall_s"]


@contextlib.contextmanager
def p18_swaps(engine):
    """Within the block, each fault-in and eviction the registry records is
    appended to the yielded list: adapter, op, ms (a fault-in's includes
    the evictions it caused) and bytes."""
    st = engine.lora.stats
    log = []
    fault, evict = st.record_fault, st.record_evict

    def rec(op, fn):
        def call(name, nbytes, dt_s):
            log.append({"adapter": name, "op": op, "ms": dt_s * 1e3, "bytes": int(nbytes)})
            return fn(name, nbytes, dt_s)
        return call

    st.record_fault, st.record_evict = rec("fault-in", fault), rec("evict", evict)
    try:
        yield log
    finally:
        del st.record_fault, st.record_evict


def p18_baseline(label, engine):
    """(g): after a drain, no adapter is bound, every pool page is free or
    held by a resident adapter, no pinned buffer is out, and the KV pool is
    whole."""
    reg = engine.lora
    reg.drain_swap()
    resident = sum(reg.rank(n) for n in reg.names if reg.is_resident(n))
    state = {"refcounts": {n: reg.refcount(n) for n in reg.names},
             "free_pages": reg.pool.free_pages, "resident_pages": resident,
             "pinned_out": reg.swap.outstanding, "kv_free": engine.free_blocks}
    if (any(state["refcounts"].values()) or reg.pool.free_pages + resident != reg.pool.num_pages
            or reg.swap.outstanding or engine.free_blocks != engine.allocator.total_blocks):
        raise AssertionError(f"{label}: not at baseline after the drain: {state}")
    return state


def p18_engine(model, **conf):
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    dev = model.embed_tokens.embedding.device
    return InferenceEngineV2(model, {**P18_POOL, **conf}, model.flat_params(), device=dev)


def run_lora(model=None, lens=P18_LENS, new=P18_NEW, int8_new=P18_INT8_NEW):
    """Phase 18: multi-tenant LoRA serving on Llama-2-7B at full width and
    depth (random bf16 weights from seed 0): six adapters over a 48-page
    pool, two mixed runs of 8 sequences, checks (a)-(h). ``model`` and the
    sizes default to the phase's."""
    import torch
    t_phase = time.perf_counter()
    own = model is None
    model = p17_model() if own else model
    dev = model.embed_tokens.embedding.device
    V = model.config.vocab_size
    rng = np.random.RandomState(19)
    prompts = [rng.randint(0, V, n).astype(np.int32) for n in lens]
    S = len(prompts)
    engine = p18_engine(model, lora=P18_LORA)
    scales = p18_adapters(engine)
    page_bytes = engine.lora.pool.page_nbytes
    with p18_swaps(engine) as swaps:
        # run 1, under set_sync_debug_mode("error") (f)
        run1 = p18_run(engine, prompts, P18_RUN1, new, sync_check=True)
        t0_pages = engine.lora.pool.fetch_pages(engine.lora._adapters["t0"].page_ids)
        run2 = p18_run(engine, prompts, P18_RUN2, new, order=P18_ORDER2)
        t0_back = engine.lora.pool.fetch_pages(engine.lora._adapters["t0"].page_ids)
    st = engine.lora.stats.adapters
    if not (st["t0"].evictions >= 1 and st["t0"].faults >= 2):
        raise AssertionError(f"phase 18: t0 was not evicted and faulted back in "
                             f"({st['t0'].evictions} evictions, {st['t0'].faults} faults)")
    if not (run1["launches"].get("paged_decode") and run1["prefill_launches"].get("flash_packed")):
        raise AssertionError(f"phase 18: run 1 launched {run1['launches']} in its decode, "
                             f"{run1['prefill_launches']} in its prefill")
    # (d) t0's pages and stream after its restore
    if not torch.equal(t0_pages.view(torch.int16), t0_back.view(torch.int16)):
        raise AssertionError("phase 18: t0's pages changed across evict and restore")
    p18_bitwise("phase 18 (d) t0 after restore", run2, run1, [0])
    # (a) each bound row against its run with every other row unbound
    t_a = time.perf_counter()
    for label, run, binds in (("run 1", run1, P18_RUN1), ("run 2", run2, P18_RUN2)):
        for i, b in enumerate(binds):
            if b is not None:
                only = tuple(b if j == i else None for j in range(S))
                p18_bitwise(f"phase 18 (a) {label} row {i}", p18_run(engine, prompts, only, new),
                            run, [i])
    t_a = time.perf_counter() - t_a
    # (b) bound rows against the dense forward in the decode scope
    dense, checks = {}, []
    for r, i, other in P18_DENSE:
        run, binds = (run1, P18_RUN1) if r == 1 else (run2, P18_RUN2)
        out, dense[(r, i)] = p18_dense_check(f"phase 18 (b) run {r} row {i}", engine,
                                             prompts[i], run, i, binds[i], other)
        checks.append({"run": r, **out})
    tie = 2 * max(c["dense_bf16_max"] for c in checks)
    # (c) unbound rows against a LoRA-off engine's, same bucket
    off = p18_engine(model)
    run_off = p18_run(off, prompts, (None,) * S, new)
    p18_bitwise("phase 18 (c) unbound rows vs LoRA off", run1, run_off,
                [i for i, b in enumerate(P18_RUN1) if b is None])
    # rates and step times: LoRA at rank bucket 16 against LoRA off
    rates = {"lora_rb16": p18_tok_s(engine, prompts, P18_RUN1),
             "lora_off": p18_tok_s(off, prompts, (None,) * S)}
    steps = p18_step_times(engine, prompts, P18_RUN1) if dev.type == "cuda" else None
    del off
    gc.collect()
    # (e) spec decode (k = 3) with adapters, an oracle replaying run 1
    spec = p18_engine(model, lora=P18_LORA, spec_decode={"enabled": True, "k": 3})
    p18_adapters(spec)
    k_steps = new // 4 - 1
    run_spec = p18_run(spec, prompts, P18_RUN1, k_steps,
                       proposer=OracleProposer(prompts, run1["streams"]))
    if not run_spec["launches"].get("paged_chunk"):
        raise AssertionError(f"phase 18 (e): no K5 launch in the verify steps "
                             f"({run_spec['launches']})")
    spec_check = p18_spec_check(engine, prompts, run1, run_spec, dense, tie)
    p18_baseline("phase 18 spec engine", spec)
    del spec
    gc.collect()
    baseline = p18_baseline("phase 18", engine)
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (h) int8 weights under the deltas: K8 runs the base products
    int8 = p18_int8(model, prompts[:4], int8_new)
    print("lora " + json.dumps({
        "adapters": {f"t{i}": r for i, r in enumerate(P18_RANKS)},
        "pool_pages": P18_LORA["pool_pages"],
        "page_bytes": page_bytes,
        "scales": scales, "run1_launches": {"prefill": run1["prefill_launches"],
                                            "decode": run1["launches"]}, "dense": checks,
        "tie_limit": tie, "rows_bit_equal_a_s": t_a, "spec": spec_check,
        "decode_tok_s": rates, "step": steps, "swaps": swaps, "baseline": baseline,
        "int8": int8, "nvidia_smi": smi_line() if dev.type == "cuda" else "cpu"}), flush=True)
    if own:
        del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)


def p18_spec_check(engine, prompts, run1, run_spec, dense, tie):
    """(e): spec streams against run 1's (equal, or parting where the dense
    fp32 LoRA forward's top-2 gap is under ``tie``), and every step's final
    row of the rows (b) checked, while the spec stream still equals run 1's,
    within 2x the dense bf16 rms at its position."""
    import torch
    gaps = {}

    def gap_at(i, step):
        if step == 0:
            return float("nan")       # the bootstrap token: prefill, the same in both
        if i not in gaps:
            f32 = dense.get((1, i), (None,))[0]
            if f32 is None:
                seq = np.concatenate([prompts[i], np.asarray(run1["streams"][i], np.int32)])
                b = P18_RUN1[i]
                f32 = p18_dense(engine, seq, len(prompts[i]), torch.float32,
                                None if b is None else p18_delta(engine, b))
            gaps[i] = f32
        top = torch.topk(gaps[i][step - 1], 2).values
        return float(top[0] - top[1])

    n = min(len(s) for s in run_spec["streams"])
    same_or_near_tie("Llama-2-7B LoRA spec k=3 vs plain LoRA",
                     np.array([s[:n] for s in run_spec["streams"]]),
                     np.array([s[:n] for s in run1["streams"]]), gap_at, tie)
    rows = {}
    for (r, i), (f32, bf16) in dense.items():
        if r != 1:
            continue
        done, worst, checked = 0, 0.0, 0
        for j, counts in enumerate(run_spec["per_step"]):
            done += counts[i]
            if done > f32.shape[0] or run_spec["streams"][i][:done] != run1["streams"][i][:done]:
                break
            eng = run_spec["logits"][j, i].float()
            e = float((eng - f32[done - 1]).pow(2).mean().sqrt())
            lim = 2 * float((bf16[done - 1] - f32[done - 1]).pow(2).mean().sqrt())
            if not e <= lim:
                raise AssertionError(f"phase 18 (e) row {i} step {j}: final logits rms {e} > "
                                     f"2x dense bf16 {lim / 2}")
            worst, checked = max(worst, e / lim), checked + 1
        if checked == 0:
            raise AssertionError(f"phase 18 (e) row {i}: no verify step to check")
        rows[i] = {"steps_checked": checked, "worst_rms_over_limit": worst}
    counts = np.array(run_spec["per_step"])
    return {"steps": len(run_spec["per_step"]), "tokens_per_row_step": float(counts.mean()),
            "final_rows": rows, "launches": run_spec["launches"]}


def p18_int8(model, prompts, n):
    """(h): a short run on int8 weights (K8 under the deltas): (a) for its
    bound rows and (b) for two of them against the dense forward over the
    dequantized weights."""
    import torch
    engine = p18_engine(model, lora=P18_LORA, quantization={"weight_bits": 8})
    p18_adapters(engine)
    binds = ("t0", None, "t3", "t1")
    run = p18_run(engine, prompts, binds, n)
    if not run["launches"].get("quantized_matmul_gemv"):
        raise AssertionError(f"phase 18 (h): no K8 gemv launch ({run['launches']})")
    for i, b in enumerate(binds):
        if b is not None:
            only = tuple(b if j == i else None for j in range(len(binds)))
            p18_bitwise(f"phase 18 (h) row {i}", p18_run(engine, prompts, only, n), run, [i])
    checks = [p18_dense_check(f"phase 18 (h) row {i}", engine, prompts[i], run, i, binds[i],
                              other)[0] for i, other in ((0, "t1"), (2, "t2"))]
    state = p18_baseline("phase 18 (h)", engine)
    del engine
    gc.collect()
    if model.embed_tokens.embedding.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"launches": run["launches"], "dense": checks, "baseline": state}


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
    with bitwise_reruns():
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
    torch.cuda.empty_cache()
    # phase 13: its K2, K5, decode and K7 rows keep phases 4's and 6's counts
    run_phi2()
    gc.collect()
    torch.cuda.empty_cache()
    # phase 14: the grouped K8 rows take its counts; the others keep theirs
    grouped = ("quantized_matmul_grouped_gemv", "quantized_matmul_grouped_mma")
    launches.update({k: v for k, v in run_mixtral().items() if k in grouped})
    gc.collect()
    torch.cuda.empty_cache()
    run_qwen2()
    gc.collect()
    torch.cuda.empty_cache()
    run_gemma()
    gc.collect()
    torch.cuda.empty_cache()
    # phase 17: the K5 verify row takes the k = 3 verify steps' count
    launches["paged_chunk_verify"] = run_prefix_spec()
    # phase 18: multi-tenant LoRA; its kernels are the rows above, counted there
    run_lora()
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
    sources["paged_chunk_verify"] = (paged_chunk.SOURCE, paged_chunk.REPLACES_VERIFY)
    sources.update(KERNELS)
    sources.update({
        qmm.GEMV: (qmm.SOURCE, qmm.REPLACES), qmm.MMA: (qmm.SOURCE, qmm.REPLACES),
        qmm.GEMV_INT4: (qmm.SOURCE, qmm.REPLACES_INT4),
        qmm.GROUPED_GEMV: (qmm.SOURCE, qmm.REPLACES_GROUPED),
        qmm.GROUPED_MMA: (qmm.SOURCE, qmm.REPLACES_GROUPED),
        paged_decode.NAME_INT8: (paged_decode.SOURCE, paged_decode.REPLACES_INT8),
        paged_chunk.NAME_INT8: (paged_chunk.SOURCE, paged_chunk.REPLACES_INT8),
        **{paged_splitk.kernel_name(n, quant=True): (paged_splitk.SOURCE,
                                                     paged_splitk.REPLACES)
           for n in (2, 4, 8)},
        paged_splitk.MERGE: (paged_splitk.SOURCE, paged_splitk.REPLACES_MERGE)})
    fp = sys.modules["deepspeed_tpu_torch.ops.kernels.flash_packed"]
    sources.update({
        fp.NAME_WINDOW: (fp.SOURCE, fp.REPLACES_WINDOW),
        fp.NAME_LSE: (fp.SOURCE, fp.REPLACES_LSE),
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
