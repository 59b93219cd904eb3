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

17. the prefix cache and speculative decoding on Llama-2-7B at full width,
   cut to ``P17_LAYERS`` (8) of its 32 layers (random bf16 weights from
   seed 0), over bf16 and then int8 KV
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
18. multi-tenant LoRA on Llama-2-7B at full width, cut to 8 of its 32
   layers (random bf16 weights from seed 0): all four targets, max_rank
   16, a 48-page pool; six adapters of ranks 4, 8, 8, 16, 16, 16 (68 pages) whose delta
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
19. checkpoint and resume on phase 5's model and config (GPT-2 small, bf16
   with an fp32 master, seeded random weights) over 10 distinct global
   batches of 16 x 1024 tokens, under a ``tempfile.mkdtemp()`` directory
   (the free space checked first, removed at the end). Checks: (a) two
   uninterrupted runs (A, and A' which saves at step 5 on the native
   engine) print whether their losses and final masters are bitwise equal;
   (b) a fresh engine from another seed loads ``global_step5`` with
   ``verify=True`` and trains batches 6-10; (c) async writers with rolling
   saves every 2 steps (keep 2, 1 pending) over the 10 batches, then after
   ``destroy()`` exactly ``rolling_step8`` and ``rolling_step10`` with
   ``latest`` at the second, and a fresh engine resumed with ``tag=None``;
   (d) ``ds_to_universal`` of the step-5 tag into an engine with
   ``load_universal``; (e) ``zero_to_fp32``'s ``.pt`` equal to the step-5
   master; (f) 120 launches of each K1 kernel over (b)'s 5 steps. (b)-(d)
   hold losses and masters within (a)'s own difference (zero when (a) is
   bitwise). Printed on the ``checkpoint`` line: bytes a tag, the native
   and async save ms (snapshot, write, commit), the load ms (read, verify,
   host->device), the policed drain against a blocking copy a leaf, the
   rolling run's snapshot and backpressure ms a save and its step ms
   beside a run without rolling, and the phase's seconds.

20. one-device training at Llama-2-7B's full width (vocab 32000, hidden
   4096, FFN 11008, 32/32 heads, D 128; random bf16 weights from seed 0)
   cut to 8 of its 32 layers (1.88 B parameters), T 4096, bf16 with an
   fp32 master, FusedLamb and WarmupLR, micro-batch 1 x gas 4, remat on
   (policy ``none``, a chunk a layer), ``training_data`` an
   ``MMapIndexedDataset`` of seeded Zipf-ranked tokens written under a
   ``tempfile.mkdtemp()`` directory, through the engine's loader at
   ``train_pipeline.prefetch`` 2. (a) K1's three kernels at the path's
   shape (B 1, T 4096, 32 heads, D 128, causal) against their plain
   versions, each backward rerun bitwise, timed beside SDPA's flash
   backend (the ``k1-d128`` line); the first micro-batch's loss and
   gradient against an fp32 forward/backward with plain attention (phase
   5's rule); 6 steps of the main path (losses finite, the last two
   steps' mean below the first and none past 1.5x it; K1 launches 64 /
   32 / 32 a step), step ms, tokens/s, peak GiB, host
   enqueue against wall, a profiled step. (b) byte gates: prefetch 0 and
   the forward/backward/step facade give the main path's first 4 losses
   and its master bit for bit; at 2 layers, remat off, ``none`` and
   ``attn_out_saveable`` give the same loss, gradients and step bit for
   bit, with 8 / 16 / 8 K1 forward launches a step. (c) LAMB, Lion,
   Adagrad and SGD with momentum on GPT-2 small at 2 layers: 3 steps, a
   save, 3 more; a fresh engine resumed from the tag repeats the last 3
   with the same losses, masters and optimizer states bit for bit. (d)
   there, PLD at theta 1 bit-equal to PLD off, PLD's streams bit-equal at
   prefetch 0 and 2, and a curriculum seqlen schedule 256 -> 1024 staging
   256/512/768/1024 tokens and running K1 at each.

21. Llama-2-7B behind ``ServingFrontend`` at full width, cut to
   ``P21_LAYERS`` (8) of its 32 layers (random bf16 weights from seed 0):
   pages of 128, 48 of them (6144 tokens), the prefix cache on, the
   default classes (interactive / standard / batch), offload preemption,
   ``engine.warmup()`` first. Traffic: ``PoissonLoadGen`` at seed 0, 32
   arrivals at 8 requests/s replayed against the running frontend
   (interactive prompts 256-1024 tokens, 64-128 new; batch 1536-3072, 32-64
   new; eight interactive prompts share one 1024-token prefix); then, by
   ``step()``, a deterministic preemption, a request cancelled while
   queued, one during its prefill and one mid-decode, one shed, one decode
   slice under ``set_sync_debug_mode("error")`` (the pipeline's drain
   excepted) and a profiled one. Fatal: every finished stream equal to its
   prompt served alone by ``generate()`` or parting at a near tie (phase
   17's rule); every preempted-then-restored request's private pages and
   last-logits row bit-equal across the round trip, no prefix-shared page
   offloaded, at least one preemption and restore; no step-cache entry
   added after warmup; after ``close()`` the free pages, the scheduler,
   the offload store and the pinned pool at baseline; K2, K5 and the
   decode kernel launched. Printed on the ``frontend`` line: TTFT and TBT
   p50/p99 and goodput per class, output tok/s, preemptions, restores,
   offloaded bytes, each offload's and restore's ms, the profiled slice's
   device against wall ms, peak GiB.
22. ``ServingCluster`` + ``ServingRouter`` over two Llama-2-7B replicas on
   the one card, sharing the model's bf16 tree: (a) cache-aware routing of
   16 requests in two prefix groups (1024 + 128 tokens, 32 new each): hits
   routed, each group's later requests on the replica holding its prefix;
   (b) one ``prefill`` and one ``decode`` replica, 8 requests: each
   handoff's exported pages read back from the decode engine's imported
   blocks byte for byte, the logits row bit for bit, no prefill on the
   decode engine; (c) a fault at r1's serving-loop site mid-stream:
   without a health monitor ``drain()`` names ``replica 'r1'``; with one,
   r1's requests migrate to r0, one failure and its migrations are
   counted, every stream is 32 tokens long, then r1 rejoins by hand and
   its warmup adds no step-cache entry. Every finished stream against
   ``generate()`` alone, as in phase 21, and each migrated stream past its
   seal against ``generate()`` of the prompt and the tokens streamed
   before it. Both engines are warmed before the launch counts are
   zeroed; K2 and the decode kernel must launch in each part's traffic
   ((c)'s counts are read before the rejoin), K5 in the phase's. Printed
   on the ``router`` line: route ms, handoff ms (export start to import
   end; the byte check runs after the drain) and bytes a sequence,
   migration ms, each part's launches.

23. one Llama-2-7B-width policy (8 of 32 layers, seeded random weights)
   that trains and serves on the card: ``initialize`` with
   ``hybrid_engine.enabled`` (bf16 with an fp32 master, AdamW lr 1e-5,
   clipping 1.0, micro-batch 4 x gas 2) and a v2 engine over its master
   (pages of 128, 64 of them, the prefix cache, warmup) behind its
   frontend. (a) after 2 steps the WeightBridge's tree equals a fresh
   engine's bit for bit, one layout build, a sync under the profiler and
   ``set_sync_debug_mode("error")`` copies nothing across the host link, a
   donating sync keeps every serving tensor and raises the peak by less
   than the largest leaf; sync ms against the bound. (b) the swap adds no
   step-cache entry; the prefix cache hits before it, misses on the first
   request after it and hits on the second; a control's final-row logits
   change and equal a fresh engine's; 8 greedy streams equal a fresh
   engine's or part at a near tie. (c) 8 requests of 64 tokens decode on
   the running frontend while ``bridge.sync_and_swap(fe)`` swaps in one
   more step's weights: every live request is recompute-preempted and
   finishes, its tokens before the swap on the old weights' streams and
   after it on a fresh new-weights engine's. (d) ``RolloutLoop``: 3 rounds
   of 8 rollouts (384-448 prompt tokens sharing 256, 64 new) collated to
   [8, 512], one step each; its stats equal the tracer's spans; the hybrid
   engine's ``generate`` ([4, 128], 32 new) follows 2 more steps and
   equals a fresh ``InferenceEngine``'s, its prefill logits within 2x the
   dense bf16 rms; then the loop's losses equal, bit for bit, a trainer
   rebuilt from the seed replaying the same batches. K1, K2, K5 and the
   decode kernel must launch on the main path (counted before the
   replay, the comparison engines' launches taken out).

25. observability and resilience (``run_observability``). (a) phase 20's
   trainer (8 of Llama-2-7B's 32 layers, T 4096, FusedLamb, micro-batch 1
   x gas 4) twice from seed 0, 5 steps each: everything off, then the CSV
   sink, the live Prometheus exporter (port 0), the tracer, the flops
   profiler at step 1 and a print every step on. Losses and masters bit
   for bit, K1's launches a step unchanged (the profiler's 5 forwards add
   their own), the median device step wall of steps 2-5 (CUDA events)
   within 5%, the CSV rows and ``GET /metrics`` against the returned
   losses, the step stats against the ``train/step/*`` spans, the counted
   forward flops against the closed form; then 2 facade steps under
   ``wall_clock_breakdown`` print the fwd/bwd/step timers. (b) Llama-2-7B
   at 32 layers, 8 prompts of 128-1024 tokens, 64 greedy tokens through
   the decode pipeline untraced and traced (a ``TelemetryPump`` into an
   exporter): byte-identical streams, 64 ``serve/decode/step`` spans, one
   ``serve/attn/select`` a step, the drained row's bytes, every
   ``inference/v2/pipeline/*`` field, the median step wall within 5%, and
   a profiled run's busy share. (c) phase 19's GPT-2 small under the
   lock-order sanitizer, traced, with rolling async saves: bit-equal
   losses against a plain run, every ``ckpt/*`` span, no lock cycle. Each
   part's trace passes ``scripts/trace_check.py``.
26. the v1 engine's int8 tiers, the DecoderLM and Mixtral dense decodes
   and ZeRO++ qwZ (``run_quantized_v1``), random weights from seed 0. (a)
   Llama-2-7B at 32 layers through ``init_inference``, 4 prompts of 1024
   tokens and 32 new: int8 weights (group 64) whose streams and step
   logits are bit-equal to the bf16 engine over the engine's own
   ``module_state_dict()`` (the bf16 engine on the original weights must
   differ), then int8 weights + the int8 cache, whose step logits meet
   phase 6's rule (RMS against a one-pass fp32 decode over the same int8
   rounding within 2x a one-pass bf16 decode's) with a control whose
   prompt scales are corrupted after the prefill failing it; parameter
   and cache bytes, prefill ms, decode ms a step, peak GiB. (b) Falcon-7B
   at 32 layers (71 heads over one KV head), ``DecoderLM.decode`` with a
   bf16 cache (against ``forward_logits`` at fp32, the bf16 rule) and the
   int8 cache. (c) Mixtral-8x7B at full width, 8 of 32 layers, bf16 and
   int8 weights (bit-equal on ``module_state_dict()``, the control
   differing, the stream against the dense fp32 forward's argmax up to a
   near-tie). Streams equal or parting only at a near-tie. (d) qwZ on 8 of
   Llama-2-7B's layers at T 1024, AdamW: step 1 bit-equal to the plain
   engine on the quantized master's dequantization, 4 losses within rtol
   0.1 / atol 0.15 of it and falling, int8 compute params, K1 launched; a
   qwZ save and load resume bit for bit (GPT-2 small at 2 layers).

The last two lines are the kernel table (58 rows, K5 at the verify step's
shape among them; the rows of K1, K2, K5, the decode kernel and K7 carry
their launches in phases 21-26 as ``serving_launches``) and ``{"ok": true,
"device": ...}`` as JSON. Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import collections
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
    first_step_verdict("first-step", loss32, loss_e, ref["bf16"][0], rms(g32),
                       rms(g_e - g32), rms(ref["bf16"][1] - g32))


def first_step_verdict(label, loss32, loss_e, loss_bf16, grad_rms32, grad_err_e,
                       grad_err_bf16) -> dict:
    """Print the first-step line and fail unless the engine's loss and
    gradient errors are within 2x the bf16 plain pass's plus
    FIRST_STEP_FLOOR of the fp32 yardstick's scale."""
    out = {"loss_fp32": loss32, "loss_engine": loss_e, "loss_bf16_plain": loss_bf16,
           "loss_err_engine": abs(loss_e - loss32),
           "loss_err_bf16_plain": abs(loss_bf16 - loss32),
           "grad_rms_fp32": grad_rms32, "grad_rms_err_engine": grad_err_e,
           "grad_rms_err_bf16_plain": grad_err_bf16, "floor_share": FIRST_STEP_FLOOR}
    print(f"{label} " + json.dumps(out), flush=True)
    for what, scale in (("loss", abs(loss32)), ("grad_rms", grad_rms32)):
        limit = 2 * out[f"{what}_err_bf16_plain"] + FIRST_STEP_FLOOR * scale
        if not out[f"{what}_err_engine"] <= limit:
            raise AssertionError(f"{label}: engine {what} error "
                                 f"{out[f'{what}_err_engine']} > {limit}")
    return out


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
# phase 17's depth: 8 of Llama-2-7B's 32 layers at full width (cut to make
# room for phase 26 inside the script's time limit)
P17_LAYERS = 8
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


def p17_model(layers: int = 32):
    import torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b(dtype=torch.bfloat16, num_hidden_layers=layers)
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
    full width and ``P17_LAYERS`` of its 32 layers (random bf16 weights
    from seed 0), over bf16 and int8 KV pages. Returns the K5 verify row's
    launch count."""
    import torch
    t0 = time.perf_counter()
    model = p17_model(P17_LAYERS)
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
# phase 18's depth: 8 of Llama-2-7B's 32 layers at full width (cut to make
# room for phase 23 inside the script's time limit)
P18_LAYERS = 8
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
    """Phase 18: multi-tenant LoRA serving on Llama-2-7B at full width, cut
    to ``P18_LAYERS`` layers (random bf16 weights from seed 0): six
    adapters over a 48-page pool, two mixed runs of 8 sequences, checks
    (a)-(h). ``model`` and the sizes default to the phase's."""
    import torch
    t_phase = time.perf_counter()
    own = model is None
    model = p17_model(P18_LAYERS) if own else model
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


# --------------------------------------------------------------------------- #
# phase 19: checkpoint and resume at GPT-2 small's width
# --------------------------------------------------------------------------- #

P19_STEPS, P19_AT = 10, 5
# the most the phase holds on disk at once: a tag (~1.5 GB), its universal
# copy and the zero_to_fp32 file, then up to four rolling tags while the
# committer lags (~6 GB)
P19_DISK_BYTES = 8 * 10 ** 9
P19_ROLLING = {"engine": "async", "writers": 2,
               "rolling": {"every_n_steps": 2, "keep_last": 2, "max_pending": 1}}


def p19_engine(cfg, dev, seed: int, config):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead
    model = GPT2LMHead(cfg, device=dev, seed=seed)
    return deepspeed_tpu_torch.initialize(model=model, config=config, device=dev)[0]


def p19_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def p19_train(engine, batches, dev):
    """(losses as a float32 array, wall ms a step) of ``train_steps`` over
    ``batches``; the clock ends in a device sync."""
    p19_sync(dev)
    t0 = time.perf_counter()
    losses = engine.train_steps(len(batches), data_iter=iter(batches))
    p19_sync(dev)
    return losses, (time.perf_counter() - t0) * 1e3 / len(batches)


def p19_master(engine) -> dict:
    return {n: t.detach().clone() for n, t in engine.state["master"].items()}


def p19_diff(losses, ref_losses, master, ref_master):
    """(largest |loss - ref|, 0 without losses; largest |master - ref| over
    every leaf)."""
    loss = 0.0 if losses is None else float(
        np.max(np.abs(losses.astype(np.float64) - ref_losses.astype(np.float64))))
    return loss, max(float((master[n] - t).abs().max()) for n, t in ref_master.items())


def p19_gate(label: str, got, ctrl) -> None:
    """A resumed run against the uninterrupted one: within the control's
    own difference, which is (0, 0) when the control is bitwise."""
    print(f"phase 19 {label}: loss diff {got[0]}, master diff {got[1]} "
          f"(control {ctrl[0]}, {ctrl[1]})", flush=True)
    if got[0] > ctrl[0] or got[1] > ctrl[1]:
        raise AssertionError(f"phase 19 {label}: {got} beyond the control's {ctrl}")


def p19_counters(label: str, engine, steps: int, rows: int, gas: int) -> None:
    got = (engine.global_steps, engine.global_samples, engine.micro_steps)
    if got != (steps, steps * rows, steps * gas):
        raise AssertionError(f"phase 19 {label}: counters {got} != "
                             f"{(steps, steps * rows, steps * gas)}")


def p19_drains(engine, dev) -> dict:
    """ms of the snapshot's policed drain (fresh pinned buffers from the
    caching host allocator, one sync; twice) against one blocking
    ``.to("cpu")`` a leaf, on the same state."""
    from deepspeed_tpu_torch.checkpoint.state import flatten_tree, snapshot_state_flats
    out = {}
    for name in ("policed_1", "policed_2"):
        p19_sync(dev)
        t0 = time.perf_counter()
        flats = snapshot_state_flats(engine.state)
        out[name] = (time.perf_counter() - t0) * 1e3
        del flats
    st = engine.state
    leaves = flatten_tree({"master": st["master"], "opt": st["opt"], "step": st["step"],
                           "scaler": st["scaler"], "skipped": st["skipped"]})
    p19_sync(dev)
    t0 = time.perf_counter()
    host = {k: v.detach().to("cpu").clone() for k, v in leaves.items()}
    out["per_leaf_blocking"] = (time.perf_counter() - t0) * 1e3
    out["leaves"] = len(host)
    return out


def run_checkpoint(cfg=None, config=None, device="cuda"):
    """Phase 19: checkpoint and resume on phase 5's model and config (GPT-2
    small, bf16 with an fp32 master) over 10 distinct global batches.
    Checks: (a) control, engines A and A' (seed 0) over the 10 batches; (b)
    A' saves at step 5 (native engine) and keeps training, a fresh engine B
    (seed 1) loads the tag with ``verify=True`` and trains batches 6-10;
    (c) engine C over the 10 batches with async writers and rolling saves
    every 2 steps (keep 2, max 1 pending), then its tags and ``latest``
    after ``destroy()``, and a fresh engine resumed with ``tag=None``; (d)
    ``ds_to_universal`` of the step-5 tag into an engine with
    ``load_universal``; (e) ``zero_to_fp32``'s ``.pt`` against the step-5
    master; (f) K1's launches over B's steps. (b)-(d) hold their losses and
    masters within (a)'s difference, which is zero when (a) is bitwise.
    ``cfg``, ``config`` and ``device`` default to phase 5's."""
    import shutil
    import tempfile

    import torch
    from deepspeed_tpu_torch.checkpoint import ds_to_universal
    from deepspeed_tpu_torch.checkpoint.state import MODEL_FILE, OPTIM_FILE, read_latest_tag
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from deepspeed_tpu_torch.utils.zero_to_fp32 import convert_zero_checkpoint_to_fp32_state_dict

    t_phase = time.perf_counter()
    cfg = cfg or GPT2Config(dtype=torch.bfloat16)
    config = config or TRAIN_CONFIG
    dev = torch.device(device)
    rows = config["train_batch_size"]
    gas = rows // config["train_micro_batch_size_per_gpu"]
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (rows, cfg.n_positions))
                .astype(np.int32)} for _ in range(P19_STEPS)]
    tail = batches[P19_AT:]
    out = {"nvidia_smi": smi_line() if dev.type == "cuda" else "cpu"}

    def free(*engines):
        for e in engines:
            e.destroy()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="chip_smoke_p19_")
    try:
        space = shutil.disk_usage(root).free
        out["disk_free_bytes"] = space
        if space < P19_DISK_BYTES:
            raise RuntimeError(f"phase 19 holds up to {P19_DISK_BYTES} bytes on disk and "
                               f"{root} has {space} free")
        # (a) the control: two uninterrupted runs, A' saving at step 5
        a = p19_engine(cfg, dev, 0, config)
        loss_a, _ = p19_train(a, batches, dev)
        master_a = p19_master(a)
        free(a)
        del a
        a1 = p19_engine(cfg, dev, 0, config)
        first, ms_1 = p19_train(a1, batches[:P19_AT], dev)
        tags = os.path.join(root, "tags")
        a1.save_checkpoint(tags)
        st = a1.ckpt_stats
        out["native_save_ms"] = {"snapshot": st.snapshot_ms, "write": st.write_ms,
                                 "commit": st.commit_ms}
        master_5 = p19_master(a1)
        out["drain_ms"] = p19_drains(a1, dev)
        second, ms_2 = p19_train(a1, tail, dev)
        out["step_ms_without_rolling"] = (ms_1 + ms_2) / 2
        loss_a1 = np.concatenate([first, second])
        ctrl = p19_diff(loss_a1, loss_a, p19_master(a1), master_a)
        out["control"] = {"losses_bitwise": loss_a1.tobytes() == loss_a.tobytes(),
                          "loss_diff": ctrl[0], "master_diff": ctrl[1],
                          "bitwise": ctrl == (0.0, 0.0)}
        print("phase 19 (a) control " + json.dumps(out["control"]), flush=True)
        free(a1)
        del a1
        tag_dir = os.path.join(tags, "global_step5")
        out["tag_bytes"] = {f: os.path.getsize(os.path.join(tag_dir, f))
                            for f in (MODEL_FILE, OPTIM_FILE)}
        out["master_values"] = sum(t.numel() for t in master_5.values())

        # (b) resume in a fresh engine; (f) K1 over its steps
        b = p19_engine(cfg, dev, 1, config)
        b.load_checkpoint(tags, tag="global_step5", verify=True)
        st = b.ckpt_stats
        out["load_ms"] = {"read": st.load_read_ms, "verify": st.load_verify_ms,
                          "h2d": st.load_h2d_ms}
        p19_counters("(b)", b, P19_AT, rows, gas)
        p19_sync(dev)
        reset_launches()
        loss_b, _ = p19_train(b, tail, dev)
        launches = {k: LAUNCHES[k] for k in K1_NAMES}
        p19_gate("(b) resume", p19_diff(loss_b, loss_a[P19_AT:], p19_master(b), master_a),
                 ctrl)
        want = gas * cfg.n_layer * (P19_STEPS - P19_AT)   # one of each a layer and micro-batch
        out["k1_launches"] = launches
        if any(v != want for v in launches.values()):
            raise AssertionError(f"phase 19 (f): K1 launches {launches}, expected {want} each")
        free(b)
        del b

        # (d) universal
        uni = os.path.join(root, "universal")
        t0 = time.perf_counter()
        ds_to_universal(tags, uni, tag="global_step5")
        out["to_universal_ms"] = (time.perf_counter() - t0) * 1e3
        d = p19_engine(cfg, dev, 1, dict(config, checkpoint={"load_universal": True}))
        d.load_checkpoint(uni)
        p19_counters("(d)", d, P19_AT, rows, gas)
        loss_d, _ = p19_train(d, tail, dev)
        p19_gate("(d) universal", p19_diff(loss_d, loss_a[P19_AT:], p19_master(d), master_a),
                 ctrl)
        free(d)
        del d

        # (e) zero_to_fp32
        pt = convert_zero_checkpoint_to_fp32_state_dict(tags, os.path.join(root, "fp32.pt"),
                                                        tag="global_step5")
        sd = torch.load(pt)
        if sorted(sd) != sorted(k.replace("/", ".") for k in master_5) or not all(
                torch.equal(sd[k.replace("/", ".")], t.cpu()) for k, t in master_5.items()):
            raise AssertionError("phase 19 (e): zero_to_fp32's .pt differs from the "
                                 "step-5 master")
        print(f"phase 19 (e) zero_to_fp32: {len(sd)} tensors equal the step-5 master",
              flush=True)
        del sd, master_5
        for path in (tags, uni, pt):
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)

        # (c) async writers and rolling saves
        rolling_dir = os.path.join(root, "rolling")
        c_config = dict(config, checkpoint={
            **P19_ROLLING, "rolling": dict(P19_ROLLING["rolling"], save_dir=rolling_dir)})
        c = p19_engine(cfg, dev, 0, c_config)
        loss_c, out["step_ms_with_rolling"] = p19_train(c, batches, dev)
        master_c = p19_master(c)
        c.destroy()
        st = c.ckpt_stats
        n = max(1, st.saves)
        out["rolling_per_save_ms"] = {
            "saves": st.saves, "snapshot": st.snapshot_ms / n, "write_submit": st.write_ms / n,
            "backpressure": st.backpressure_ms / n, "commit": st.commit_ms / n,
            "pruned": st.pruned}
        free(c)
        del c
        p19_gate("(c) rolling", p19_diff(loss_c, loss_a, master_c, master_a), ctrl)
        del master_c
        kept = sorted(t for t in os.listdir(rolling_dir)
                      if os.path.isdir(os.path.join(rolling_dir, t)))
        latest = read_latest_tag(rolling_dir)
        if kept != ["rolling_step10", "rolling_step8"] or latest != "rolling_step10":
            raise AssertionError(f"phase 19 (c): tags {kept}, latest {latest}")
        e = p19_engine(cfg, dev, 1, dict(config, checkpoint={"engine": "async"}))
        e.load_checkpoint(rolling_dir, tag=None, verify=True)
        p19_counters("(c) resume", e, P19_STEPS, rows, gas)
        p19_gate("(c) resumed master", p19_diff(None, None, p19_master(e), master_a), ctrl)
        # an async user save of the same state, timed like the native one
        e.save_checkpoint(os.path.join(root, "async"))
        st = e.ckpt_stats
        out["async_save_ms"] = {"snapshot": st.snapshot_ms, "write_submit": st.write_ms,
                                "commit": st.commit_ms}
        free(e)
        del e
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print("checkpoint " + json.dumps(out), flush=True)
    print(f"phase 19: {out['seconds']:.1f} s", flush=True)


# --------------------------------------------------------------------------- #
# phase 20: one-device training of Llama-2-7B's width
# --------------------------------------------------------------------------- #

P20_LAYERS = 8            # of Llama-2-7B's 32: 1.88 B parameters
P20_T = 4096
P20_SEQS = 16             # indexed-dataset rows: four global batches an epoch
P20_GATE_STEPS = 4        # the byte gates' steps
P20_TIMED_STEPS = 2       # further main-path steps, timed warm
P20_ZIPF = 1.1            # token ranks drawn ~ rank^-1.1, as text's are
P20_LOSS_TAIL = 2         # the main path's last steps whose mean must be below the first
P20_LOSS_PEAK = 1.5       # no step's loss past this multiple of the first
P20_CONFIG = {
    "train_batch_size": 4, "train_micro_batch_size_per_gpu": 1,
    "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 0,
    "optimizer": {"type": "Lamb", "params": {"lr": 2e-3, "betas": [0.9, 0.95], "eps": 1e-8,
                                             "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0, "warmup_max_lr": 2e-3,
                                                 "warmup_num_steps": 2}},
    "train_pipeline": {"prefetch": 2},
}
# (c) and (d): GPT-2 small cut to 2 layers (GPT2Config keyword arguments)
P20_SMALL = {"n_layer": 2}
P20_SMALL_CONFIG = {
    "train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
    "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 0,
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0, "warmup_max_lr": 1e-3,
                                                 "warmup_num_steps": 3}},
    "train_pipeline": {"prefetch": 0},
}
P20_OPTIMIZERS = {
    "Lamb": {"lr": 1e-3, "weight_decay": 0.01, "max_grad_norm": 1.0},
    "Lion": {"lr": 1e-4, "betas": [0.9, 0.99], "weight_decay": 0.1},
    "Adagrad": {"lr": 1e-2},
    "SGD": {"lr": 1e-2, "momentum": 0.9},
}
P20_CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 256,
                  "max_difficulty": 1024, "schedule_type": "fixed_linear",
                  "schedule_config": {"total_curriculum_step": 3, "difficulty_step": 256}}


class TokenRows:
    """An ``MMapIndexedDataset`` as training rows: ``{"input_ids": row}``."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return {"input_ids": self.ds[i]}


def p20_dataset(root: str, vocab: int, rows: int, T: int, seed: int = 0):
    """``rows`` sequences of ``T`` seeded Zipf-ranked token ids written with
    the port's indexed-dataset builder under ``root``, read back mmap."""
    from deepspeed_tpu_torch.data import make_builder, make_dataset
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** P20_ZIPF
    ids = rng.choice(vocab, size=(rows, T), p=p / p.sum()).astype(np.int32)
    prefix = os.path.join(root, "tokens")
    b = make_builder(prefix, dtype=np.int32)
    for row in ids:
        b.add_item(row)
        b.end_document()
    b.finalize()
    return make_dataset(prefix)


@contextlib.contextmanager
def plain_llama_attention():
    """Route the Llama training forward's attention to the dense reference
    (GQA heads repeated), the yardstick's path; restored on exit."""
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.attention import reference_attention
    kernel_path = llama.dot_product_attention

    def dense(q, k, v, causal=False):
        n_rep = q.shape[2] // k.shape[2]
        return reference_attention(q, k.repeat_interleave(n_rep, 2),
                                   v.repeat_interleave(n_rep, 2), causal=causal)

    llama.dot_product_attention = dense
    try:
        yield
    finally:
        llama.dot_product_attention = kernel_path


def p20_first_step(engine, cfg, micro, dev) -> dict:
    """Phase 5's rule at Llama width: the engine's first micro-batch loss
    and gradient (bf16, K1) against an fp32 forward/backward with plain
    attention (TF32 off), beside a bf16 one with plain attention; fails
    unless the engine's error is within 2x the bf16 one's plus
    FIRST_STEP_FLOOR of the yardstick's scale. The gradients are compared
    leaf by leaf (sums in f64), one reference model at a time."""
    import dataclasses

    import torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    one = torch.ones((), dtype=torch.float32, device=dev)
    loss_e, grads_e = engine._grad_fn(micro, one)
    names = list(engine.state["master"])
    grads_e = dict(zip(names, grads_e))
    loss_e = float(loss_e)
    g32, sums, losses = None, {}, {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model = LlamaForCausalLM(dataclasses.replace(cfg, dtype=dt), device=dev)
        model.load_flat(engine.state["master"])
        params = model.named_flat_parameters()
        for p in params.values():
            p.requires_grad_(True)
        with plain_llama_attention():
            loss = model(micro)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses[name] = float(loss.detach())
        del model, params, loss
        if g32 is None:
            g32 = {n: g.float() for n, g in grads.items()}
            sums["ref"] = sum(float(g.double().pow(2).sum()) for g in g32.values())
            sums["engine"] = sum(float((grads_e[n].double() - g32[n].double()).pow(2).sum())
                                 for n in names)
        else:
            sums["bf16"] = sum(float((grads[n].double() - g32[n].double()).pow(2).sum())
                               for n in names)
        del grads
    count = sum(g.numel() for g in g32.values())
    del g32, grads_e
    rms = lambda s: (s / count) ** 0.5
    return first_step_verdict("phase 20 first-step", losses["fp32"], loss_e, losses["bf16"],
                              rms(sums["ref"]), rms(sums["engine"]), rms(sums["bf16"]))


def p20_master(engine, host: bool) -> dict:
    """The fp32 master, cloned on the device or copied to the host."""
    return {n: (t.detach().to("cpu", copy=True) if host else t.detach().clone())
            for n, t in engine.state["master"].items()}


def p20_same_master(label: str, got: dict, want: dict) -> None:
    bad = [n for n, t in want.items()
           if not torch_equal_bits(got[n], t.to(got[n].device))]
    if bad:
        raise AssertionError(f"phase 20 {label}: masters differ in {bad[:4]}")


def torch_equal_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(_bits(a), _bits(b)))


def p20_gate(label: str, got, want) -> None:
    """Two loss streams, bit for bit."""
    same = np.asarray(got, np.float32).tobytes() == np.asarray(want, np.float32).tobytes()
    print(f"phase 20 {label}: losses {list(map(float, got))} vs {list(map(float, want))}, "
          f"bitwise {same}", flush=True)
    if not same:
        raise AssertionError(f"phase 20 {label}: loss streams differ")


def p20_k1_shape(dev, out: dict) -> dict:
    """K1's three kernels at the Llama main path's shape (B 1, T 4096, 32
    heads, D 128, causal) against their plain versions (the backward fed
    the kernel forward's o and lse; each backward rerun bitwise), timed
    beside SDPA's flash backend (forward; backward alone on a retained
    graph), with the bound of each."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from deepspeed_tpu_torch.ops.kernels import (
        flash_attention_fwd, flash_attention_fwd_plain, flash_bwd_dkv, flash_bwd_dkv_plain,
        flash_bwd_dq, flash_bwd_dq_plain, flash_delta)
    g = torch.Generator(device=dev).manual_seed(20)
    B, T, H, D = 1, P20_T, 32, 128
    randn = lambda: torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
    q, k, v, do = randn(), randn(), randn(), randn()
    scale = D ** -0.5
    o, lse = flash_attention_fwd(q, k, v, True, scale)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, True, scale)
    delta = flash_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
    dq_ref = flash_bwd_dq_plain(q, k, v, do, lse, delta, True, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
    dk_ref, dv_ref = flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, scale)
    same = (torch_equal_bits(dq, flash_bwd_dq(q, k, v, do, lse, delta, True, scale))
            and all(torch_equal_bits(a, b) for a, b in
                    zip((dk, dv), flash_bwd_dkv(q, k, v, do, lse, delta, True, scale))))
    if not same:
        raise AssertionError("phase 20: K1's backward is not bitwise at D 128, T 4096")
    errs = {"flash_fwd": err((o, o_ref), (lse[..., None], lse_ref[..., None])),
            "flash_bwd_dq": err((dq, dq_ref)), "flash_bwd_dkv": err((dk, dk_ref), (dv, dv_ref))}
    pairs = B * H * T * (T + 1) // 2
    x = B * T * H * D * 2
    stats = B * H * T * 4
    bounds = {"flash_fwd": bound(4 * x + stats, 4 * D * pairs),
              "flash_bwd_dq": bound(5 * x + 2 * stats, 6 * D * pairs),
              "flash_bwd_dkv": bound(6 * x + 2 * stats, 8 * D * pairs)}
    qs, ks, vs, dos = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    qg, kg, vg = (t.clone().requires_grad_() for t in (qs, ks, vs))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_f = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
        res = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_b = time_ms(lambda: torch.autograd.grad(res, (qg, kg, vg), dos, retain_graph=True))
    del res, qg, kg, vg
    timed = {
        "flash_fwd": (lambda: flash_attention_fwd(q, k, v, True, scale),
                      lambda: flash_attention_fwd_plain(q, k, v, True, scale), lib_f),
        "flash_bwd_dq": (lambda: flash_bwd_dq(q, k, v, do, lse, delta, True, scale),
                         lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta, True, scale), lib_b),
        "flash_bwd_dkv": (lambda: flash_bwd_dkv(q, k, v, do, lse, delta, True, scale),
                          lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, scale),
                          lib_b)}
    rows = {}
    for name, (fn, plain, lib) in timed.items():
        e = errs[name]
        if not e["ok"]:
            raise AssertionError(f"phase 20: {name} at D 128, T 4096: error {e['max_abs_err']}")
        b_ms, b_by = bounds[name]
        rows[name] = {"max_abs_err": e["max_abs_err"], "ms": time_ms(fn),
                      "plain_ms": time_ms(plain, 3, 1), "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib,
                      "library_covers": "SDPA flash forward" if name == "flash_fwd"
                      else "SDPA flash backward alone: dq, dk and dv together"}
    out["k1_d128"] = rows
    print("phase 20 k1-d128 " + json.dumps({"shape": "B 1, T 4096, H 32, D 128, causal",
                                            "kernels": rows}), flush=True)
    return rows


def p20_remat_gates(dev, micro, batch) -> dict:
    """(b) at 2 layers of Llama-2-7B's width: remat off, remat with policy
    ``none`` and with ``attn_out_saveable`` give the same first micro-batch
    loss and gradients and the same step, bit for bit; K1's forward
    launches a step: 8 off, 16 under full recompute, 8 under
    ``attn_out_saveable``."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    cases = {"off": (False, None), "none": (True, None),
             "attn_out_saveable": (True, "attn_out_saveable")}
    config = dict(P20_CONFIG, train_pipeline={"prefetch": 0})
    one = torch.ones((), dtype=torch.float32, device=dev)
    ref, out = None, {}
    for label, (remat, policy) in cases.items():
        cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype=torch.bfloat16, remat=remat,
                                    remat_policy=policy)
        model = LlamaForCausalLM(cfg, device=dev, seed=0)
        engine = deepspeed_tpu_torch.initialize(model=model, config=config, device=dev)[0]
        loss, grads = engine._grad_fn(micro, one)
        p19_sync(dev)
        reset_launches()
        step_loss = engine.train_batch(batch)
        p19_sync(dev)
        fwd = {k: LAUNCHES.get(k, 0) for k in K1_NAMES}
        master = p20_master(engine, host=False)
        engine.destroy()
        del engine, model
        got = (loss, grads, step_loss.detach(), master)
        if ref is None:
            ref = got
        else:
            same = (torch_equal_bits(got[0], ref[0])
                    and all(torch_equal_bits(a, b) for a, b in zip(got[1], ref[1]))
                    and torch_equal_bits(got[2], ref[2]))
            if not same:
                raise AssertionError(f"phase 20 (b): remat {label} differs from remat off")
            p20_same_master(f"(b) remat {label}", got[3], ref[3])
        out[label] = fwd
        del got, grads, master
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print("phase 20 (b) remat " + json.dumps({"k1_launches_a_step": out,
                                             "bitwise_to_off": True}), flush=True)
    want = {"off": 8, "none": 16, "attn_out_saveable": 8}
    if dev.type == "cuda" and any(out[k]["flash_fwd"] != n for k, n in want.items()):
        raise AssertionError(f"phase 20 (b): K1 forward launches {out}, expected {want}")
    return out


def p20_small_engine(dev, seed: int, config: dict, training_data=None):
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    model = GPT2LMHead(GPT2Config(**P20_SMALL, dtype=torch.bfloat16), device=dev, seed=seed)
    return deepspeed_tpu_torch.initialize(model=model, config=config, device=dev,
                                          training_data=training_data)[0]


def p20_optimizer_resume(dev, root: str) -> dict:
    """(c) each of LAMB, Lion, Adagrad and SGD with momentum on GPT-2 small
    at 2 layers: 3 steps, ``save_checkpoint``, 3 more; a fresh engine from
    another seed loads the tag (verified) and runs the same 3 steps: its
    losses, masters and optimizer states bit-equal."""
    import torch
    from deepspeed_tpu_torch.checkpoint.state import flatten_tree
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    small = GPT2Config(**P20_SMALL)
    rng = np.random.default_rng(20)
    batches = [{"input_ids": rng.integers(0, small.vocab_size, (4, small.n_positions))
                .astype(np.int32)} for _ in range(6)]
    out = {}
    for opt, params in P20_OPTIMIZERS.items():
        config = dict(P20_SMALL_CONFIG, optimizer={"type": opt, "params": params})
        path = os.path.join(root, f"resume_{opt}")
        leaves = lambda e: {k: v.detach().clone() for k, v in flatten_tree(
            {"master": e.state["master"], "opt": e.state["opt"], "step": e.state["step"]}).items()}
        a = p20_small_engine(dev, 0, config)
        a.train_steps(3, data_iter=iter(batches[:3]))
        a.save_checkpoint(path)
        tail = a.train_steps(3, data_iter=iter(batches[3:]))
        want = leaves(a)
        a.destroy()
        b = p20_small_engine(dev, 1, config)
        b.load_checkpoint(path, verify=True)
        got_tail = b.train_steps(3, data_iter=iter(batches[3:]))
        got = leaves(b)
        b.destroy()
        slots = sorted({k.split("/")[1] for k in want if k.startswith("opt/")})
        bad = [k for k in want if k not in got or not torch_equal_bits(got[k], want[k])]
        out[opt] = {"losses_bitwise": got_tail.tobytes() == tail.tobytes(),
                    "leaves": len(want), "optimizer_slots": slots, "differing": bad[:4]}
        if bad or not out[opt]["losses_bitwise"] or not slots:
            raise AssertionError(f"phase 20 (c) {opt}: resume differs: {out[opt]}")
        del a, b, want, got
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print("phase 20 (c) optimizer resume " + json.dumps(out), flush=True)
    return out


def p20_pld_curriculum(dev) -> dict:
    """(d) on GPT-2 small at 2 layers over a 1024-token dataset through the
    engine's loader: PLD at theta 1 bit-equal to PLD off; PLD (theta 0.5,
    gamma 2) bit-equal at prefetch 0 and 2; a curriculum seqlen schedule
    256 -> 1024 staging each width it reaches and running K1 at it."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES
    small = GPT2Config(**P20_SMALL)
    rng = np.random.default_rng(21)
    data = [{"input_ids": rng.integers(0, small.vocab_size, small.n_positions).astype(np.int32)}
            for _ in range(16)]

    def run(prefetch, extra, steps=4, spy=None):
        config = dict(P20_SMALL_CONFIG, train_pipeline={"prefetch": prefetch},
                      optimizer={"type": "AdamW", "params": {"lr": 1e-3}}, **extra)
        e = p20_small_engine(dev, 0, config, training_data=data)
        if spy is not None:
            spy(e)
        losses, launches = [], []
        for _ in range(steps):
            before = dict(LAUNCHES)
            losses.append(e.train_batch())
            launches.append({k: LAUNCHES.get(k, 0) - before.get(k, 0) for k in K1_NAMES})
        e.drain_metrics()
        losses = np.array([float(x) for x in losses], np.float32)
        difficulty = e.curriculum_scheduler.current_difficulty \
            if e.curriculum_scheduler is not None else None
        e.destroy()
        return losses, launches, difficulty

    out = {}
    off = run(2, {})[0]
    one = run(2, {"progressive_layer_drop": {"enabled": True, "theta": 1.0}})[0]
    p20_gate("(d) PLD theta 1 vs off", one, off)
    pld = {"progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 2.0}}
    p0, p2 = run(0, pld)[0], run(2, pld)[0]
    p20_gate("(d) PLD prefetch 0 vs 2", p0, p2)
    out["pld_losses"] = [float(x) for x in p2]
    widths = {}

    def spy(engine):
        orig = engine._prepare_batch

        def prepare(batch, step):
            staged = orig(batch, step)
            widths[step] = int(staged.tree["input_ids"].shape[1])
            return staged
        engine._prepare_batch = prepare

    losses, launches, difficulty = run(2, {"curriculum_learning": P20_CURRICULUM}, spy=spy)
    seen = [widths[s] for s in range(4)]
    out["curriculum"] = {"widths": seen, "k1_launches_a_step": launches,
                         "difficulty": difficulty, "losses": [float(x) for x in losses]}
    print("phase 20 (d) " + json.dumps(out), flush=True)
    if seen != [256, 512, 768, 1024] or difficulty != 1024:
        raise AssertionError(f"phase 20 (d): curriculum widths {seen}, difficulty {difficulty}")
    if dev.type == "cuda" and not all(s["flash_fwd"] > 0 for s in launches):
        raise AssertionError(f"phase 20 (d): a curriculum step ran no K1: {launches}")
    return out


def run_llama_training(layers: int = P20_LAYERS, T: int = P20_T, device="cuda", cfg=None):
    """Phase 20: one-device training at Llama-2-7B's full width (vocab
    32000, hidden 4096, FFN 11008, 32/32 heads, D 128, rope theta 1e4), cut
    to ``layers`` of its 32, at T ``T``: bf16 with an fp32 master,
    FusedLamb and WarmupLR, micro-batch 1 x gas 4, remat on (policy
    ``none``, a chunk a layer), ``training_data`` an ``MMapIndexedDataset``
    of seeded Zipf-ranked tokens written here, through the engine's loader
    at ``train_pipeline.prefetch`` 2.

    (a) K1 at this shape against its plain version and SDPA; the first
    step held to fp32; the main path's steps (losses finite and falling, K1
    launches a step), step ms, tokens/s, peak GiB, host enqueue against
    wall, a profiled step. (b) byte gates: prefetch 0 and the
    forward/backward/step facade against the main path's first 4 steps
    (losses and masters); remat on and off at 2 layers. (c) optimizer
    resume. (d) PLD and the curriculum."""
    import shutil
    import tempfile

    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    out = {"nvidia_smi": smi_line() if cuda else "cpu"}
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=layers, dtype=torch.bfloat16,
                                       remat=True)
    if cuda:
        p20_k1_shape(dev, out)
        torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_p20_")
    try:
        ds = p20_dataset(root, cfg.vocab_size, P20_SEQS, T)
        rows = TokenRows(ds)
        gas = P20_CONFIG["train_batch_size"] // P20_CONFIG["train_micro_batch_size_per_gpu"]
        tokens_a_step = P20_CONFIG["train_batch_size"] * T

        def build(prefetch):
            model = LlamaForCausalLM(cfg, device=dev, seed=0)
            config = dict(P20_CONFIG, train_pipeline={"prefetch": prefetch})
            return deepspeed_tpu_torch.initialize(model=model, training_data=rows,
                                                  config=config, device=dev)

        t0 = time.perf_counter()
        engine, _, loader, _ = build(2)
        p19_sync(dev)
        n_params = sum(t.numel() for t in engine.state["master"].values())
        out["model"] = {"layers": cfg.num_hidden_layers, "T": T, "params": n_params,
                        "init_s": time.perf_counter() - t0}
        print(f"phase 20 model: Llama-2-7B width (vocab {cfg.vocab_size}, hidden "
              f"{cfg.hidden_size}, FFN {cfg.intermediate_size}, {cfg.num_attention_heads}/"
              f"{cfg.num_key_value_heads} heads, D {cfg.head_dim}), {cfg.num_hidden_layers} "
              f"layers, T {T}, {n_params} params, bf16 with fp32 master, FusedLamb, "
              f"remat {cfg.remat}", flush=True)
        first = next(iter(loader))
        micro = {k: torch.from_numpy(v[:1]).to(dev) for k, v in first.items()}
        out["first_step"] = p20_first_step(engine, cfg, micro, dev)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        # ---- (a) the main path: steps from the engine's own pipeline ---- #
        p19_sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        gate_losses = engine.train_steps(P20_GATE_STEPS)
        p19_sync(dev)
        t1 = time.perf_counter()
        master_4 = p20_master(engine, host=cuda)
        p19_sync(dev)
        t2 = time.perf_counter()
        warm_losses = engine.train_steps(P20_TIMED_STEPS)
        p19_sync(dev)
        t3 = time.perf_counter()
        launches = {k: LAUNCHES.get(k, 0) for k in K1_NAMES}
        steps = P20_GATE_STEPS + P20_TIMED_STEPS
        losses = np.concatenate([gate_losses, warm_losses])
        warm_ms = (t3 - t2) * 1e3 / P20_TIMED_STEPS
        stats = engine.train_stats
        out["main"] = {
            "steps": steps, "losses": [float(x) for x in losses],
            "first_steps_ms": (t1 - t0) * 1e3 / P20_GATE_STEPS, "step_ms": warm_ms,
            "tokens_per_s": tokens_a_step / warm_ms * 1e3,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
            "k1_launches": launches,
            "k1_launches_a_step": {k: v / steps for k, v in launches.items()},
            "prefetched_steps": stats.prefetched_steps,
            "enqueue_wait_ms_a_step": stats.enqueue_wait_ms / max(1, stats.steps)}
        if not np.isfinite(losses).all():
            raise AssertionError(f"phase 20: non-finite loss {losses}")
        # falling, not diverging: the last steps' mean below the first loss
        # and no step past P20_LOSS_PEAK times it
        if not (losses[-P20_LOSS_TAIL:].mean() < losses[0]
                and losses.max() <= P20_LOSS_PEAK * losses[0]):
            raise AssertionError(f"phase 20: loss did not fall: {losses}")
        want = {"flash_fwd": 2 * cfg.num_hidden_layers * gas * steps,
                "flash_bwd_dq": cfg.num_hidden_layers * gas * steps,
                "flash_bwd_dkv": cfg.num_hidden_layers * gas * steps}
        if cuda and launches != want:
            raise AssertionError(f"phase 20: K1 launches {launches}, expected {want}")
        # one step timed in two parts: until train_batch returns (the host's
        # enqueue) and until the device is done
        p19_sync(dev)
        t0 = time.perf_counter()
        engine.train_batch()
        t1 = time.perf_counter()
        p19_sync(dev)
        t2 = time.perf_counter()
        out["main"]["host_enqueue_ms"] = (t1 - t0) * 1e3
        out["main"]["wall_ms"] = (t2 - t0) * 1e3
        print("phase 20 train " + json.dumps(out["main"]), flush=True)
        if cuda:
            out["profile"] = device_breakdown(
                f"phase 20 llama train step ({P20_CONFIG['train_batch_size']} x {T} tokens, "
                f"{gas} micro-batches, remat)", lambda: engine.train_batch())
        engine.destroy()
        del engine, loader
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # ---- (b) prefetch 0 and the facade against the main path's steps ---- #
        engine = build(0)[0]
        p20_gate("(b) prefetch 0 vs 2", engine.train_steps(P20_GATE_STEPS), gate_losses)
        p20_same_master("(b) prefetch 0 vs 2", p20_master(engine, host=False), master_4)
        engine.destroy()
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        engine = build(0)[0]
        it = iter(RepeatingLoader(engine.training_dataloader))
        facade = []
        for _ in range(P20_GATE_STEPS):
            batch = next(it)
            micro_losses = []
            for g in range(gas):
                loss = engine({k: v[g:g + 1] for k, v in batch.items()})
                engine.backward(loss)
                engine.step()
                micro_losses.append(loss.detach())
            facade.append(torch.stack(micro_losses).mean())
        p20_gate("(b) facade vs train_batch",
                 np.array([float(x) for x in facade], np.float32), gate_losses)
        p20_same_master("(b) facade vs train_batch", p20_master(engine, host=False), master_4)
        engine.destroy()
        del engine, master_4
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        batch = {k: v for k, v in first.items()}
        out["remat"] = p20_remat_gates(dev, micro, batch)

        # ---- (c) and (d) ---- #
        out["resume"] = p20_optimizer_resume(dev, root)
        out["pld_curriculum"] = p20_pld_curriculum(dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print("phase 20 " + json.dumps({k: out[k] for k in ("nvidia_smi", "model", "seconds")}),
          flush=True)
    print(f"phase 20: {out['seconds']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------- #
# phases 21-22: the serving frontend and the multi-replica router
# --------------------------------------------------------------------------- #

# 48 pages of 128 (6144 tokens, 3 GiB at 512 KiB a token): less than the
# traffic asks for at once, so offload preemption has to fire
# phase 21's depth: 8 of Llama-2-7B's 32 layers at full width (cut for
# phase 26: with 21 at 32 layers the whole script read 1000.0 s)
P21_LAYERS = 8
P21_ENGINE = {"kv_cache": {"block_size": 128, "num_blocks": 48},
              "prefix_cache": {"enabled": True}, "seed": 0,
              "serving": {"decode_slice": 4, "preemption": "offload"}}
P21_RATE, P21_N, P21_SEED = 8.0, 32, 0
P21_MIX = (("interactive", 3.0, (256, 384, 512, 640, 768, 896, 1024), (64, 96, 128)),
           ("batch", 1.0, (1536, 2048, 2560, 3072), (32, 48, 64)))
P21_PREFIX, P21_SHARED, P21_SHARED_TAIL = 1024, 8, 128
# part B's prompt lengths: a low-priority victim of 40 of the 48 pages, the
# interactive request it makes room for, the cancelled and shed requests
# (the prefill one longer than a pass's chunk budget) and the sync-checked
# slice's two rows
P21_B_LENS = {"victim": 5000, "interactive": 1024, "queued": 512, "prefill": 2000,
              "decode": 512, "shed": 512, "slice": 256}
P21_B_NEW = 32            # new tokens of the victim and the interactive request
P21_DRAIN_S = 600.0
P21_NAMES = ("flash_packed", "paged_chunk", "paged_decode", "paged_splitk", "splitk_merge")
P21_TIE_ROWS = 3          # prompts whose last row sets the near-tie limit
# 80 pages of 128 a replica: (b)'s prefill replica takes its 8 prompts
# (1152 tokens, 9 pages each) in one batch, and its worker admits a batch
# prompt by prompt (ROADMAP Queue 3 item 3). Phase 22 holds routing,
# handoffs and failover, not SLOs (phase 21 does): at a shed factor of
# 1000 its default classes shed nothing, in the frontends or the router
P22_SHED_FACTOR = 1000.0
P22_LAYERS = 8            # of the 32 (phase 24 took the time)
P22_ENGINE = {"kv_cache": {"block_size": 128, "num_blocks": 80},
              "prefix_cache": {"enabled": True}, "seed": 0,
              "serving": {"decode_slice": 4, "shed_factor": P22_SHED_FACTOR}}
P22_PREFIX, P22_TAIL, P22_NEW = 1024, 128, 32
P22_GROUP, P22_DISAGG, P22_FAILOVER = 8, 8, 8
# balance 32: 1024 cached tokens outweigh the 7 later requests of a group
P22_ROUTER = {"policy": "cache_aware", "shed_factor": P22_SHED_FACTOR}
# (c) rejoins r1 by hand once the traffic has drained, so that the launch
# counts read before it hold no launch of the rejoin's warmup
P22_HEALTH = {"enabled": True, "interval_s": 0.05, "suspect_after_s": 5.0,
              "down_after_s": 10.0, "fence_join_s": 5.0, "auto_rejoin": False}


def p21_sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def p21_arrivals(V):
    """Phase 21's traffic: ``PoissonLoadGen`` at seed 0, 32 arrivals at 8
    requests/s of the two classes; the first eight interactive arrivals'
    prompts become one shared 1024-token prefix followed by the first 128
    tokens of their own."""
    from deepspeed_tpu_torch.inference.v2.serving import PoissonLoadGen, WorkloadComponent
    mix = [WorkloadComponent(c, w, list(p), list(g)) for c, w, p, g in P21_MIX]
    arrivals = PoissonLoadGen(P21_RATE, mix, vocab=V, seed=P21_SEED).arrivals(n=P21_N)
    prefix = np.random.RandomState(21).randint(0, V, P21_PREFIX).astype(np.int32)
    shared = [a for a in arrivals if a.cls == "interactive"][:P21_SHARED]
    for a in shared:
        a.prompt = np.concatenate([prefix, a.prompt[:P21_SHARED_TAIL]])
    return arrivals


class OffloadAudit:
    """Holds every offload of a frontend's ``KVOffloadManager`` to its
    restore: before the offload, the victim's private pages (``fetch_pages``
    on the card) and its last-logits row; after the restore, the same pages
    read back and the row, each bit for bit. An offloaded page held by
    anyone else (refcount > 1, or a radix-tree page) fails at once. Times
    each offload and restore between two syncs."""

    def __init__(self, fe, dev):
        self.engine, self.dev = fe.engine, dev
        self.pending, self.checked = {}, []
        self.offload_ms, self.restore_ms, self.bytes = [], [], 0
        mgr = fe.offload
        self._offload, self._restore = mgr.offload, mgr.restore
        mgr.offload, mgr.restore = self.offload, self.restore

    def offload(self, uid, kept, tail):
        e = self.engine
        cached = ({n.block_id for n in e.prefix_cache._iter_nodes()}
                  if e.prefix_cache is not None else set())
        bad = [b for b in tail if e.allocator.ref_count(b) != 1 or b in cached]
        if bad:
            raise AssertionError(f"phase 21: uid {uid} offloads shared pages {bad}")
        e._materialize([uid])
        self.pending[uid] = (e.fetch_pages(tail) if tail else None,
                             np.array(e._last_logits[uid], np.float32), kept)
        p21_sync(self.dev)
        t0 = time.perf_counter()
        n = self._offload(uid, kept, tail)
        p21_sync(self.dev)
        self.offload_ms.append((time.perf_counter() - t0) * 1e3)
        self.bytes += n
        return n

    def restore(self, uid):
        e = self.engine
        p21_sync(self.dev)
        t0 = time.perf_counter()
        n = self._restore(uid)
        p21_sync(self.dev)
        self.restore_ms.append((time.perf_counter() - t0) * 1e3)
        pages, logits, kept = self.pending.pop(uid)
        blocks = e.scheduler.seqs[uid].blocks[kept:]
        got = e.fetch_pages(blocks) if blocks else None
        same = (got is None and pages is None) or (
            got is not None and pages is not None and got.shape == pages.shape
            and np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                               np.ascontiguousarray(pages).view(np.uint8)))
        row = np.asarray(e._last_logits[uid], np.float32)
        if not same or not np.array_equal(row.view(np.uint32), logits.view(np.uint32)):
            raise AssertionError(f"phase 21: uid {uid} restored pages equal {same}, "
                                 "last-logits row bit-equal "
                                 f"{np.array_equal(row.view(np.uint32), logits.view(np.uint32))}")
        self.checked.append(uid)
        return n


def p21_tie(model, prompts):
    """The near-tie limit, as phase 17 sets it: twice the dense bf16
    forward's largest logit error against fp32, here at the last row of
    the first ``P21_TIE_ROWS`` prompts."""
    errs = []
    for p in prompts[:P21_TIE_ROWS]:
        a, b = dense_rows(None, model, p, [len(p) - 1], False)
        errs.append(float((b - a).abs().max()))
        del a, b
    return 2 * max(errs)


def p21_reference(label, engine, model, handles, tie):
    """Every finished stream against its prompt served alone by
    ``engine.generate()``: equal, or parting only at a near tie
    (:func:`stream_tie`). Returns the counts of equal and parted streams."""
    done = [h for h in handles if h.status == "finished"]
    refs = []
    for h in done:
        out = engine.generate([h.prompt], max_new_tokens=len(h.tokens))[0]
        refs.append([int(t) for t in out[len(h.prompt):]])
    parted = []
    for h, r in zip(done, refs):
        if len(h.tokens) != len(r):
            raise AssertionError(f"{label}: uid {h.uid} streamed {len(h.tokens)} tokens, "
                                 f"the reference {len(r)}")
        if h.tokens != r:
            parted.append(h)
    if parted:
        stream_tie(label, model, [h.prompt for h in parted], [h.tokens for h in parted],
                   [refs[done.index(h)] for h in parted], tie)
    counts = {"streams": len(done), "equal": len(done) - len(parted), "parted": len(parted)}
    print("stream-compare " + json.dumps({"case": label, **counts, "limit": tie}), flush=True)
    return counts


def p21_percentiles(handles):
    """TTFT and TBT p50 / p99 (ms) of the finished handles of each class."""
    out = {}
    for cls in sorted({h.cls.name for h in handles}):
        fin = [h for h in handles if h.cls.name == cls and h.status == "finished"]
        ttft = [h.ttft_ms for h in fin if h.ttft_ms is not None]
        tbt = [x for h in fin for x in h.tbt_ms]
        q = lambda xs, p: float(np.percentile(xs, p)) if xs else None  # noqa: E731
        out[cls] = {"ttft_p50_ms": q(ttft, 50), "ttft_p99_ms": q(ttft, 99),
                    "tbt_p50_ms": q(tbt, 50), "tbt_p99_ms": q(tbt, 99)}
    return out


@contextlib.contextmanager
def p21_sync_checked(dev):
    """Within the block, ``torch.cuda.set_sync_debug_mode("error")``: any
    operation that waits on the device raises, but the decode pipeline's
    policed drain (``pipeline._RowDrain.wait``, the one event wait a step)
    runs with the mode off. Yields the count of drains seen."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import pipeline
    seen = {"drains": 0}
    if torch.device(dev).type != "cuda":
        yield seen
        return
    wait = pipeline._RowDrain.wait

    def policed(self, slot):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return wait(self, slot)
        finally:
            seen["drains"] += 1
            torch.cuda.set_sync_debug_mode("error")

    pipeline._RowDrain.wait = policed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield seen
    finally:
        torch.cuda.set_sync_debug_mode(0)
        pipeline._RowDrain.wait = wait


def p21_step_until(fe, cond, label, n=2000):
    for _ in range(n):
        if cond():
            return
        fe.step()
    if not cond():
        raise AssertionError(f"phase 21: {label} not reached in {n} steps")


def p21_part_b(engine, fe, rng, V, dev):
    """The frontend driven by ``step()``: a deterministic preemption (a
    5000-token batch request decoding when an interactive one arrives that
    the pool cannot fund beside it), then a request cancelled while queued,
    one during its prefill, one mid-decode, one shed (it waited past its
    class's TTFT SLO before an admission round), and one decode slice
    under the sync check. Returns its handles and what it measured."""
    prompt = lambda n: rng.randint(0, V, n).astype(np.int32)  # noqa: E731
    big = fe.submit(prompt(P21_B_LENS["victim"]), priority="batch", max_new_tokens=P21_B_NEW)
    p21_step_until(fe, lambda: len(big.tokens) > 0, "the batch request's first token")
    hi = fe.submit(prompt(P21_B_LENS["interactive"]), priority="interactive",
                   max_new_tokens=P21_B_NEW)
    p21_step_until(fe, lambda: big.status == "preempted", "the preemption", n=50)
    p21_step_until(fe, lambda: big.finished and hi.finished, "the preempted request's finish")
    out = {"preempted": big.preemptions}
    # cancelled while queued
    q = fe.submit(prompt(P21_B_LENS["queued"]), priority="standard", max_new_tokens=16)
    q.cancel()
    fe.step()
    # cancelled during its prefill: after the first of its passes
    pre = fe.submit(prompt(P21_B_LENS["prefill"]), priority="standard", max_new_tokens=16)
    orig, passes = engine._run_pass, []

    def cancelling():
        orig()
        if not passes:
            pre.cancel()
        passes.append(1)

    engine._run_pass = cancelling
    try:
        fe.step()
    finally:
        del engine._run_pass
    # cancelled mid-decode
    mid = fe.submit(prompt(P21_B_LENS["decode"]), priority="standard", max_new_tokens=64)
    p21_step_until(fe, lambda: len(mid.tokens) > 0, "the mid-decode request's first token")
    mid.cancel()
    fe.step()
    # shed: it waited past the interactive class's 500 ms TTFT SLO
    shed = fe.submit(prompt(P21_B_LENS["shed"]), priority="interactive", max_new_tokens=16)
    time.sleep(1e-3 * fe.config.get_class("interactive").ttft_slo_ms + 0.1)
    fe.step()
    states = {"queued": q.status, "prefill": pre.status, "decode": mid.status,
              "shed": shed.status, "prefill_passes_before_cancel": len(passes),
              "decode_tokens_before_cancel": len(mid.tokens)}
    if (q.status, pre.status, mid.status, shed.status) != (
            "cancelled", "cancelled", "cancelled", "shed") or len(mid.tokens) >= 64:
        raise AssertionError(f"phase 21: cancellation and shedding {states}")
    out["cancel"] = states
    # one decode slice under the sync check
    live = [fe.submit(prompt(P21_B_LENS["slice"]), priority="standard", max_new_tokens=24) for _ in range(2)]
    p21_step_until(fe, lambda: all(len(h.tokens) > 0 for h in live), "two decoding rows")
    before = [len(h.tokens) for h in live]
    with p21_sync_checked(dev) as seen:
        fe.step()
    if [len(h.tokens) for h in live] == before:
        raise AssertionError("phase 21: the sync-checked step decoded nothing")
    out["sync_free_slice"] = {"sync_debug_mode": "error", "policed_drains": seen["drains"],
                              "raised": False}
    prof = device_breakdown("phase 21 decode slice", fe.step, names=P21_NAMES) \
        if torch_device_is_cuda(dev) else {"wall_ms": None, "device_ms": None}
    out["profiled_slice"] = prof
    p21_step_until(fe, lambda: all(h.finished for h in live), "the last rows' finish")
    return [big, hi] + live, out


def torch_device_is_cuda(dev) -> bool:
    import torch
    return torch.device(dev).type == "cuda"


def run_frontend(model=None, dev="cuda"):
    """Phase 21: Llama-2-7B behind ``ServingFrontend`` at full width and
    ``P21_LAYERS`` of its 32 layers (random bf16 weights from seed 0),
    pages of 128, 48 of them, the
    prefix cache on, the default priority classes, offload preemption.
    ``engine.warmup()``, then the Poisson traffic replayed against the
    running frontend, then the ``step()``-driven part (preemption,
    cancellation at each stage, a shed, the sync check, a profiled slice).
    Fatal: every finished stream against its prompt served alone; every
    offload's pages and logits row back bit for bit; no step-cache entry
    added by the traffic; no leak after close; K2, K5 and the decode
    kernel launched. Returns (model, launches)."""
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.serving import goodput_report, replay
    from deepspeed_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    model = model if model is not None else p17_model(P21_LAYERS)
    V = model.config.vocab_size
    engine = InferenceEngineV2(model, P21_ENGINE, model.flat_params(), device=dev)
    t0 = time.perf_counter()
    warm_added = engine.warmup()
    warm_s = time.perf_counter() - t0
    entries0 = engine.step_cache_entries()
    free0 = engine.allocator.free_blocks
    arrivals = p21_arrivals(V)
    if torch_device_is_cuda(dev):
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    fe = engine.serving_frontend()
    audit = OffloadAudit(fe, dev)
    fe.start()
    t0 = time.perf_counter()
    handles = replay(fe, arrivals)
    if not fe.drain(timeout=P21_DRAIN_S):
        raise AssertionError("phase 21: the traffic did not drain")
    wall = time.perf_counter() - t0
    fe.close()
    traffic_entries = engine.step_cache_entries() - entries0
    report = goodput_report(handles, wall)
    fe_b = engine.serving_frontend()
    audit_b = OffloadAudit(fe_b, dev)
    b_handles, b = p21_part_b(engine, fe_b, np.random.RandomState(22), V, dev)
    fe_b.close()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    entries = engine.step_cache_entries() - entries0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if torch_device_is_cuda(dev) else None
    preempted = fe.stats.preemptions + fe_b.stats.preemptions
    restored = fe.stats.restores + fe_b.stats.restores
    checked = len(audit.checked) + len(audit_b.checked)
    engine.prefix_cache.evict(engine.allocator.total_blocks)
    leaks = {"free_blocks": engine.allocator.free_blocks, "free_blocks_before": free0,
             "live_uids": sorted(engine.scheduler.seqs),
             "offload_bytes_held": fe.offload.bytes_held + fe_b.offload.bytes_held,
             "pinned_buffers_out": fe.offload.pool.outstanding + fe_b.offload.pool.outstanding}
    if (leaks["free_blocks"] != free0 or leaks["live_uids"] or leaks["offload_bytes_held"]
            or leaks["pinned_buffers_out"]):
        raise AssertionError(f"phase 21: resources held after close: {leaks}")
    if entries:
        raise AssertionError(f"phase 21: the traffic added {entries} step-cache entries "
                             "after warmup")
    if preempted < 1 or restored < 1 or checked < 1 or audit.pending or audit_b.pending:
        raise AssertionError(f"phase 21: preemptions {preempted}, restores {restored}, "
                             f"offload round trips checked {checked}")
    missing = [k for k in ("flash_packed", "paged_chunk", "paged_decode")
               if not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 21: kernels not launched on the main path: {missing}")
    offload_ms = audit.offload_ms + audit_b.offload_ms
    restore_ms = audit.restore_ms + audit_b.restore_ms
    tokens = sum(len(h.tokens) for h in handles)
    tie = p21_tie(model, [a.prompt for a in arrivals if a.cls == "interactive"])
    compare = p21_reference("phase 21 Llama-2-7B frontend vs generate() alone", engine,
                            model, handles + b_handles, tie)
    print("frontend " + json.dumps({
        "phase": 21, "model": "Llama-2-7B", "pages": P21_ENGINE["kv_cache"],
        "warmup": {"step_cache_entries_added": warm_added, "s": warm_s,
                   "traffic_entries_added": traffic_entries},
        "arrivals": len(arrivals), "rate_per_s": P21_RATE, "wall_s": wall,
        "goodput": report, "latency": p21_percentiles(handles),
        "output_tok_s": tokens / wall,
        "preemptions": preempted, "restores": restored,
        "recompute_preemptions": fe.stats.recompute_preemptions
        + fe_b.stats.recompute_preemptions,
        "offloaded_bytes": audit.bytes + audit_b.bytes, "round_trips_checked": checked,
        "offload_ms": offload_ms, "restore_ms": restore_ms,
        "launches": {k: launches.get(k, 0) for k in P21_NAMES},
        "part_b": b, "streams": compare, "leaks_after_close": leaks,
        "peak_gib": peak, "nvidia_smi": smi_line()}), flush=True)
    del engine, fe, fe_b, audit, audit_b
    gc.collect()
    if torch_device_is_cuda(dev):
        torch.cuda.empty_cache()
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return model, launches


def p22_engines(model, n, dev, conf=P22_ENGINE):
    """``n`` engines over the model's one bf16 tree (the engine keeps the
    tensors it is given: no copy)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    params = model.flat_params()
    return [InferenceEngineV2(model, conf, params, device=dev) for _ in range(n)]


def p22_placements(cluster):
    """uid -> replica name of every request a replica's frontend accepts."""
    where = {}
    for r in cluster.frontends:
        fe = r.frontend
        submit = fe.submit

        def placed(*a, _submit=submit, _name=r.name, **k):
            h = _submit(*a, **k)
            where[h.uid] = _name
            return h

        fe.submit = placed
    return where


def p22_requests(V, seed, n, groups=1, bs=None):
    """``n`` prompts in ``groups`` prefix groups: a 1024-token prefix of the
    group, then a 128-token tail of the request's own. With ``bs`` (two
    groups), the second prefix is redrawn until its first page hashes to
    the other replica than the first's: the router's cold-start affinity
    (a page's worth of score) then sends the groups' first requests to
    different replicas."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(0, V, P22_PREFIX).astype(np.int32) for _ in range(groups)]
    while bs is not None and (hash(tuple(int(t) for t in prefixes[0][:bs])) % 2
                              == hash(tuple(int(t) for t in prefixes[1][:bs])) % 2):
        prefixes[1] = rng.randint(0, V, P22_PREFIX).astype(np.int32)
    return [np.concatenate([prefixes[i % groups], rng.randint(0, V, P22_TAIL).astype(np.int32)])
            for i in range(n)]


def p22_route(engines, V):
    """(a): two ``serve`` replicas behind a cache-aware router, two prefix
    groups of 8. The first request of each group runs to its end, then the
    other 14 go in: each group's later requests must land on the replica
    holding its prefix."""
    from deepspeed_tpu_torch.inference.v2.serving import ServingCluster, ServingRouter
    shared = all(engines[0].weights["layers"][0][k].data_ptr()
                 == engines[1].weights["layers"][0][k].data_ptr() for k in ("wq", "w_up"))
    prompts = p22_requests(V, 221, 2 * P22_GROUP, groups=2,
                           bs=engines[0].kv.config.block_size)
    cluster = ServingCluster(engines, serving=P22_ENGINE["serving"])
    where = p22_placements(cluster)
    route_ms = []
    with ServingRouter(cluster, P22_ROUTER) as rt:
        hs = []
        for p in prompts[:2]:
            t0 = time.perf_counter()
            hs.append(rt.submit(p, priority="standard", max_new_tokens=P22_NEW))
            route_ms.append((time.perf_counter() - t0) * 1e3)
        for h in hs:
            h.result(timeout=300)
        for p in prompts[2:]:
            t0 = time.perf_counter()
            hs.append(rt.submit(p, priority="standard", max_new_tokens=P22_NEW))
            route_ms.append((time.perf_counter() - t0) * 1e3)
        if not rt.drain(timeout=600):
            raise AssertionError("phase 22 (a): the router did not drain")
        hits = rt.stats.cache_hit_requests
        routed = dict(rt.stats.routed)
    home = {g: where[hs[g].uid] for g in (0, 1)}
    strays = [i for i, h in enumerate(hs[2:], 2) if where[h.uid] != home[i % 2]]
    if hits < 1 or strays or not shared or any(h.status != "finished" for h in hs):
        raise AssertionError(f"phase 22 (a): cache-hit routes {hits}, requests off their "
                             f"group's replica {strays}, statuses {[h.status for h in hs]}")
    for e in engines:
        e.prefix_cache.evict(e.allocator.total_blocks)
    return hs, {"cache_hit_routes": hits, "routed": routed, "homes": home,
                         "route_ms": route_ms, "shared_weight_tree": shared}


def p22_disagg(engines, V, dev):
    """(b): a ``prefill`` and a ``decode`` replica (the same two engines).
    Each handoff's exported pages must read back from the decode engine's
    imported blocks byte for byte, its logits row bit for bit; the decode
    engine prefills nothing. A handoff's ms runs from the export's start to
    the import's end; the imported blocks are copied on the card after
    that, and held against the export once the router has drained."""
    import torch
    from deepspeed_tpu_torch.inference.v2.serving import ServingCluster, ServingRouter
    pre, dec = engines
    prompts = p22_requests(V, 222, P22_DISAGG, groups=P22_DISAGG)
    exported, handoffs, held = {}, [], []
    export, import_kv = pre.export_kv, dec.import_kv

    def exporting(uid):
        p21_sync(dev)
        t0 = time.perf_counter()
        pages, logits = export(uid)
        exported[int(uid)] = (pages, logits, t0)
        return pages, logits

    def importing(uid, tokens, pages, logits):
        ids = import_kv(uid, tokens, pages, logits)
        p21_sync(dev)
        t1 = time.perf_counter()
        page_s, logits_s, t0 = exported.pop(int(uid))
        # the imported blocks as they stand now, copied on the card
        idx = torch.as_tensor(ids, dtype=torch.long, device=dec.kv.kv.device)
        copy = dec.kv.kv.index_select(1, idx).transpose(0, 1)
        row = np.array(dec._last_logits[int(uid)], np.float32)
        p21_sync(dev)
        held.append((copy, page_s, row, logits_s))
        handoffs.append({"uid": int(uid), "pages": len(ids), "bytes": int(page_s.nbytes),
                         "ms": (t1 - t0) * 1e3})
        return ids

    pre.export_kv, dec.import_kv = exporting, importing
    prefill0 = dec.scheduler.prefill_tokens_completed
    cluster = ServingCluster(engines, roles=["prefill", "decode"],
                             serving=P22_ENGINE["serving"])
    try:
        with ServingRouter(cluster, {"topology": "disaggregated",
                                     "shed_factor": P22_SHED_FACTOR}) as rt:
            hs = [rt.submit(p, priority="standard", max_new_tokens=P22_NEW) for p in prompts]
            if not rt.drain(timeout=600):
                raise AssertionError("phase 22 (b): the router did not drain")
            n_handoffs, nbytes = rt.stats.handoffs, rt.stats.handoff_bytes
    finally:
        del pre.export_kv, dec.import_kv
    dec_prefill = dec.scheduler.prefill_tokens_completed - prefill0
    for h, (copy, page_s, row, logits_s) in zip(handoffs, held):
        h["pages_equal"] = bool(np.array_equal(
            copy.contiguous().view(torch.uint8).cpu().numpy().reshape(-1),
            np.ascontiguousarray(page_s).view(np.uint8).reshape(-1)))
        h["logits_bit_equal"] = bool(np.array_equal(
            row.view(np.uint32), np.asarray(logits_s, np.float32).view(np.uint32)))
    del held
    bad = [h for h in handoffs if not (h["pages_equal"] and h["logits_bit_equal"])]
    if (bad or len(handoffs) != P22_DISAGG or n_handoffs != P22_DISAGG or dec_prefill
            or any(h.status != "finished" for h in hs)):
        raise AssertionError(f"phase 22 (b): handoffs {handoffs}, decode-engine prefill "
                             f"tokens {dec_prefill}, statuses {[h.status for h in hs]}")
    for e in engines:
        e.prefix_cache.evict(e.allocator.total_blocks)
    return hs, {"handoffs": n_handoffs, "handoff_bytes": nbytes,
                "per_sequence": handoffs, "decode_engine_prefill_tokens": dec_prefill}


def p22_wait_mid_stream(where, hs, name, n=1, timeout=300.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        mid = [h for h in hs if where.get(h.uid) == name and 0 < len(h.tokens) < h.max_new_tokens]
        if len(mid) >= n:
            return mid
        time.sleep(0.005)
    raise AssertionError(f"phase 22 (c): no request mid-stream on {name}")


def p22_counts():
    """The launch counts since the last reset, then a reset."""
    from deepspeed_tpu_torch.ops import kernels
    out = {k: v for k, v in kernels.LAUNCHES.items() if v}
    kernels.reset_launches()
    return out


def p22_failover(engines, V, dev):
    """(c): two ``serve`` replicas; a fault at r1's serving-loop site while
    r1 has requests mid-stream. Without a health monitor ``drain()`` names
    r1; with one, r1's requests migrate to r0 and every stream completes,
    one failure and its migrations are counted; then r1 rejoins and its
    warmup adds no step-cache entry. Returns the handles, the tokens each
    migrated handle had streamed when it was sealed (by handle id), the
    launch counts of the traffic (read before the rejoin) and the record."""
    from deepspeed_tpu_torch.inference.v2.serving import ServingCluster, ServingRouter
    from deepspeed_tpu_torch.utils import fault_injection as fi
    prompts = p22_requests(V, 223, P22_FAILOVER, groups=P22_FAILOVER)
    # without health monitoring: the died loop surfaces, named
    cluster = ServingCluster(engines, serving=P22_ENGINE["serving"])
    where = p22_placements(cluster)
    rt = ServingRouter(cluster, {"policy": "round_robin",
                                 "shed_factor": P22_SHED_FACTOR}).start()
    named = None
    try:
        hs0 = [rt.submit(p, priority="standard", max_new_tokens=P22_NEW) for p in prompts[:2]]
        p22_wait_mid_stream(where, hs0, "r1")
        fi.install(fi.parse_plan("serve.engine_step.r1:at=1:action=raise"))
        try:
            rt.drain(timeout=300)
        except RuntimeError as exc:
            named = str(exc)
        finally:
            fi.clear()
    finally:
        try:
            rt.close()
        except RuntimeError:
            pass                     # the same died loop, raised once more
    if named is None or "replica 'r1'" not in named:
        raise AssertionError(f"phase 22 (c): drain() raised {named!r}")
    for e in engines:
        for uid in list(e.scheduler.seqs):
            e.flush([uid])
        e.prefix_cache.evict(e.allocator.total_blocks)
    # with health monitoring: migration, then the rejoin
    cluster = ServingCluster(engines, serving=P22_ENGINE["serving"])
    where = p22_placements(cluster)
    entries = engines[1].step_cache_entries()
    rt = ServingRouter(cluster, {"policy": "round_robin", "health": P22_HEALTH,
                                 "shed_factor": P22_SHED_FACTOR})
    migrate_ms, seams = [], {}
    migrate_one = rt.health._migrate_one

    def timed(replica, fe, req, *a, **k):
        seal = req._seal

        def sealing():
            history = seal()
            seams[id(req)] = len(history) - len(req.prompt)
            return history

        req._seal = sealing
        t0 = time.perf_counter()
        try:
            return migrate_one(replica, fe, req, *a, **k)
        finally:
            migrate_ms.append((time.perf_counter() - t0) * 1e3)
            del req._seal

    rt.health._migrate_one = timed
    rt.start()
    try:
        hs = [rt.submit(p, priority="standard", max_new_tokens=P22_NEW) for p in prompts]
        p22_wait_mid_stream(where, hs, "r1")
        old_fe = rt.cluster.replica("r1").frontend
        on_r1 = [h.uid for h in hs if where[h.uid] == "r1" and not h.finished]
        fi.install(fi.parse_plan("serve.engine_step.r1:at=1:action=raise"))
        try:
            if not rt.drain(timeout=600):
                raise AssertionError("phase 22 (c): the router did not drain")
        finally:
            fi.clear()
        launches = p22_counts()
        deadline = time.monotonic() + 120
        while not rt.health.rejoin("r1"):
            if time.monotonic() > deadline:
                raise AssertionError("phase 22 (c): r1 did not rejoin")
            time.sleep(0.05)
        if not rt.health.wait_all_healthy(120):
            raise AssertionError("phase 22 (c): r1 did not rejoin")
        st = rt.health.stats
        health = {"liveness_downs": st.liveness_downs, "stall_downs": st.stall_downs,
                  "migrations": st.migrations, "salvaged": st.salvaged,
                  "reprefilled": st.reprefilled, "migration_sheds": st.migration_sheds,
                  "rejoins": st.rejoins, "rejoin_warmup_ms": st.rejoin_warmup_ms,
                  "detect_ms": list(st.detect_ms), "handled": rt.health.handled_replicas()}
        rejoined = rt.cluster.replica("r1").frontend
        after = rt.submit(prompts[0], priority="standard", max_new_tokens=4)
        if not rt.drain(timeout=300) or after.status != "finished":
            raise AssertionError("phase 22 (c): the rejoined cluster does not serve")
    finally:
        rt.close()
    added = engines[1].step_cache_entries() - entries
    migrated = [h for h in hs if h.migrated]
    short = [(h.uid, len(h.tokens)) for h in hs if len(h.tokens) != h.max_new_tokens]
    if (health["liveness_downs"] != 1 or health["migrations"] < 1 or health["rejoins"] != 1
            or added or any(h.status != "finished" for h in hs) or short
            or rejoined is old_fe or health["migration_sheds"]
            or any(id(h) not in seams for h in migrated)):
        raise AssertionError(f"phase 22 (c): health {health}, step-cache entries added "
                             f"{added}, statuses {[h.status for h in hs]}, streams not "
                             f"{P22_NEW} tokens long {short}, migrated "
                             f"{len(migrated)} of which sealed {len(seams)}")
    return hs, seams, launches, {"drain_named": named, "on_r1_at_fault": len(on_r1),
                "migrated_streams": len(migrated),
                "streamed_at_seal": [seams[id(h)] for h in migrated], "health": health,
                "migrate_ms": migrate_ms, "rejoin_step_cache_entries_added": added}


def p22_continuations(label, engine, model, handles, seams, tie):
    """Each migrated stream past its seam: the tokens streamed after the
    seal against ``generate()`` of the prompt and the tokens streamed
    before it, equal or parting only at a near tie (:func:`stream_tie`).
    Returns the counts of equal and parted continuations."""
    cases = []
    for h in handles:
        k = seams.get(id(h), 0)
        if 0 < k < len(h.tokens):
            prompt = np.concatenate([h.prompt, np.asarray(h.tokens[:k], np.int32)])
            out = engine.generate([prompt], max_new_tokens=len(h.tokens) - k)[0]
            cases.append((prompt, h.tokens[k:], [int(t) for t in out[len(prompt):]]))
    for prompt, got, ref in cases:
        if len(got) != len(ref):
            raise AssertionError(f"{label}: a continuation of {len(got)} tokens, "
                                 f"its reference {len(ref)}")
    parted = [c for c in cases if c[1] != c[2]]
    if parted:
        stream_tie(label, model, *zip(*parted), tie)
    counts = {"continuations": len(cases), "equal": len(cases) - len(parted),
              "parted": len(parted)}
    print("stream-compare " + json.dumps({"case": label, **counts, "limit": tie}), flush=True)
    return counts


def run_cluster(model=None, dev="cuda"):
    """Phase 22: ``ServingCluster`` + ``ServingRouter`` over two Llama-2-7B
    replicas on the one card, sharing the model's bf16 tree: (a)
    cache-aware routing of two prefix groups, (b) disaggregated prefill and
    decode with every handoff held byte for byte, (c) failover of a
    crashed replica and its rejoin. Every finished stream is held against
    its prompt served alone by ``generate()``, and every migrated stream
    past its seam against the prompt and the tokens before it. Both
    engines are warmed before the launch counts are zeroed; each part's
    counts are read and gated on their own, (c)'s before the rejoin's
    warmup. Returns the launches of the three parts' traffic."""
    import torch
    from deepspeed_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    model = model if model is not None else p17_model()
    V = model.config.vocab_size
    engines = p22_engines(model, 2, dev)
    for e in engines:
        e.warmup()
    if torch_device_is_cuda(dev):
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    hs_a, a = p22_route(engines, V)
    parts = {"a": p22_counts()}
    hs_b, b = p22_disagg(engines, V, dev)
    parts["b"] = p22_counts()
    hs_c, seams, parts["c"], c = p22_failover(engines, V, dev)
    launches = {k: sum(p.get(k, 0) for p in parts.values())
                for k in set().union(*parts.values())}
    missing = {part: [k for k in ("flash_packed", "paged_decode") if not n.get(k)]
               for part, n in parts.items()}
    missing = {part: ks for part, ks in missing.items() if ks}
    if not launches.get("paged_chunk"):
        missing["all"] = ["paged_chunk"]
    if missing:
        raise AssertionError(f"phase 22: kernels not launched by the traffic: {missing}")
    tie = p21_tie(model, [h.prompt for h in hs_a])
    ref = engines[0]
    compare = {part: p21_reference(f"phase 22 ({part}) Llama-2-7B router vs generate() alone",
                                   ref, model, hs, tie)
               for part, hs in (("a", hs_a), ("b", hs_b), ("c", hs_c))}
    compare["c_after_seal"] = p22_continuations(
        "phase 22 (c) migrated streams past the seal vs generate() of prompt + streamed",
        ref, model, hs_c, seams, tie)
    per_seq = b.pop("per_sequence")
    print("router " + json.dumps({
        "phase": 22, "model": "Llama-2-7B", "replicas": 2,
        "shared_weight_tree": a.pop("shared_weight_tree"), "route": a,
        "disaggregated": {**b, "handoff_ms": [h["ms"] for h in per_seq],
                          "handoff_bytes_per_sequence": [h["bytes"] for h in per_seq],
                          "handoff_pages_per_sequence": [h["pages"] for h in per_seq]},
        "failover": c, "streams": compare,
        "launches": {k: launches.get(k, 0) for k in P21_NAMES},
        "launches_by_part": {part: {k: n.get(k, 0) for k in P21_NAMES}
                             for part, n in parts.items()},
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
        if torch_device_is_cuda(dev) else None,
        "nvidia_smi": smi_line()}), flush=True)
    del engines, ref
    gc.collect()
    if torch_device_is_cuda(dev):
        torch.cuda.empty_cache()
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 23: the colocated rollout and the hybrid engine on one policy
# --------------------------------------------------------------------------- #

# phase 20's depth: 8 of Llama-2-7B's 32 layers at full width (1.88 B params)
P23_LAYERS = P20_LAYERS
P23_CONFIG = {
    "train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
    "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 0,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-5, "betas": [0.9, 0.95],
                                              "eps": 1e-8, "weight_decay": 0.0}},
    "train_pipeline": {"prefetch": 0},
    "hybrid_engine": {"enabled": True, "max_out_tokens": 64},
}
# 64 pages of 128 (1 GiB at 8 layers): the rollouts' 8 x 4 pages with room
P23_ENGINE = {"kv_cache": {"block_size": 128, "num_blocks": 64},
              "state_manager": {"max_context": 1024},
              "prefix_cache": {"enabled": True}, "compile": {"warmup": True}, "seed": 0,
              "serving": {"decode_slice": 4}}
# the comparison engines: the same serving config with a smaller pool
P23_FRESH = {"kv_cache": {"block_size": 128, "num_blocks": 40},
             "state_manager": {"max_context": 1024}, "prefix_cache": {"enabled": True},
             "seed": 0}
P23_T = 512               # the collated rows: prompt + rollout, zero-padded
P23_PREFIX = 256          # the rollout prompts' shared prefix
P23_LENS = (384, 448)     # the rollout prompts' lengths (inclusive)
P23_PROMPTS = 8
P23_NEW = 64              # new tokens a rollout request
P23_STREAM_NEW = 32       # new tokens of (b)'s greedy streams
P23_ROUNDS = 3
P23_V1 = (4, 128, 32)     # the hybrid generate: rows, prompt tokens, new tokens
P23_SYNCS = 3             # timed syncs of each kind
P23_NAMES = K1_NAMES + ("flash_packed", "paged_chunk", "paged_decode", "paged_splitk",
                        "splitk_merge")


def p23_cuda(dev) -> bool:
    import torch
    return torch.device(dev).type == "cuda"


def p23_sync(dev) -> None:
    import torch
    if p23_cuda(dev):
        torch.cuda.synchronize()


@contextlib.contextmanager
def p23_uncounted():
    """Kernel launches inside the block (the comparison engines' and the
    reference runs') are taken back out of the counts."""
    from deepspeed_tpu_torch.ops import kernels
    saved = dict(kernels.LAUNCHES)
    try:
        yield
    finally:
        for k in list(kernels.LAUNCHES):
            kernels.LAUNCHES[k] = saved.get(k, 0)


def p23_batches(V, seed, n):
    """``n`` global batches of 8 x ``P23_T`` seeded token ids."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, V, (8, P23_T)).astype(np.int32)} for _ in range(n)]


def p23_prompts(V, rnd):
    """Round ``rnd``'s 8 rollout prompts: the shared ``P23_PREFIX`` tokens
    (seed 23), then a seeded tail to a length in ``P23_LENS``."""
    prefix = np.random.default_rng(23).integers(0, V, P23_PREFIX)
    rng = np.random.default_rng(2300 + rnd)
    lens = rng.integers(P23_LENS[0], P23_LENS[1] + 1, P23_PROMPTS)
    return [np.concatenate([prefix, rng.integers(0, V, int(n) - P23_PREFIX)]).astype(np.int32)
            for n in lens]


def p23_collate(rollouts):
    """Prompt + rollout tokens as one zero-padded row each: [8, ``P23_T``]."""
    rows = np.zeros((len(rollouts), P23_T), np.int32)
    for j, (p, t) in enumerate(rollouts):
        seq = (list(p) + list(t))[:P23_T]
        rows[j, :len(seq)] = seq
    return {"input_ids": rows}


def p23_dense(model, seq, rows, dt, dev):
    """The trainer module's dense forward (its live bf16 weights) in
    ``dt``: f32 logits at ``rows`` of token sequence ``seq``."""
    import torch
    ids = torch.from_numpy(np.asarray(seq, np.int64)).to(dev)[None]
    return model.forward_logits(ids, compute_dtype=dt)[0, torch.as_tensor(rows, device=dev)]


def p23_gap(model, seq, dev) -> float:
    """Top-2 gap of the dense fp32 logits after ``seq``."""
    import torch
    top = torch.topk(p23_dense(model, seq, [len(seq) - 1], torch.float32, dev)[0], 2).values
    return float(top[0] - top[1])


def p23_tie(model, prompts, dev) -> float:
    """The near-tie limit, as phases 17 and 21 set it: twice the dense bf16
    forward's largest logit error against fp32, at the last row of the
    first ``P21_TIE_ROWS`` prompts."""
    import torch
    errs = []
    for p in prompts[:P21_TIE_ROWS]:
        a = p23_dense(model, p, [len(p) - 1], torch.float32, dev)
        b = p23_dense(model, p, [len(p) - 1], torch.bfloat16, dev)
        errs.append(float((b - a).abs().max()))
    return 2 * max(errs)


def p23_streams(label, model, prompts, got, ref, tie, dev):
    """``same_or_near_tie`` over generated streams (prompts stripped, equal
    lengths), the gaps from the dense fp32 forward of the live weights."""
    n = min(min(len(g), len(r)) for g, r in zip(got, ref))
    a = np.array([list(g[:n]) for g in got])
    b = np.array([list(r[:n]) for r in ref])
    same_or_near_tie(label, a, b, lambda i, step: p23_gap(
        model, np.concatenate([prompts[i], b[i, :step]]).astype(np.int32), dev), tie)
    return {"streams": len(got), "equal": int((a == b).all(axis=1).sum())}


def p23_trace_gaps(model, prompts, streams, dev):
    """Per row, the dense fp32 top-2 gap at every step of its stream (one
    forward over prompt + stream), for streams whose weights are gone by
    the time they are compared."""
    import torch
    out = []
    for p, s in zip(prompts, streams):
        seq = np.concatenate([p, np.asarray(s, np.int32)])
        lg = p23_dense(model, seq, list(range(len(p) - 1, len(seq) - 1)), torch.float32, dev)
        top = torch.topk(lg, 2, dim=-1).values
        out.append((top[:, 0] - top[:, 1]).cpu().numpy())
        del lg
    return out


def p23_no_host_copy(bridge, dev) -> dict:
    """One sync (its final wait outside) under ``set_sync_debug_mode("error")``
    and the profiler: no host->device or device->host copy on the card's
    side of the trace, and no ``cudaMemcpy*`` call on the host's (the
    casts are kernels, one a serving tensor); the kernel launches and the
    device events it holds are counted against the tree's leaves."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not p23_cuda(dev):
        bridge.sync(wait=False)
        return {"memcpy_htod_dtoh": 0, "device_events": None}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            bridge.sync(wait=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    copies, events, launches, kernels = [], 0, 0, collections.Counter()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            events += 1
            kernels[name[:60]] += 1
            if "Memcpy" in name and ("HtoD" in name or "DtoH" in name):
                copies.append(name)
        elif name.startswith("cudaMemcpy"):
            copies.append(name)
        elif name == "cudaLaunchKernel":
            launches += 1
    if copies or not events:
        raise AssertionError(f"phase 23 (a): a sync moved bytes across the host link "
                             f"({copies[:4]}) or left no device event ({events})")
    return {"memcpy_htod_dtoh": 0, "cuda_memcpy_calls": 0, "device_events": events,
            "kernel_launches": launches, "device_event_names": dict(kernels.most_common(4))}


def p23_timed_syncs(bridge, dev) -> list:
    """``P23_SYNCS`` syncs, each waited on, in ms (host clock)."""
    out = []
    for _ in range(P23_SYNCS):
        p23_sync(dev)
        t0 = time.perf_counter()
        bridge.sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def p23_bridge(trainer, engine, V, dev) -> dict:
    """(a) The bridge after 2 steps: byte-equal to a fresh engine built from
    the master; one layout build; no host copy; a donating sync keeps every
    serving tensor and needs no new memory; sync ms and GB/s against the
    bound. Returns (the fresh engine, the non-donating bridge's tree,
    the part's numbers)."""
    import torch
    from deepspeed_tpu_torch.checkpoint.state import flatten_tree
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    bridge = engine.weight_bridge(trainer, donate=False)
    new_w = bridge.sync()
    with p23_uncounted():
        fresh = InferenceEngineV2(trainer.module, P23_FRESH, trainer.state["master"],
                                  device=dev)
    got, want = flatten_tree(new_w), flatten_tree(fresh.weights)
    bad = [k for k in want if k not in got or not torch_equal_bits(got[k], want[k])]
    if bad or set(got) != set(want):
        raise AssertionError(f"phase 23 (a): the bridge's tree differs from a fresh build "
                             f"at {bad[:4]}")
    trace = p23_no_host_copy(bridge, dev)
    fresh_ms = p23_timed_syncs(bridge, dev)
    if bridge.compiles != 1:
        raise AssertionError(f"phase 23 (a): {bridge.compiles} layout builds")
    src = trainer.rollout_source_params()
    read = sum(t.nbytes for t in src.values())
    bound_ms = (read + bridge.nbytes) / HBM_BYTES_PER_S * 1e3
    out = {"leaves": len(got), "bytes_equal_fresh_build": True, "no_host_copy": trace,
           "compiles": bridge.compiles, "read_bytes": read, "write_bytes": bridge.nbytes,
           "bound_ms": bound_ms, "fresh_tree_ms": fresh_ms}
    return fresh, new_w, out


def p23_donate(trainer, engine, dev) -> dict:
    """(a) A donating sync on the idle engine: every serving tensor's
    data_ptr kept, the peak's rise under the largest leaf, one build; then
    timed."""
    import torch
    from deepspeed_tpu_torch.checkpoint.state import flatten_tree
    from deepspeed_tpu_torch.runtime.colocated import WeightBridge
    bridge = WeightBridge(trainer, engine, donate=True)
    leaves = flatten_tree(engine.weights)
    ptrs = {k: t.data_ptr() for k, t in leaves.items()}
    largest = max(t.nbytes for t in leaves.values())
    rise = None
    if p23_cuda(dev):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    out_w = bridge.sync()
    if p23_cuda(dev):
        rise = torch.cuda.max_memory_allocated() - base
        if not rise < largest:
            raise AssertionError(f"phase 23 (a): a donating sync raised the peak by {rise} "
                                 f"bytes, the largest leaf is {largest}")
    moved = [k for k, t in flatten_tree(out_w).items() if t.data_ptr() != ptrs[k]]
    if out_w is not engine.weights or moved:
        raise AssertionError(f"phase 23 (a): a donating sync moved {moved[:4]}")
    ms = p23_timed_syncs(bridge, dev)
    if bridge.compiles != 1:
        raise AssertionError(f"phase 23 (a): {bridge.compiles} layout builds (donating)")
    return {"data_ptrs_kept": len(ptrs), "peak_rise_bytes": rise, "largest_leaf_bytes": largest,
            "donate_ms": ms}


def p23_prefix_hits(engine, prompts, n=4):
    """Serve two prompts that share the 256-token prefix, one after the
    other; returns the prefix cache's hit count after each."""
    hits = []
    for p in prompts[:2]:
        engine.generate([p], max_new_tokens=n)
        hits.append(engine.prefix_cache.stats.hits)
    return hits


def p23_swap(engine, fresh, model, new_w, pre, V, dev) -> dict:
    """(b) The swap: no step-cache entry; the prefix cache misses on the
    first request after the swap and hits on the second; a control
    prompt's final-row logits differ from the pre-swap ones and equal the
    fresh engine's (the same requests before them) bit for bit; 8 greedy
    streams against the fresh engine's."""
    entries0 = engine.step_cache_entries()
    prompts = p23_prompts(V, 0)
    t0 = time.perf_counter()
    ver = engine.swap_weights(new_w)
    swap_ms = (time.perf_counter() - t0) * 1e3
    if engine.prefix_cache.weight_version != engine.weight_version:
        raise AssertionError("phase 23 (b): the prefix cache kept its old weight version")
    h0 = engine.prefix_cache.stats.hits
    hits = p23_prefix_hits(engine, prompts)
    if not (hits[0] == h0 and hits[1] > hits[0]):
        raise AssertionError(f"phase 23 (b): prefix hits {h0} -> {hits} across the swap "
                             f"(before it: {pre['hits']})")
    post = engine.put([7], [prompts[-1]])
    engine.flush([7])
    with p23_uncounted():
        p23_prefix_hits(fresh, prompts)
        ref = fresh.put([7], [prompts[-1]])
        fresh.flush([7])
    if np.array_equal(post, pre["logits"]) or not np.array_equal(post, ref):
        raise AssertionError("phase 23 (b): the control logits did not follow the swap "
                             f"(same as before: {np.array_equal(post, pre['logits'])}, same "
                             f"as the fresh engine: {np.array_equal(post, ref)})")
    tie = p23_tie(model, prompts, dev)
    got = engine.generate(prompts, max_new_tokens=P23_STREAM_NEW)
    with p23_uncounted():
        want = fresh.generate(prompts, max_new_tokens=P23_STREAM_NEW)
    streams = p23_streams("phase 23 (b) swapped engine vs a fresh engine", model, prompts,
                          [g[len(p):] for g, p in zip(got, prompts)],
                          [w[len(p):] for w, p in zip(want, prompts)], tie, dev)
    if engine.step_cache_entries() != entries0:
        raise AssertionError(f"phase 23 (b): the swap added "
                             f"{engine.step_cache_entries() - entries0} step-cache entries")
    return {"version": ver, "swap_ms": swap_ms, "control_logits_changed": True,
            "control_bit_equal_fresh": True,
            "prefix_hits": {"before": pre["hits"], "after": [h0] + hits},
            "streams": streams, "tie": tie, "step_cache_entries": entries0}


def p23_traffic(trainer, engine, fe, model, batch, V, dev) -> dict:
    """(c) A swap under traffic: 8 requests of ``P23_NEW`` tokens decode on
    the frontend ``fe``, started here; one more train step, then
    ``bridge.sync_and_swap(fe)`` while they decode. Every request live at
    the swap is recompute-preempted and finishes with all its tokens;
    tokens before the swap match the old weights' streams, tokens after
    it a fresh new-weights engine fed prompt + tokens so far."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    prompts = p23_prompts(V, 1)
    entries0 = engine.step_cache_entries()
    with p23_uncounted():
        old = [o[len(p):] for o, p in zip(engine.generate(prompts, max_new_tokens=P23_NEW),
                                          prompts)]
    # the frontend's thread runs whatever prefill is pending on its engine,
    # so it starts only after the direct generate() above
    fe.start()
    gaps = p23_trace_gaps(model, prompts, old, dev)
    tie = p23_tie(model, prompts, dev)
    trainer.train_batch(batch)
    bridge = engine.weight_bridge(trainer, donate=False)
    split, live = {}, {}
    preempt, apply = fe._preempt_for_swap, fe._apply_swap

    def noting_preempt(req):
        out = preempt(req)
        split[req.uid] = len(req._resume_tokens) - len(req.prompt)
        return out

    def noting_apply(new_weights, version):
        live["n"] = len(fe._live)
        return apply(new_weights, version)

    fe._preempt_for_swap, fe._apply_swap = noting_preempt, noting_apply
    pre = (fe.stats.recompute_preemptions, fe.stats.forced_sheds)
    try:
        hs = [fe.submit(p, max_new_tokens=P23_NEW) for p in prompts]
        deadline = time.perf_counter() + 120.0
        while not all(h.status == "decoding" and len(h.tokens) >= 4 for h in hs):
            if time.perf_counter() > deadline or any(h.finished for h in hs):
                raise AssertionError("phase 23 (c): the requests did not all reach decode "
                                     f"({[(h.status, len(h.tokens)) for h in hs]})")
            time.sleep(0.001)
        t0 = time.perf_counter()
        ver = bridge.sync_and_swap(fe)
        swap_ms = (time.perf_counter() - t0) * 1e3
        outs = [h.result(timeout=600.0) for h in hs]
    finally:
        fe._preempt_for_swap, fe._apply_swap = preempt, apply
    preempted = fe.stats.recompute_preemptions - pre[0]
    shed = fe.stats.forced_sheds - pre[1]
    if not (preempted == live.get("n") and preempted >= 1 and shed == 0
            and all(h.status == "finished" and len(o) == P23_NEW for h, o in zip(hs, outs))):
        raise AssertionError(f"phase 23 (c): {preempted} recompute preemptions of "
                             f"{live.get('n')} live at the swap, {shed} shed, "
                             f"{[(h.status, len(o)) for h, o in zip(hs, outs)]}")
    # before the swap: the old weights' streams, or parting at a near tie
    k = [split.get(h.uid, P23_NEW) for h in hs]
    ties = []
    for i, (o, n) in enumerate(zip(outs, k)):
        diff = np.flatnonzero(np.asarray(o[:n]) != np.asarray(old[i][:n]))
        if diff.size:
            ties.append({"row": i, "step": int(diff[0]), "top2_gap": float(gaps[i][diff[0]])})
            if not ties[-1]["top2_gap"] < tie:
                raise AssertionError(f"phase 23 (c): row {i} leaves the old weights' stream "
                                     f"at step {diff[0]} before the swap, top-2 gap "
                                     f"{ties[-1]['top2_gap']} >= {tie}")
    # after it: a fresh engine of the new weights, fed prompt + tokens so far
    rows = [i for i, n in enumerate(k) if n < P23_NEW]
    heads = [np.concatenate([prompts[i], np.asarray(outs[i][:k[i]], np.int32)]) for i in rows]
    with p23_uncounted():
        fresh = InferenceEngineV2(trainer.module, P23_FRESH, trainer.state["master"],
                                  device=dev)
        want = [fresh.generate([hd], max_new_tokens=P23_NEW - k[i])[0][len(hd):]
                for hd, i in zip(heads, rows)]
    after = p23_streams("phase 23 (c) tokens after the swap vs a fresh engine of the new "
                        "weights", model, heads, [outs[i][k[i]:] for i in rows], want,
                        tie, dev)
    del fresh
    if engine.step_cache_entries() != entries0:
        raise AssertionError("phase 23 (c): the swap under traffic added step-cache entries")
    return {"version": ver, "sync_and_swap_ms": swap_ms, "live_at_swap": live.get("n"),
            "recompute_preemptions": preempted, "shed": shed, "tokens_at_swap": k,
            "before": {"first_differences": ties}, "after": after, "tie": tie}


def p23_loop(trainer, fe, V, dev) -> tuple:
    """(d) ``RolloutLoop``: ``P23_ROUNDS`` rounds of 8 rollouts
    (``P23_PROMPTS`` prompts sharing the prefix, ``P23_NEW`` new tokens)
    collated to [8, ``P23_T``] and one ``train_steps(1)`` each, under the
    tracer: the stats equal the spans. Returns (losses, the collated
    batches, the part's numbers)."""
    from deepspeed_tpu_torch.monitor.trace import tracer
    from deepspeed_tpu_torch.runtime.colocated import RolloutLoop
    collated, train_ms = [], []

    def collate(rollouts):
        batch = p23_collate(rollouts)
        collated.append({k: v.copy() for k, v in batch.items()})
        return batch

    steps = trainer.train_steps

    def timed_steps(n, data_iter=None):
        t0 = time.perf_counter()
        out = steps(n, data_iter=data_iter)      # reads the losses: synced
        train_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tracer.reset()
    tracer.configure(enabled=True)
    trainer.train_steps = timed_steps
    loop = RolloutLoop(trainer, fe, prompt_fn=lambda r: p23_prompts(V, 10 + r),
                       collate_fn=collate, steps_per_round=1, max_new_tokens=P23_NEW,
                       request_timeout=600.0)
    try:
        losses = loop.run(P23_ROUNDS)
        spans = tracer.summary()
        recs = sorted((r for r in tracer.iter_records()
                       if r[1].startswith("train/rollout/")), key=lambda r: r[2])
    finally:
        loop.close()
        del trainer.train_steps
        tracer.reset()
    st = loop.stats
    losses = [float(x) for l in losses for x in l]
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase 23 (d): losses {losses}")
    want = {"sync": (P23_ROUNDS + 1, st.sync_ms), "swap": (P23_ROUNDS + 1, st.swap_ms),
            "generate": (P23_ROUNDS, st.generate_ms)}
    for phase, (count, ms) in want.items():
        n, s = spans.get(f"train/rollout/{phase}", (0, 0.0))
        if n != count or abs(s * 1e3 - ms) > 1e-6:
            raise AssertionError(f"phase 23 (d): {phase} spans ({n}, {s * 1e3} ms) against "
                                 f"the stats ({count}, {ms} ms)")
    per = {p: [(r[3] - r[2]) * 1e3 for r in recs if r[1] == f"train/rollout/{p}"]
           for p in want}
    rounds = [{"sync_ms": per["sync"][r + 1], "swap_ms": per["swap"][r + 1],
               "generate_ms": per["generate"][r], "train_ms": train_ms[r],
               "generate_tok_s": P23_PROMPTS * P23_NEW / (per["generate"][r] / 1e3)}
              for r in range(P23_ROUNDS)]
    ev = {n: v for n, v, _ in st.events(0)}
    return losses, collated, {"losses": losses, "rounds": rounds, "align": {
        "sync_ms": per["sync"][0], "swap_ms": per["swap"][0]}, "events": ev,
        "preempted": st.preempted, "shed": st.shed, "tokens": st.tokens}


def p23_hybrid(trainer, model, batches, V, dev) -> dict:
    """(d) The hybrid engine: ``generate`` of [4, 128] prompts, 32 new
    tokens, before and after 2 ``train_batch`` steps; the v1 params follow
    training, the output equals a fresh ``InferenceEngine`` over the same
    cast master, the v1 prefill's last-row logits are within 2x the dense
    bf16 forward's rms error of the dense fp32 forward (a one-row-late
    control fails that limit), and ``generate_count == 2``."""
    import torch
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    B, T, N = P23_V1
    prompt = np.random.default_rng(231).integers(0, V, (B, T)).astype(np.int32)
    trainer.generate(prompt, max_new_tokens=N)
    infer = trainer._inference_engine()
    name = "layers_0/self_attn/q_proj/kernel"
    before = infer.params[name].float().clone()
    for b in batches:
        trainer.train_batch(b)
    out = trainer.generate(prompt, max_new_tokens=N)
    after = infer.params[name].float()
    if torch.allclose(before, after) or trainer.generate_count != 2:
        raise AssertionError(f"phase 23 (d): the v1 params did not follow training, or "
                             f"generate_count {trainer.generate_count}")
    gen_s = trainer.generate_time
    fresh = InferenceEngine(trainer.module, {"dtype": "bfloat16", "max_out_tokens": 64},
                            model_parameters=trainer.state["master"], device=dev)
    want = fresh.generate(prompt, max_new_tokens=N)
    del fresh
    gc.collect()
    tie = p23_tie(model, list(prompt), dev)
    streams = p23_streams("phase 23 (d) hybrid generate vs a fresh InferenceEngine", model,
                          list(prompt), [o[T:] for o in out], [w[T:] for w in want], tie, dev)
    with torch.no_grad():
        ids = torch.from_numpy(prompt.astype(np.int64)).to(dev)
        lg = infer._net.decode(ids, infer._make_cache(B, T), 0)[0]
        d32 = model.forward_logits(ids, compute_dtype=torch.float32)
        d16 = model.forward_logits(ids, compute_dtype=torch.bfloat16)
    rms = lambda x: float(x.pow(2).mean().sqrt())
    v1_rms, bf16_rms = rms(lg[:, -1] - d32[:, -1]), rms(d16[:, -1] - d32[:, -1])
    late_rms = rms(lg[:, -2] - d32[:, -1])
    limit = 2 * bf16_rms
    if not v1_rms <= limit or not late_rms > limit:
        raise AssertionError(f"phase 23 (d): v1 logits rms {v1_rms}, one row late {late_rms}, "
                             f"limit {limit}")
    del lg, d32, d16
    return {"generate_count": trainer.generate_count, "generate_s": gen_s,
            "v1_tok_s": B * N / gen_s, "streams": streams,
            "v1_logits_rms": v1_rms, "dense_bf16_rms": bf16_rms, "one_row_late_rms": late_rms}


def p23_replay(cfg, batches, dev) -> list:
    """A trainer rebuilt from the same seed, trained on ``batches`` (host
    copies) one ``train_batch`` at a time: its loss stream."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    trainer, *_ = deepspeed_tpu_torch.initialize(model=model, config=P23_CONFIG, device=dev)
    losses = [trainer.train_batch(b) for b in batches]
    out = [float(x) for x in torch.stack(losses).cpu().numpy()]
    del trainer, model, losses
    return out


def run_rollout(layers: int = P23_LAYERS, dev="cuda", cfg=None):
    """Phase 23: one Llama-2-7B-width policy (8 of 32 layers, seeded random
    weights) that trains and serves on the one card: ``initialize`` with
    ``hybrid_engine.enabled`` gives the trainer (bf16 with an fp32 master,
    AdamW, clipping 1.0, micro-batch 4 x gas 2), and a v2 engine (pages of
    128, 64 of them, the prefix cache, warmup) serves it behind its
    frontend. (a) the WeightBridge: bytes, no host copy, donation; (b) the
    swap; (c) a swap under traffic; (d) ``RolloutLoop`` and the hybrid
    engine, then the loop's losses against a replay. Returns the main
    path's launches (read before the replay)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    cuda = p23_cuda(dev)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=layers, dtype=torch.bfloat16)
    V = cfg.vocab_size
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    trainer, *_ = deepspeed_tpu_torch.initialize(model=model, config=P23_CONFIG, device=dev)
    n_params = sum(t.numel() for t in trainer.state["master"].values())
    engine = InferenceEngineV2(model, P23_ENGINE, trainer.state["master"], device=dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    print(f"phase 23 model: Llama-2-7B width (vocab {V}, hidden {cfg.hidden_size}, FFN "
          f"{cfg.intermediate_size}, {cfg.num_attention_heads} heads, D {cfg.head_dim}), "
          f"{cfg.num_hidden_layers} layers, {n_params} params; trainer "
          f"{type(trainer).__name__}", flush=True)
    # before any step: the control logits and the prefix cache's hits
    prompts0 = p23_prompts(V, 0)
    pre_logits = engine.put([7], [prompts0[-1]])
    engine.flush([7])
    pre = {"logits": pre_logits, "hits": p23_prefix_hits(engine, prompts0)}
    if not pre["hits"][1] > pre["hits"][0]:
        raise AssertionError(f"phase 23 (b): no prefix hit before the swap ({pre['hits']})")
    batches = p23_batches(V, 23, 5)       # (a)'s 2, (c)'s 1, the hybrid's 2
    t0 = time.perf_counter()
    for b in batches[:2]:
        trainer.train_batch(b)
    p23_sync(dev)
    a_train_s = time.perf_counter() - t0
    fresh, new_w, a = p23_bridge(trainer, engine, V, dev)
    b = p23_swap(engine, fresh, model, new_w, pre, V, dev)
    del fresh, new_w
    gc.collect()
    peak_a = torch.cuda.max_memory_allocated() if cuda else 0
    a.update(p23_donate(trainer, engine, dev))
    a["swap_after_donate_version"] = engine.swap_weights(engine.weights)
    print("rollout-bridge " + json.dumps({
        **a, "train_2_steps_s": a_train_s, "nvidia_smi": smi_line() if cuda else "cpu"}),
        flush=True)
    print("rollout-swap " + json.dumps(b), flush=True)
    fe = engine.serving_frontend()
    c = p23_traffic(trainer, engine, fe, model, batches[2], V, dev)
    print("rollout-traffic " + json.dumps(c), flush=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    entries0 = engine.step_cache_entries()
    losses, collated, d = p23_loop(trainer, fe, V, dev)
    fe.close()
    if engine.step_cache_entries() != entries0:
        raise AssertionError("phase 23 (d): the loop's swaps added step-cache entries")
    del fe, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    h = p23_hybrid(trainer, model, batches[3:5], V, dev)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    missing = [k for k in ("flash_packed", "paged_chunk", "paged_decode") + K1_NAMES
               if not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 23: kernels not launched on the main path: {missing}")
    peak = max(peak_a, torch.cuda.max_memory_allocated()) / 2 ** 30 if cuda else None
    # the replay: a trainer rebuilt from the seed over the same batches, the
    # first trainer freed first
    del trainer, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    replay = p23_replay(cfg, batches[:3] + collated, dev)[3:]
    same = np.asarray(replay, np.float32).tobytes() == np.asarray(losses, np.float32).tobytes()
    print(f"phase 23 (d) loop losses {losses} vs replay {replay}, bitwise {same}", flush=True)
    if not same:
        raise AssertionError("phase 23 (d): the loop's losses differ from the replay's")
    print("rollout " + json.dumps({
        "phase": 23, "model": "Llama-2-7B", "layers": cfg.num_hidden_layers,
        "params": n_params, "loop": d, "hybrid": h, "replay_bitwise": same,
        "launches": {k: launches.get(k, 0) for k in P23_NAMES}, "peak_gib": peak,
        "nvidia_smi": smi_line() if cuda else "cpu"}), flush=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 24: the offload tier (host and NVMe optimizer state, activation
# offload) training all 32 layers of Llama-2-7B
# --------------------------------------------------------------------------- #

P24_LAYERS = 32
P24_T = 4096
P24_STEPS = 4             # (a): the first cold, the rest timed warm
P24_HEADROOM = 1.25       # the host must hold the host state this many times over
P24_POOL = 4              # host-kernel workers of (a)'s last, uncounted step
P24_STAGING = 4 * 10 ** 9  # pinned staging and the process's own growth, bytes
P24_DEVICE_FLOW_MAX = 20 * 10 ** 9   # device bytes of state the twin flow may add
P24_CONFIG = {
    "train_batch_size": 2, "train_micro_batch_size_per_gpu": 1,
    "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 0,
    "zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}},
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "betas": [0.9, 0.95],
                                              "eps": 1e-8, "weight_decay": 0.1}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0, "warmup_max_lr": 3e-4,
                                                 "warmup_num_steps": 2}},
}
P24_NOOFFLOAD_GB = 121.0  # bf16 params + fp32 master + AdamW moments + fp32 grads, 7B
P24_B_SMALL = {}          # GPT2Config overrides of (b)'s model (none: phase 5's)
P24_B_STEPS = 6
P24_B_RESUME_AT = 3
P24_C_LAYERS = 2
P24_D_PROMPTS = (700, 900)
P24_D_NEW = 16
P24_ENGINE = {"kv_cache": {"block_size": 128, "num_blocks": 24},
              "state_manager": {"max_context": 2048}, "seed": 0}
P24_DISK_PROBE = 1 << 30  # bytes written and read back to rate the NVMe directory
P24_D_NAMES = ("flash_packed", "paged_decode")


def p24_meminfo() -> dict:
    """MemTotal and MemAvailable in bytes (``/proc/meminfo``), the memory
    limit and usage of this process's cgroup where one is set (v2's
    ``memory.max`` / ``memory.current``, v1's ``memory.limit_in_bytes`` /
    ``memory.usage_in_bytes``), and ``avail``: the least of MemAvailable
    and the cgroup's room."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(rest.split()[0]) * 1024
    out["avail"] = out.get("MemAvailable", 0)
    try:
        with open("/proc/self/cgroup") as f:
            lines = [ln.strip().split(":", 2) for ln in f if ln.strip()]
    except OSError:
        lines = []
    for _, ctrl, rel in lines:
        if ctrl == "":
            base, names = os.path.join("/sys/fs/cgroup", rel.lstrip("/")), \
                ("memory.max", "memory.current")
        elif "memory" in ctrl.split(","):
            base, names = os.path.join("/sys/fs/cgroup/memory", rel.lstrip("/")), \
                ("memory.limit_in_bytes", "memory.usage_in_bytes")
        else:
            continue
        try:
            with open(os.path.join(base, names[0])) as f:
                limit = f.read().strip()
            with open(os.path.join(base, names[1])) as f:
                current = int(f.read().strip())
        except (OSError, ValueError):
            continue
        if limit.isdigit() and int(limit) < out.get("MemTotal", 0):
            out["cgroup_max"], out["cgroup_current"] = int(limit), current
            out["avail"] = min(out["avail"], int(limit) - current)
    return out


def p24_fstype(path: str) -> str:
    """The filesystem type of the mount holding ``path`` (``/proc/mounts``,
    longest mount point that prefixes it)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            mnt = parts[1]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return kind


def p24_nvme_dir() -> str:
    """A temporary directory on a real disk: the system temp dir unless it
    is memory-backed, else one in the checkout."""
    import tempfile
    for root in (tempfile.gettempdir(), os.path.dirname(os.path.abspath(__file__))):
        if p24_fstype(root) not in ("tmpfs", "ramfs"):
            return tempfile.mkdtemp(prefix="chip_smoke_p24_", dir=root)
    return tempfile.mkdtemp(prefix="chip_smoke_p24_")


def p24_disk_rates(root: str) -> dict:
    """Write then read ``P24_DISK_PROBE`` bytes through the port's AIO
    handle (O_DIRECT asked for, 1 MiB blocks) and report the rates, and
    whether the directory takes O_DIRECT at all (the handle falls back to
    buffered IO without a word where it does not). The read follows the
    write, so it may come from the page cache: the rate is a warm one."""
    from deepspeed_tpu_torch.ops.native import AsyncIOHandle, aligned_empty
    path = os.path.join(root, "probe.bin")
    direct = True
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | getattr(os, "O_DIRECT", 0), 0o644)
        os.close(fd)
    except OSError:
        direct = False
    buf = aligned_empty(P24_DISK_PROBE, np.uint8)
    buf[:] = 7
    h = AsyncIOHandle(block_size=1 << 20, thread_count=8, use_o_direct=True)
    t0 = time.perf_counter()
    if h.async_pwrite(buf, path) != 0 or h.wait() != 1:
        raise AssertionError("phase 24 (b): the disk probe's write failed")
    os.sync()
    t1 = time.perf_counter()
    back = aligned_empty(P24_DISK_PROBE, np.uint8)
    if h.async_pread(back, path) != 0 or h.wait() != 1:
        raise AssertionError("phase 24 (b): the disk probe's read failed")
    t2 = time.perf_counter()
    h.close()
    ok = bool((back == 7).all())
    os.unlink(path)
    if not ok:
        raise AssertionError("phase 24 (b): the disk probe read back other bytes")
    return {"o_direct": direct, "write_GBps": P24_DISK_PROBE / (t1 - t0) / 1e9,
            "read_GBps_warm": P24_DISK_PROBE / (t2 - t1) / 1e9}


def p24_host_line(nvme_root: str, cuda: bool) -> dict:
    mem = p24_meminfo()
    out = {**mem, "cpu_count": os.cpu_count(), "nvme_dir": nvme_root,
           "nvme_fstype": p24_fstype(nvme_root),
           "nvidia_smi": smi_line() if cuda else "cpu"}
    print("phase 24 host " + json.dumps(out), flush=True)
    return out


def p24_placement(cfg, avail: int) -> tuple:
    """(placement, layers, ratio, why): the first of (1) all layers with
    every leaf's master and moments on the host, (2) all layers with the
    twin flow's ``ratio`` < 1 so that the host share fits, (3) the deepest
    depth that fits, that the host holds with ``P24_HEADROOM``."""
    def params(layers):
        h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        kv = cfg.num_key_value_heads * cfg.head_dim
        per = 2 * h * h + 2 * h * kv + 3 * h * f + 2 * h
        return 2 * v * h + h + layers * per

    budget = avail / P24_HEADROOM - P24_STAGING
    n = params(cfg.num_hidden_layers)
    need = 12 * n    # fp32 master + AdamW's two moments
    if need <= budget:
        return 1, cfg.num_hidden_layers, 1.0, (
            f"(host state {need / 1e9:.1f} GB + staging {P24_STAGING / 1e9:.1f} GB) x "
            f"{P24_HEADROOM} fits the host's {avail / 1e9:.1f} GB")
    ratio = max(0.0, budget / need)
    if (1 - ratio) * need <= P24_DEVICE_FLOW_MAX:
        return 2, cfg.num_hidden_layers, ratio, (
            f"(host state {need / 1e9:.1f} GB + staging {P24_STAGING / 1e9:.1f} GB) x "
            f"{P24_HEADROOM} exceeds the host's {avail / 1e9:.1f} GB; ratio {ratio:.4f} keeps "
            f"{(1 - ratio) * need / 1e9:.1f} GB of state on the card")
    layers = cfg.num_hidden_layers
    while layers > 1 and 12 * params(layers) > budget:
        layers -= 1
    return 3, layers, 1.0, (
        f"the twin flow would keep {(1 - ratio) * need / 1e9:.1f} GB on the card; "
        f"{layers} layers' host state fits the host's {avail / 1e9:.1f} GB")


def p24_train_main(dev, cuda: bool, host: dict, cfg=None, T: int = P24_T) -> tuple:
    """(a): Llama-2-7B at full width on the placement the host allows,
    AdamW's state on the host; returns (trainer, model, cfg, out)."""
    import dataclasses

    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    base = cfg or LlamaConfig.llama2_7b(num_hidden_layers=P24_LAYERS, dtype=torch.bfloat16,
                                        remat=True, remat_policy="none")
    placement, layers, ratio, why = p24_placement(base, host["avail"])
    cfg = dataclasses.replace(base, num_hidden_layers=layers)
    print(f"phase 24 (a) placement {placement}: {layers} layers, ratio {ratio:.4f} ({why})",
          flush=True)
    config = json.loads(json.dumps(P24_CONFIG))
    config["zero_optimization"]["offload_optimizer"]["ratio"] = ratio
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    trainer, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device=dev)
    p23_sync(dev)
    init_s = time.perf_counter() - t0
    off = trainer._offload
    n_params = sum(p.numel() for p in trainer.state["params"].values())
    n_host = sum(int(np.prod(s)) for meta in trainer._offload_group_meta for _, _, _, s in meta)
    if off.kernel.backend != "openmp":
        raise AssertionError(f"phase 24 (a): host kernel backend {off.kernel.backend}")
    print(f"phase 24 (a) model: Llama-2-7B width (vocab {cfg.vocab_size}, hidden "
          f"{cfg.hidden_size}, FFN {cfg.intermediate_size}, {cfg.num_attention_heads}/"
          f"{cfg.num_key_value_heads} heads, D {cfg.head_dim}), {layers} layers, T {T}, "
          f"{n_params} params ({n_host} on the host, {len(trainer._offload_groups)} groups), "
          f"bf16 params on the card, AdamW on the host ({off.kernel.backend}, "
          f"{off._workers} workers), init {init_s:.1f} s", flush=True)
    V = cfg.vocab_size
    rng = np.random.default_rng(24)
    batch = {"input_ids": rng.integers(0, V, (P24_CONFIG["train_batch_size"], T))
             .astype(np.int32)}
    gas = P24_CONFIG["train_batch_size"] // P24_CONFIG["train_micro_batch_size_per_gpu"]
    marks = []
    real_step = trainer._offload_step

    def marked(wires, metrics):
        # the end of the step's device work, in the order the kernels queue
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        return real_step(wires, metrics)

    trainer._offload_step = marked
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, steps = [], []
    for i in range(P24_STEPS + 1):
        if i == P24_STEPS:
            # the last step, uncounted: a pool of P24_POOL workers sharing
            # the cores, against the default one worker with every core
            launches = {k: LAUNCHES.get(k, 0) for k in K1_NAMES}
            off._workers = P24_POOL
        trainer.offload_stats.reset()
        p23_sync(dev)
        start = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        loss = trainer.train_batch(batch)
        p23_sync(dev)
        wall = time.perf_counter() - t0
        st = trainer.offload_stats
        kernel_s = st.kernel_ms / 1e3
        row = {"step": i + 1, "workers": off._workers, "wall_ms": wall * 1e3,
               "device_ms": start.elapsed_time(marks[-1]) if cuda else None,
               "tokens_per_s": P24_CONFIG["train_batch_size"] * T / wall,
               "fetch_ms": st.fetch_ms, "kernel_ms": st.kernel_ms, "upload_ms": st.upload_ms,
               "groups": st.groups, "upload_depth": st.upload_depth_sum / max(1, st.groups),
               "host_kernel_GBps": 28 * n_host / kernel_s / 1e9 if kernel_s else None}
        if i < P24_STEPS:
            losses.append(float(loss))
        steps.append(row)
        print("phase 24 (a) step " + json.dumps(row), flush=True)
    trainer._offload_step = real_step
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    want = {"flash_fwd": 2 * layers * gas * P24_STEPS,
            "flash_bwd_dq": layers * gas * P24_STEPS, "flash_bwd_dkv": layers * gas * P24_STEPS}
    out = {"placement": placement, "layers": layers, "ratio": ratio, "params": n_params,
           "host_params": n_host, "losses": losses, "steps": steps,
           "k1_launches_a_step": {k: v / P24_STEPS for k, v in launches.items()},
           "peak_gib": peak, "no_offload_gb": P24_NOOFFLOAD_GB * n_params / 6.738e9,
           "init_s": init_s}
    print("phase 24 (a) " + json.dumps({k: v for k, v in out.items() if k != "steps"}),
          flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 24 (a): losses did not fall: {losses}")
    if cuda and launches != want:
        raise AssertionError(f"phase 24 (a): K1 launches {launches}, expected {want}")
    if cuda and peak >= 79.0:
        raise AssertionError(f"phase 24 (a): peak device memory {peak:.2f} GiB >= 79")
    return trainer, model, cfg, out


def p24_small(dev, offload, seed: int = 0):
    """Phase 5's GPT-2 small under ``offload`` (None: the device step)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    config = json.loads(json.dumps(TRAIN_CONFIG))
    config["zero_optimization"] = {"stage": 1}
    if offload is not None:
        config["zero_optimization"]["offload_optimizer"] = offload
    model = GPT2LMHead(GPT2Config(dtype=torch.bfloat16, **P24_B_SMALL), device=dev, seed=seed)
    return deepspeed_tpu_torch.initialize(model=model, config=config, device=dev)[0]


def p24_masters(engine) -> dict:
    """The full fp32 master on the host: device flow and host flow."""
    model_flat, _ = engine.checkpoint_flats()
    return model_flat


def p24_same(label: str, a, b) -> None:
    same = np.asarray(a, np.float32).tobytes() == np.asarray(b, np.float32).tobytes()
    print(f"phase 24 {label}: {list(map(float, a))} vs {list(map(float, b))}, bitwise {same}",
          flush=True)
    if not same:
        raise AssertionError(f"phase 24 {label}: loss streams differ")


def p24_same_masters(label: str, a: dict, b: dict) -> None:
    bad = [k for k in a if a[k].tobytes() != b[k].tobytes()]
    if bad or set(a) != set(b):
        raise AssertionError(f"phase 24 {label}: masters differ in {bad[:4]}")


def p24_close(label: str, a, b, rtol: float = 2e-3) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    print(f"phase 24 {label}: max rel diff {err:.3e} (rtol {rtol})", flush=True)
    if not err <= rtol:
        raise AssertionError(f"phase 24 {label}: {a} vs {b}")
    return err


def p24_orchestrations(dev, cuda: bool, nvme_root: str) -> dict:
    """(b): GPT-2 small (phase 5's model and batch), 6 steps under each
    orchestration; byte gates between them, rtol 2e-3 against the device
    step, two DPU runs bitwise, and offload tags resumed both ways."""
    import gc
    import shutil

    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    small = GPT2Config(**P24_B_SMALL)
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, small.vocab_size, (TRAIN_CONFIG["train_batch_size"], small.n_positions))
        .astype(np.int32)}
    out = {}

    def run(offload, steps=P24_B_STEPS, engine=None):
        engine = engine or p24_small(dev, offload)
        losses = [float(engine.train_batch(batch)) for _ in range(steps)]
        return engine, losses

    def free(*engines):
        for e in engines:
            e.destroy()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    base, l_dev = run(None)
    free(base)
    serial_cfg = {"device": "cpu", "overlap_step": False}
    pipe_cfg = {"device": "cpu", "host_workers": 4, "group_size": 4}
    nvme_cfg = {"device": "nvme", "nvme_path": os.path.join(nvme_root, "swap"),
                "pipeline_read": True, "pipeline_write": True}
    e_s, l_s = run(serial_cfg)
    m_s = p24_masters(e_s)
    free(e_s)
    e_p, l_p = run(pipe_cfg)
    m_p = p24_masters(e_p)
    free(e_p)
    t0 = time.perf_counter()
    e_n, l_n = run(nvme_cfg)
    nvme_s = time.perf_counter() - t0
    swap_ms = e_n.offload_stats.swap_ms / max(1, e_n.offload_stats.steps)
    m_n = p24_masters(e_n)
    free(e_n)
    p24_same("(b) serial vs pipeline", l_p, l_s)
    p24_same("(b) serial vs nvme", l_n, l_s)
    p24_same_masters("(b) serial vs pipeline", m_p, m_s)
    p24_same_masters("(b) serial vs nvme", m_n, m_s)
    for label, got in (("serial", l_s), ("pipeline", l_p), ("nvme", l_n)):
        out[f"rel_{label}"] = p24_close(f"(b) {label} vs the device step", got, l_dev)
    dpu = []
    for _ in range(2):
        e, l = run({"device": "cpu", "delayed_param_update": True})
        dpu.append((l, p24_masters(e)))
        free(e)
    p24_same("(b) DPU run 1 vs run 2", dpu[1][0], dpu[0][0])
    p24_same_masters("(b) DPU run 1 vs run 2", dpu[1][1], dpu[0][1])
    out["dpu_losses"] = dpu[0][0]
    out["dpu_rel_last"] = abs(dpu[0][0][-1] - l_s[-1]) / l_s[-1]

    # checkpoints: offload -> fresh offload (bitwise), offload <-> plain (rtol)
    ck = os.path.join(nvme_root, "ckpt")
    k = P24_B_RESUME_AT
    a, _ = run(pipe_cfg, steps=k)
    a.save_checkpoint(ck, tag="off")
    _, tail_a = run(None, steps=P24_B_STEPS - k, engine=a)
    free(a)
    b = p24_small(dev, pipe_cfg, seed=1)
    b.load_checkpoint(ck, tag="off")
    _, tail_b = run(None, steps=P24_B_STEPS - k, engine=b)
    free(b)
    p24_same("(b) offload tag resumed in a fresh offload engine", tail_b, tail_a)
    c = p24_small(dev, None, seed=1)
    c.load_checkpoint(ck, tag="off")
    _, tail_c = run(None, steps=P24_B_STEPS - k, engine=c)
    out["rel_offload_tag_in_plain"] = p24_close("(b) offload tag in a plain engine", tail_c, tail_a)
    c.save_checkpoint(ck, tag="plain")
    free(c)
    d = p24_small(dev, pipe_cfg, seed=1)
    d.load_checkpoint(ck, tag="plain")
    _, tail_d = run(None, steps=P24_B_STEPS - k, engine=d)
    free(d)
    e = p24_small(dev, None, seed=1)
    e.load_checkpoint(ck, tag="plain")
    _, tail_e = run(None, steps=P24_B_STEPS - k, engine=e)
    free(e)
    out["rel_plain_tag_in_offload"] = p24_close("(b) plain tag in an offload engine",
                                               tail_d, tail_e)
    shutil.rmtree(ck, ignore_errors=True)
    out["disk"] = p24_disk_rates(nvme_root)
    out["nvme"] = {"swap_ms_a_step": swap_ms, "run_s": nvme_s,
                   "fstype": p24_fstype(nvme_root)}
    out["losses"] = {"device": l_dev, "serial": l_s}
    print("phase 24 (b) " + json.dumps(out), flush=True)
    return out


def p24_activation_offload(dev, cuda: bool, base_cfg=None, T: int = P24_T) -> dict:
    """(c): two layers of Llama-2-7B width at T 4096, one micro-batch: each
    host-offload policy's grads against its saving policy's, bit for bit,
    with both peaks and the bytes sent to the host."""
    import dataclasses
    import gc

    import torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
    base = base_cfg or LlamaConfig.llama2_7b(dtype=torch.bfloat16)
    base = dataclasses.replace(base, num_hidden_layers=P24_C_LAYERS, remat=True)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, base.vocab_size, (1, T)).astype(np.int64)).to(dev)

    def grads(policy, cpu_checkpointing=False):
        ac.configure(checkpoint_in_cpu=cpu_checkpointing)
        model = LlamaForCausalLM(dataclasses.replace(base, remat_policy=policy), device=dev,
                                 seed=0)
        params = model.named_flat_parameters()
        for p in params.values():
            p.requires_grad_(True)
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        ac.OFFLOAD_STATS.update(tensors=0, bytes=0)
        loss = model({"input_ids": ids})
        g = torch.autograd.grad(loss, list(params.values()))
        p23_sync(dev)
        peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30 if cuda else 0.0
        moved = dict(ac.OFFLOAD_STATS)
        out = [x.detach().clone() for x in g]
        del model, params, loss, g
        ac.reset()
        return out, peak, moved

    rows = {}
    for off, saving, cpu_ck in (("offload_dots", "dots_with_no_batch_dims_saveable", False),
                                ("offload_attn_out", "attn_out_saveable", False),
                                (None, "offload_dots", True)):
        g_off, peak_off, moved = grads(off, cpu_ck)
        g_save, peak_save, _ = grads(saving)
        same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(g_off, g_save))
        label = "cpu_checkpointing" if cpu_ck else off
        rows[label] = {"against": saving, "bitwise": same, "peak_gib": peak_off,
                       "peak_saving_gib": peak_save, "host_tensors": moved["tensors"],
                       "host_bytes": moved["bytes"]}
        print(f"phase 24 (c) {label} vs {saving}: " + json.dumps(rows[label]), flush=True)
        if not same:
            raise AssertionError(f"phase 24 (c): {label}'s grads differ from {saving}'s")
        if moved["tensors"] == 0:
            raise AssertionError(f"phase 24 (c): {label} moved nothing to the host")
        # a policy against itself (cpu_checkpointing -> offload_dots) moves the
        # same bytes; an offload policy against its saving one keeps at least
        # half of one layer's saved bytes off the card at the peak
        if cuda and not cpu_ck and not (peak_save - peak_off) * 2 ** 30 >= \
                moved["bytes"] / (2 * P24_C_LAYERS):
            raise AssertionError(f"phase 24 (c): {label}'s peak {peak_off:.3f} GiB is not "
                                 f"below {saving}'s {peak_save:.3f} GiB by the saved bytes")
        del g_off, g_save
    return rows


def p24_serve(trainer, model, cfg, dev, cuda: bool) -> dict:
    """(d): the policy (a) trained, served: ``rollout_source_params()``
    drains and returns the bf16 params; a v2 engine takes one
    ``weight_bridge(trainer).sync()``; its tree against an engine built
    from the drained params, bit for bit, and 2 prompts x 16 greedy tokens
    through K2 and the decode kernel on both."""
    import torch
    from deepspeed_tpu_torch.checkpoint.state import flatten_tree
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.ops import kernels
    src = trainer.rollout_source_params()
    if any(t.dtype != cfg.dtype for t in src.values()):
        raise AssertionError("phase 24 (d): the offload engine's source is not its params")
    # the engines keep the tensors they are given: views without autograd
    engine = InferenceEngineV2(model, P24_ENGINE, {k: t.detach() for k, t in src.items()},
                               device=dev)
    bridge = engine.weight_bridge(trainer, donate=False)
    new_w = bridge.sync()
    engine.swap_weights(new_w)
    fresh = InferenceEngineV2(model, P24_ENGINE, {k: t.detach() for k, t in
                                                  trainer.rollout_source_params().items()},
                              device=dev)
    a, b = flatten_tree(engine.weights), flatten_tree(fresh.weights)
    bad = [k for k in b if k not in a or not torch_equal_bits(a[k], b[k])]
    if bad or set(a) != set(b):
        raise AssertionError(f"phase 24 (d): the bridged tree differs in {bad[:4]}")
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in P24_D_PROMPTS]
    kernels.reset_launches()
    got = engine.generate(prompts, max_new_tokens=P24_D_NEW)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    with p23_uncounted():
        want = fresh.generate(prompts, max_new_tokens=P24_D_NEW)
    same = [list(x) == list(y) for x, y in zip(got, want)]
    print(f"phase 24 (d) streams equal {same}; launches " + json.dumps(launches), flush=True)
    if not all(same):
        raise AssertionError("phase 24 (d): the bridged engine's streams differ")
    missing = [k for k in P24_D_NAMES if cuda and not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 24 (d): kernels not launched: {missing}")
    del engine, fresh, new_w
    return {"tree_bitwise": True, "streams_equal": True, "launches": launches}


def run_offload(dev="cuda", cfg=None, T: int = P24_T):
    """Phase 24: the offload tier on one card. (a) Llama-2-7B at full
    width and depth (on the placement the host allows), bf16 params on the
    card, the fp32 master and AdamW's moments on the host, stepped by the
    native OpenMP kernels through the group pipeline; (b) the
    orchestrations on GPT-2 small, byte for byte; (c) activation offload
    against the saving policies; (d) the trained policy served through the
    bridge. Returns the launches of (a) and (d)."""
    import gc
    import shutil

    import torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.native import builder
    t_phase = time.perf_counter()
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gc.collect()
        torch.cuda.empty_cache()
        empty_host = getattr(torch._C, "_host_emptyCache", None)
        if empty_host is not None:
            empty_host()
    builder.load_native()
    print(f"phase 24 native build: {builder.last_build_seconds:.1f} s, flags "
          f"{builder.built_flags}", flush=True)
    nvme_root = p24_nvme_dir()
    try:
        host = p24_host_line(nvme_root, cuda)
        trainer, model, tcfg, a = p24_train_main(dev, cuda, host, cfg, T)
        launches = {k: kernels.LAUNCHES.get(k, 0) for k in K1_NAMES}
        launches.update({k: v for k, v in zip(K1_NAMES, (
            a["k1_launches_a_step"][k] * P24_STEPS for k in K1_NAMES))})
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        d = p24_serve(trainer, model, tcfg, dev, cuda)
        # K5 runs the longer prompt's second chunk: its row shows the count too
        launches.update({k: d["launches"].get(k, 0) for k in P24_D_NAMES + ("paged_chunk",)})
        trainer.destroy()
        del trainer, model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_b = time.perf_counter()
        b = p24_orchestrations(dev, cuda, nvme_root)
        b_s = time.perf_counter() - t_b
        t_c = time.perf_counter()
        c = p24_activation_offload(dev, cuda, base_cfg=cfg, T=T)
        c_s = time.perf_counter() - t_c
    finally:
        shutil.rmtree(nvme_root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print("offload " + json.dumps({
        "phase": 24, "placement": a["placement"], "layers": a["layers"], "ratio": a["ratio"],
        "peak_gib": a["peak_gib"], "b_s": b_s, "c_s": c_s, "seconds": seconds,
        "launches": launches, "nvidia_smi": host["nvidia_smi"]}), flush=True)
    print(f"phase 24: {seconds:.1f} s", flush=True)
    return {k: int(v) for k, v in launches.items()}


# --------------------------------------------------------------------------- #
# phase 25: observability and resilience
# --------------------------------------------------------------------------- #

P25_STEPS = 5             # (a): a run's steps; the first is cold (and profiled)
P25_WCB_STEPS = 2         # (a): facade steps under wall_clock_breakdown
P25_OVERHEAD = 0.05       # traced / everything-on median step wall, at most +5%
P25_PROFILE_FORWARDS = 5  # the profiler's forwards: hooked, counted, 3 timed
P25_PROMPTS = 8
P25_LENS = (128, 1024)    # (b): prompt lengths, inclusive
P25_NEW = 64
P25_BUSY_STEPS = 16       # (b): the profiled run that reads the busy share
# decode_splits 2 so the engine chooses a rung each step (a one-rung ladder
# chooses nothing and records no select, as in the JAX package); a split
# needs 8192 tokens of context, more than any sequence here has, so every
# choice is rung 1 and no split-K kernel runs
P25_ENGINE = {**P17_POOL, "attention": {"decode_splits": 2, "min_ctx_per_split": 8192}}
P25_C_STEPS = 6
P25_C_ROLLING = {"engine": "async", "writers": 2,
                 "rolling": {"every_n_steps": 2, "keep_last": 1, "max_pending": 1}}
P25_PIPELINE_FIELDS = ("steps", "tokens", "dispatch_ms_per_step", "host_build_ms_per_step",
                       "fetch_drain_ms_per_step", "bubble_ms_per_step", "fetch_bytes_per_step")


class P25Sink:
    """A monitor backend that keeps every event it is given."""

    def __init__(self):
        self.events = []

    def write_events(self, events):
        self.events.extend(events)


class P25SyncProbe:
    """Counts the synchronizing CUDA calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports while it is entered,
    by thread, split into those inside the training engine's policed drain
    (``runtime.engine._to_host``) and the rest, with the rest's source
    lines. A step that makes no sync outside the drain leaves the host free
    to queue the next step while the device runs this one."""

    def __init__(self):
        import threading
        self.drain = 0
        self.other = 0              # on the thread that entered the probe
        self.other_threads = 0
        self.where = collections.Counter()
        self._local = threading.local()
        self._main = threading.get_ident()

    def __enter__(self):
        import threading
        import warnings

        import torch
        from deepspeed_tpu_torch.runtime import engine as engine_mod
        self._engine_mod, self._to_host = engine_mod, engine_mod._to_host
        local = self._local

        def to_host(tree):
            local.depth = getattr(local, "depth", 0) + 1
            try:
                return self._to_host(tree)
            finally:
                local.depth -= 1

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchronizing" not in str(message):
                return self._show(message, category, filename, lineno, file, line)
            if getattr(local, "depth", 0):
                self.drain += 1
                return
            if threading.get_ident() == self._main:
                self.other += 1
            else:
                self.other_threads += 1
            self.where[f"{'/'.join(filename.split(os.sep)[-2:])}:{lineno}"] += 1

        engine_mod._to_host = to_host
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode("default")
        self._warnings.__exit__(*exc)
        self._engine_mod._to_host = self._to_host
        return False

    def line(self) -> dict:
        return {"drain": self.drain, "other": self.other,
                "other_threads": self.other_threads, "where": dict(self.where)}


def p25_trace_check(label: str, trace_dir: str, require) -> str:
    """``scripts/trace_check.py`` over a part's trace directory, as a
    subprocess; prints its output and fails unless it exits 0."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "trace_check.py")
    r = subprocess.run([sys.executable, script, trace_dir, "--require", *require],
                       capture_output=True, text=True, timeout=120)
    text = (r.stdout + r.stderr).strip()
    print(f"phase 25 {label} trace_check --require {' '.join(require)}: rc {r.returncode}: "
          f"{text}", flush=True)
    if r.returncode != 0:
        raise AssertionError(f"phase 25 {label}: trace_check exited {r.returncode}")
    return text


def p25_span_ms(name: str) -> list:
    """Durations (ms) of the tracer's retained ``name`` spans, from its
    rings (the perf_counter stamps, not the exported microseconds)."""
    from deepspeed_tpu_torch.monitor.trace import tracer
    return [1e3 * (r[3] - r[2]) for r in tracer.iter_records()
            if r[1] == name and r[3] is not None]


def p25_median_gate(label: str, on: list, off: list, gate: bool = True) -> float:
    ratio = float(np.median(on)) / float(np.median(off))
    print(f"phase 25 {label}: median step wall {float(np.median(on)):.3f} ms on vs "
          f"{float(np.median(off)):.3f} ms off, ratio {ratio:.4f} (limit "
          f"{1 + P25_OVERHEAD})", flush=True)
    if gate and ratio > 1 + P25_OVERHEAD:
        raise AssertionError(f"phase 25 {label}: overhead {ratio - 1:.2%} past "
                             f"{P25_OVERHEAD:.0%}")
    return ratio


def p25_llama_flops(cfg, B: int, T: int) -> int:
    """The forward's closed form: 2 x every matmul's MACs (q, k, v, o, the
    gated MLP, the head over the T - 1 labelled positions) plus K1's
    4 * B * H * T * T * D a layer."""
    hid, D, L = cfg.hidden_size, cfg.head_dim, cfg.num_hidden_layers
    H, Hkv, ff = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.intermediate_size
    layer = B * T * (2 * hid * H * D + 2 * hid * Hkv * D + 3 * hid * ff)
    head = B * (T - 1) * cfg.vocab_size * hid
    return 2 * (L * layer + head) + L * 4 * B * H * T * T * D


def p25_train_run(cfg, rows, dev, extra: dict):
    """One phase 20 trainer over ``rows`` (seed 0), ``P25_STEPS`` steps from
    its own pipeline. Returns (engine, losses, device step walls of steps
    2.., K1 launches, the sync probe's counts over steps 2..): a CUDA event
    recorded after each ``train_batch`` returns marks where the stream
    finished that step, so the walls need no extra host sync."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    cuda = dev.type == "cuda"
    engine = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(cfg, device=dev, seed=0), training_data=rows,
        config={**P20_CONFIG, **extra}, device=dev)[0]
    p19_sync(dev)
    reset_launches()
    losses, marks = [], []
    probe = P25SyncProbe()

    def step():
        losses.append(engine.train_batch())
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    step()
    if cuda:
        with probe:
            for _ in range(P25_STEPS - 1):
                step()
    else:
        for _ in range(P25_STEPS - 1):
            step()
    engine.drain_metrics()
    p19_sync(dev)
    launches = {k: LAUNCHES.get(k, 0) for k in K1_NAMES}
    walls = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return (engine, np.array([float(x) for x in losses], np.float32), walls, launches,
            probe.line())


def p25_training(dev, cfg=None, T: int = P20_T) -> dict:
    """(a): phase 20's trainer twice from seed 0, everything off and then
    every sink on (CSV, the live exporter on port 0, the tracer, the flops
    profiler at step 1, a print every step); then 2 facade steps under
    ``wall_clock_breakdown``. Gates: bit-equal losses and masters, K1
    launches a step unchanged, the median warm step within 5%, the CSV and
    /metrics values against the losses, the stats against the spans, the
    counted flops against the closed form, trace_check."""
    import shutil
    import tempfile
    import urllib.request

    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.monitor import PrometheusExporter
    from deepspeed_tpu_torch.monitor.trace import tracer
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    cuda = dev.type == "cuda"
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=P20_LAYERS, dtype=torch.bfloat16,
                                       remat=True)
    gas = P20_CONFIG["train_batch_size"] // P20_CONFIG["train_micro_batch_size_per_gpu"]
    L = cfg.num_hidden_layers
    out, launches25 = {}, collections.Counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_p25a_")
    tracer.reset()
    try:
        rows = TokenRows(p20_dataset(root, cfg.vocab_size, P20_SEQS, T))
        # ---- run 1: everything off ---- #
        engine, off_losses, off_walls, off_k1, off_syncs = p25_train_run(cfg, rows, dev, {})
        launches25.update(off_k1)
        off_master = p20_master(engine, host=False)
        engine.destroy()
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        # ---- run 2: every sink on ---- #
        trace_dir = os.path.join(root, "trace")
        on = {"steps_per_print": 1,
              "csv_monitor": {"enabled": True, "output_path": root, "job_name": "p25"},
              "prometheus": {"enabled": True, "port": 0},
              "monitor": {"trace": {"dir": trace_dir}},
              "flops_profiler": {"enabled": True, "profile_step": 1,
                                 "output_file": os.path.join(root, "flops.txt")}}
        engine, on_losses, on_walls, on_k1, on_syncs = p25_train_run(cfg, rows, dev, on)
        launches25.update(on_k1)
        same = on_losses.tobytes() == off_losses.tobytes()
        print(f"phase 25 (a) losses on {on_losses.tolist()} vs off {off_losses.tolist()}, "
              f"bitwise {same}", flush=True)
        if not same:
            raise AssertionError("phase 25 (a): the sinks changed the loss stream")
        p20_same_master("phase 25 (a) on vs off", p20_master(engine, host=False), off_master)
        del off_master
        # K1: the same launches a step; the profiled forwards add theirs
        want_off = {"flash_fwd": 2 * L * gas * P25_STEPS, "flash_bwd_dq": L * gas * P25_STEPS,
                    "flash_bwd_dkv": L * gas * P25_STEPS}
        want_on = dict(want_off, flash_fwd=want_off["flash_fwd"] + P25_PROFILE_FORWARDS * L)
        print(f"phase 25 (a) K1 launches off {off_k1} on {on_k1} (the profiler's "
              f"{P25_PROFILE_FORWARDS} forwards add {P25_PROFILE_FORWARDS * L} fwd)", flush=True)
        if cuda and (off_k1 != want_off or on_k1 != want_on):
            raise AssertionError(f"phase 25 (a): K1 launches off {off_k1} on {on_k1}, "
                                 f"expected {want_off} and {want_on}")
        if cuda:
            out["overhead_ratio"] = p25_median_gate("(a) train", on_walls, off_walls)
            out["step_ms"] = {"off": off_walls, "on": on_walls}
            # the device walls hide host work while the launch queue is full:
            # the probe shows the sinks add no sync outside the one-step-late
            # drain, so the host stays a step ahead of the device
            out["syncs"] = {"off": off_syncs, "on": on_syncs}
            print(f"phase 25 (a) synchronizing calls over steps 2-{P25_STEPS} under "
                  f"set_sync_debug_mode('warn'): off {json.dumps(off_syncs)}, on "
                  f"{json.dumps(on_syncs)}", flush=True)
            if on_syncs["drain"] == 0:
                raise AssertionError("phase 25 (a): the probe saw no sync in the drain, so "
                                     "it shows nothing")
            if on_syncs["other"] > off_syncs["other"]:
                raise AssertionError(f"phase 25 (a): the sinks added syncs outside the drain: "
                                     f"{on_syncs['where']}")
        # the live exporter, then the CSV files, against the losses
        prom = engine.monitor.prom_monitor
        if prom.url is not None:
            with urllib.request.urlopen(prom.url, timeout=10) as resp:
                body = resp.read().decode()
            how = f"GET {prom.url}"
        else:
            # the bind failed (the exporter logged the OSError): the same
            # gate on render() of an exporter fed the same events
            bound = PrometheusExporter(type("Cfg", (), {"enabled": False})())
            bound.enabled = True
            bound.write_events([("Train/Samples/train_loss", float(on_losses[-1]),
                                 engine.global_samples)])
            body = bound.render()
            how = "render() (the bind failed; see the warning above)"
        line = next((l for l in body.splitlines()
                     if l.startswith("dstpu_Train_Samples_train_loss ")), None)
        print(f"phase 25 (a) exporter {how}: {line}", flush=True)
        if line is None or float(line.split()[1]) != float(on_losses[-1]):
            raise AssertionError(f"phase 25 (a): /metrics has no last loss ({line})")
        # the stats against the spans, from the tracer's rings
        st = engine.train_stats
        n_step = len(p25_span_ms("train/step"))
        disp, drain = sum(p25_span_ms("train/step/dispatch")), sum(p25_span_ms("train/step/drain"))
        print(f"phase 25 (a) stats vs spans: steps {st.steps} / {n_step}; dispatch "
              f"{st.dispatch_ms:.6f} / {disp:.6f} ms; drain {st.drain_ms:.6f} / {drain:.6f} ms",
              flush=True)
        if (st.steps != n_step or abs(disp - st.dispatch_ms) > 1e-3 * st.steps
                or abs(drain - st.drain_ms) > 1e-3 * st.steps):
            raise AssertionError("phase 25 (a): the step stats and spans differ")
        out["phases_ms_a_step"] = {k: v for k, v in
                                   ((n.rsplit("/", 1)[1], x) for n, x, _ in st.events())}
        print("phase 25 (a) train/pipeline " + json.dumps(out["phases_ms_a_step"]), flush=True)
        # the flops profile
        prof = engine.flops_profiler
        closed = p25_llama_flops(cfg, P20_CONFIG["train_micro_batch_size_per_gpu"], T)
        tflops = prof.counted_flops / prof.latency_s / 1e12
        out["flops"] = {"counted_tflop": prof.counted_flops / 1e12,
                        "closed_form_tflop": closed / 1e12, "latency_ms": prof.latency_s * 1e3,
                        "achieved_tflop_s": tflops, "peak_share": tflops * 1e12 / BF16_FLOPS_PER_S,
                        "params": prof.total_params, "macs": prof.total_macs}
        print("phase 25 (a) flops " + json.dumps(out["flops"]), flush=True)
        if int(prof.counted_flops) != closed:
            raise AssertionError(f"phase 25 (a): counted {prof.counted_flops} flops, closed "
                                 f"form {closed}")
        engine.destroy()     # drains, closes the sinks, exports the trace
        samples = engine.train_batch_size_
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        with open(os.path.join(root, "p25", "Train_Samples_train_loss.csv")) as f:
            csv_rows = [l.strip().split(",") for l in f][1:]
        want_rows = [[str(samples * (i + 1)), float(x)] for i, x in enumerate(on_losses)]
        got_rows = [[s, float(v)] for s, v in csv_rows]
        print(f"phase 25 (a) CSV train_loss rows {len(got_rows)}: "
              f"{got_rows == want_rows}", flush=True)
        if got_rows != want_rows:
            raise AssertionError(f"phase 25 (a): CSV rows {got_rows} vs losses {want_rows}")
        out["csv_files"] = sorted(os.listdir(os.path.join(root, "p25")))
        print(f"phase 25 (a) CSV files: {out['csv_files']}", flush=True)
        out["trace_check"] = p25_trace_check(
            "(a)", trace_dir, ("train/step", "train/drain", "train/prefetch"))
        tracer.reset()
        # ---- 2 facade steps under wall_clock_breakdown ---- #
        engine = deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(cfg, device=dev, seed=0), training_data=rows,
            config={**P20_CONFIG, "wall_clock_breakdown": True, "steps_per_print": 1},
            device=dev)[0]
        it = iter(RepeatingLoader(engine.training_dataloader))
        reset_launches()
        for _ in range(P25_WCB_STEPS):
            batch = next(it)
            for g in range(gas):
                loss = engine({k: v[g:g + 1] for k, v in batch.items()})
                engine.backward(loss)
                engine.step()
        engine.drain_metrics()
        launches25.update({k: LAUNCHES.get(k, 0) for k in K1_NAMES})
        out["timers_ms"] = engine.timers.get_mean(["fwd", "bwd", "step"])
        print("phase 25 (a) wall_clock_breakdown fwd/bwd/step ms a call " +
              json.dumps(out["timers_ms"]), flush=True)
        engine.destroy()
        del engine
    finally:
        tracer.reset()
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out, launches25


def p25_serve(model, dev) -> tuple:
    """(b): Llama-2-7B at all 32 layers behind a v2 engine (pages of 128,
    80 of them), 8 seeded prompts of 128-1024 tokens, 64 greedy tokens
    through the decode pipeline untraced, then again with the tracer on
    and a ``TelemetryPump`` over the engine into a live exporter, then two
    passes whose steps alternate traced and untraced. Gates:
    byte-identical streams, 64 ``serve/decode/step`` spans = the stats'
    steps, the drained row's bytes, one select a step, every
    ``inference/v2/pipeline/*`` field, the traced steps' median wall within
    5% of the untraced steps', trace_check; then a profiled run reads the
    busy share."""
    import shutil
    import tempfile
    import types

    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.monitor import PrometheusExporter, TelemetryPump
    from deepspeed_tpu_torch.monitor.trace import tracer
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.utils.caching import next_pow2
    cuda = dev.type == "cuda"
    V = model.config.vocab_size
    engine = InferenceEngineV2(model, P25_ENGINE, model.flat_params(), device=dev)
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, V, int(n)).astype(np.int32)
               for n in rng.integers(P25_LENS[0], P25_LENS[1] + 1, P25_PROMPTS)]
    uids = list(range(P25_PROMPTS))
    out = {"prompt_lens": [len(p) for p in prompts]}
    launches25 = collections.Counter()

    def serve(traced: bool, on_tokens=None):
        tracer.configure(enabled=traced)
        pump = TelemetryPump(exporter, [engine], interval_s=0.5).start() \
            if traced or on_tokens is not None else None
        kernels.reset_launches()
        engine.attn_stats.reset()
        engine.put(uids, prompts)
        selects_put = engine.attn_stats.selects
        engine.pipeline_stats.reset()
        toks = engine.decode_pipeline(uids).run(P25_NEW, on_tokens=on_tokens)
        p19_sync(dev)
        launches25.update({k: v for k, v in kernels.LAUNCHES.items() if v})
        st = engine.pipeline_stats
        snap = {"steps": st.steps, "walls": list(st.step_wall_ms),
                "fetch_bytes_per_step": st.fetch_bytes_per_step,
                "selects": engine.attn_stats.selects - selects_put,
                "events": {n.rsplit("/", 1)[1]: v for n, v, _ in st.events()},
                "launches": {k: v for k, v in kernels.LAUNCHES.items() if v}}
        engine.flush(uids)
        if pump is not None:
            pump.close()
        return toks, snap

    root = tempfile.mkdtemp(prefix="chip_smoke_p25b_")
    trace_dir = os.path.join(root, "trace")
    tracer.reset()
    exporter = PrometheusExporter(types.SimpleNamespace(
        enabled=True, addr="127.0.0.1", port=0, prefix="dstpu", output_path="",
        job_name=""))
    try:
        print(f"phase 25 (b) exporter: "
              f"{exporter.url or 'bind failed (see the warning above): pump only'}", flush=True)
        ref, off = serve(False)
        # the traced passes: the tracer on and a TelemetryPump over the
        # engine into the live exporter
        tracer.configure(trace_dir=trace_dir, enabled=True)
        got, on = serve(True)
        summary = tracer.summary()
        same = np.array_equal(got, ref)
        print(f"phase 25 (b) streams traced vs untraced byte-identical: {same}", flush=True)
        if not same:
            raise AssertionError("phase 25 (b): tracing changed the token streams")
        bucket = next_pow2(P25_PROMPTS)
        n_step = summary.get("serve/decode/step", (0, 0.0))[0]
        n_select = summary.get("serve/attn/select", (0, 0.0))[0]
        sink = P25Sink()
        engine.write_monitor_events(sink)
        fields = {n for n, _, _ in sink.events}
        print(f"phase 25 (b) serve/decode/step {n_step}, stats steps {on['steps']}, fetch "
              f"bytes a step {on['fetch_bytes_per_step']} (4 x bucket {bucket}), selects "
              f"{on['selects']} in the run ({n_select} spans with the passes'), drain spans "
              f"{summary.get('serve/drain/fetch_to_host', (0, 0))[0]}, exporter "
              f"{len(exporter._values)} names", flush=True)
        missing = [f for f in P25_PIPELINE_FIELDS if f"inference/v2/pipeline/{f}" not in fields]
        if (n_step != on["steps"] or on["steps"] != P25_NEW
                or on["fetch_bytes_per_step"] != 4 * bucket or on["selects"] != P25_NEW
                or n_select != engine.attn_stats.selects
                or "serve/drain/fetch_to_host" not in summary or missing):
            raise AssertionError(f"phase 25 (b): stats and spans differ (missing fields "
                                 f"{missing})")
        if cuda and on["launches"].get("paged_splitk"):
            raise AssertionError("phase 25 (b): a split-K kernel ran at rung 1")
        out["launches"] = on["launches"]
        out["phases_ms_a_step"] = on["events"]
        print("phase 25 (b) inference/v2/pipeline " + json.dumps(on["events"]), flush=True)
        if cuda:
            out["pass_ratio"] = p25_median_gate("(b) decode, pass 2 vs pass 1", on["walls"][1:],
                                                off["walls"][1:], gate=False)
            # host-bound steps spread between passes (the host's cores are
            # shared), so the gate compares neighbouring steps: two passes
            # whose steps alternate traced and untraced, one starting each
            # way, with the pump on throughout
            walls = {True: [], False: []}
            for first in (True, False):
                states = []

                def flip(j, _uids, _row):
                    # nothing is traced in a step after its callback: the
                    # state set here holds over the next step
                    states.append(tracer.enabled)
                    tracer.configure(enabled=not tracer.enabled)

                toks, snap = serve(first, on_tokens=flip)
                if not np.array_equal(toks, ref):
                    raise AssertionError("phase 25 (b): an alternating pass changed the "
                                         "token streams")
                for traced, w in list(zip(states, snap["walls"]))[1:]:
                    walls[traced].append(w)
            out["overhead_ratio"] = p25_median_gate(
                f"(b) decode, alternating steps ({len(walls[True])} traced, "
                f"{len(walls[False])} untraced)", walls[True], walls[False])
        tracer.configure(enabled=True)
        tracer.export()
        out["trace_check"] = p25_trace_check("(b)", trace_dir,
                                             ("serve/decode", "serve/drain", "serve/attn"))
        tracer.reset()
        if cuda:
            engine.put(uids, prompts)
            engine.pipeline_stats.reset()
            out["profile"] = device_breakdown(
                f"phase 25 (b) decode ({P25_PROMPTS} rows, {P25_BUSY_STEPS} steps, 32 layers)",
                lambda: engine.decode_pipeline(uids).run(P25_BUSY_STEPS),
                names=("paged_decode",))
            out["profile"]["steps"] = engine.pipeline_stats.steps
            engine.flush(uids)
    finally:
        exporter.close()
        tracer.reset()
        shutil.rmtree(root, ignore_errors=True)
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out, launches25


def p25_checkpoint(dev, cfg=None, config=None) -> tuple:
    """(c): phase 19's model and batches (GPT-2 small), the lock-order
    sanitizer armed before the engine is built, the tracer on, rolling
    async saves every 2 of 6 steps and one user save; then the same 6 steps
    untraced and unarmed without saves. Gates: bit-equal losses, every
    ``ckpt/*`` span, saves and commits against their spans, no lock cycle,
    trace_check."""
    import shutil
    import tempfile

    import torch
    from deepspeed_tpu_torch.checkpoint import state as ckpt_state
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from deepspeed_tpu_torch.monitor.trace import tracer
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, _loader, reset_launches
    from deepspeed_tpu_torch.utils import locksan
    cuda = dev.type == "cuda"
    cfg = cfg or GPT2Config(dtype=torch.bfloat16)
    config = config or TRAIN_CONFIG
    rows = config["train_batch_size"]
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (rows, cfg.n_positions))
                .astype(np.int32)} for _ in range(P25_C_STEPS)]
    out, launches25 = {}, collections.Counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_p25c_")
    trace_dir = os.path.join(root, "trace")
    tracer.reset()
    locksan.arm()
    try:
        ck = {**P25_C_ROLLING, "rolling": {**P25_C_ROLLING["rolling"],
                                           "save_dir": os.path.join(root, "rolling")}}
        engine = p19_engine(cfg, dev, 0, {**config, "checkpoint": ck,
                                          "monitor": {"trace": {"dir": trace_dir}}})
        reset_launches()
        losses, _ = p19_train(engine, batches, dev)
        launches25.update({k: LAUNCHES.get(k, 0) for k in K1_NAMES})
        engine._rolling.flush()
        st = engine.ckpt_stats
        summary = tracer.summary()
        counts = {n: summary.get(n, (0, 0.0))[0] for n in
                  ("ckpt/snapshot", "ckpt/backpressure", "ckpt/write", "ckpt/commit",
                   "ckpt/prune")}
        print(f"phase 25 (c) saves {st.saves} commits {st.commits}; spans {counts}",
              flush=True)
        if st.saves != counts["ckpt/snapshot"] or st.commits != counts["ckpt/commit"] \
                or not all(counts.values()):
            raise AssertionError("phase 25 (c): the checkpoint stats and spans differ")
        engine.save_checkpoint(os.path.join(root, "user"))
        if not tracer.summary().get("ckpt/save"):
            raise AssertionError("phase 25 (c): no ckpt/save span")
        engine.destroy()
        del engine
        rep = locksan.report()
        plain = {"checkpoint.latest": not isinstance(ckpt_state._latest_lock, locksan.SanLock),
                 "the kernel loader's": not isinstance(_loader._lib_lock, locksan.SanLock)}
        out["locksan"] = {"edges": rep["edges"], "blocking": rep["blocking"],
                          "cycles": rep["cycles"], "import_time_locks_plain": plain}
        print("phase 25 (c) locksan " + json.dumps(out["locksan"]) + " (locks built at "
              "import, before arm(), stay plain locks the sanitizer does not see)", flush=True)
        if locksan.find_cycles() != []:
            raise AssertionError(f"phase 25 (c): lock-order cycles {locksan.find_cycles()}")
        out["trace_check"] = p25_trace_check("(c)", trace_dir, ("train/step", "ckpt"))
    finally:
        locksan.disarm()
        tracer.reset()
    try:
        engine = p19_engine(cfg, dev, 0, config)
        reset_launches()
        plain_losses, _ = p19_train(engine, batches, dev)
        launches25.update({k: LAUNCHES.get(k, 0) for k in K1_NAMES})
        engine.destroy()
        del engine
        same = plain_losses.tobytes() == losses.tobytes()
        print(f"phase 25 (c) losses armed+traced+saving {losses.tolist()} vs plain "
              f"{plain_losses.tolist()}, bitwise {same}", flush=True)
        if not same:
            raise AssertionError("phase 25 (c): the sanitizer, tracer or saves changed the "
                                 "losses")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out, launches25


def run_observability(model=None, dev="cuda") -> dict:
    """Phase 25: the monitor sinks, the live exporter, the flops profiler,
    the step and decode phase timings, the spans and the lock-order
    sanitizer on the main paths: (a) phase 20's Llama-2-7B-width trainer,
    (b) Llama-2-7B serving at 32 layers (``model``: a ``p17_model()`` to
    reuse), (c) phase 19's GPT-2 small with rolling saves. Returns the
    kernels' launches over the phase."""
    import torch
    dev = torch.device(dev)
    t_phase = time.perf_counter()
    launches = collections.Counter()
    t = time.perf_counter()
    out_a, l_a = p25_training(dev)
    launches.update(l_a)
    print(f"phase 25 (a): {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    model = model if model is not None else p17_model()
    out_b, l_b = p25_serve(model, dev)
    del model
    launches.update(l_b)
    print(f"phase 25 (b): {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    out_c, l_c = p25_checkpoint(dev)
    launches.update(l_c)
    print(f"phase 25 (c): {time.perf_counter() - t:.1f} s", flush=True)
    print("phase 25 " + json.dumps({"nvidia_smi": smi_line() if dev.type == "cuda" else "cpu",
                                    "launches": dict(launches),
                                    "seconds": time.perf_counter() - t_phase}), flush=True)
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches)


# --------------------------------------------------------------------------- #
# phase 26: the v1 engine's int8 weights and int8 KV cache, the DecoderLM and
# Mixtral dense decodes, and ZeRO++ qwZ at a world of one
# --------------------------------------------------------------------------- #

P26_A = (4, 1024, 32)     # (a) Llama-2-7B: prompts, prompt tokens, new tokens
P26_B = (4, 512, 16)      # (b) Falcon-7B
P26_C = (2, 512, 16)      # (c) Mixtral-8x7B
P26_C_LAYERS = 8          # of Mixtral's 32: the v1 engine takes the whole bf16 tree
                          # (93 GB at 32 layers) before it quantizes
P26_QUANT = {"enabled": True, "bits": 8, "group_size": 64}
P26_D_T = 1024            # (d) the qwZ trainer: T, steps, micro-batch 1
P26_D_STEPS = 4
P26_D_CONFIG = {
    "train_batch_size": 1, "train_micro_batch_size_per_gpu": 1,
    "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 0,
    # no decay: AdamW's decoupled decay term adds a full fp32 tree of
    # temporaries to an update that already peaks near phase 23's 66.6 GiB.
    # lr: AdamW's first steps move every weight by ~lr at once; at 5e-4 and
    # 3e-5 this phase's 4 losses climbed on the card (11.04 -> 15.77 and
    # -> 11.96)
    "optimizer": {"type": "AdamW", "params": {"lr": 3e-6, "betas": [0.9, 0.95],
                                              "eps": 1e-8, "weight_decay": 0.0}},
}
P26_QWZ = {"stage": 3, "zero_quantized_weights": True}
P26_RESUME_AT = 2         # (d) gate 3: save after this step, resume, rerun the rest
P26_CORRUPT = 0.5         # (a) control: k/v scales of the prompt times U(1 - x, 1 + x)


def p26_gib(dev) -> float:
    import torch
    return torch.cuda.memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0


def p26_reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)


def p26_peak_gib(dev) -> float:
    import torch
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else 0.0


def p26_event(dev):
    import torch
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def p26_ms(a, b) -> float:
    if a is None:
        return 0.0
    b.synchronize()
    return float(a.elapsed_time(b))


def p26_steps(engine, prompts, new, feed=None, corrupt=None):
    """The v1 engine's ``generate`` loop, step by step (the same decode calls
    on the same cache): a prefill, then ``new - 1`` single-token steps,
    greedy, or teacher-forced on ``feed`` [B, new]. ``corrupt(cache)`` runs
    after the prefill. Returns the stream [B, new], each step's
    last-position logits [new, B, V] f32, the prefill ms, the decode ms a
    step (CUDA events), the cache bytes and the decode steps' peak GiB
    above what was allocated when they began."""
    import torch
    dev = engine.device
    B, T = prompts.shape
    ids = torch.from_numpy(prompts.astype(np.int64)).to(dev)
    cache = engine._make_cache(B, T + new)
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    decode = engine._net.decode
    e0 = p26_event(dev)
    logits, cache = decode(ids, cache, 0)
    e1 = p26_event(dev)
    if corrupt is not None:
        corrupt(cache)
    rows, toks = [logits[:, -1].float()], []
    tok = rows[0].argmax(-1) if feed is None else torch.from_numpy(feed[:, 0]).to(dev)
    toks.append(tok)
    base = p26_gib(dev)
    p26_reset_peak(dev)
    e2 = p26_event(dev)
    for i in range(new - 1):
        logits, cache = decode(tok[:, None], cache, T + i)
        rows.append(logits[:, -1].float())
        tok = rows[-1].argmax(-1) if feed is None else \
            torch.from_numpy(feed[:, i + 1]).to(dev)
        toks.append(tok)
    e3 = p26_event(dev)
    out = {"stream": torch.stack(toks, 1).cpu().numpy(), "logits": torch.stack(rows),
           "prefill_ms": p26_ms(e0, e1), "decode_ms_per_step": p26_ms(e2, e3) / (new - 1),
           "cache_bytes": cache_bytes,
           "decode_peak_above_gib": p26_peak_gib(dev) - base}
    del cache
    return out


def p26_gap(ref, s, i) -> float:
    """Top-2 gap of the reference logits ``ref`` [new, B, V] at step ``s``
    of row ``i``."""
    import torch
    top = torch.topk(ref[s, i], 2).values
    return float(top[0] - top[1])


def p26_one_pass(engine, seq, dtype, kv_bits, T, new):
    """A dense reference: the engine's module tree's decode over the whole
    sequence ``seq``
    [B, T + new - 1] in ONE prefill, computed in ``dtype`` (the module
    tree's config copied with that dtype; its weights cast as each matmul
    runs), over a fresh cache (``kv_bits=8``: every K/V row rounded
    through the int8 tier's per-(token, head) quantization). Returns the
    rows [T - 1, T + new - 1) of the logits, as [new, B, V] f32."""
    import copy as copy_
    import dataclasses
    import torch
    from deepspeed_tpu_torch.models.decoder import DecoderLM, init_decoder_cache
    from deepspeed_tpu_torch.models.llama import init_cache
    net = engine._net
    ref = copy_.copy(net)
    ref.config = dataclasses.replace(net.config, dtype=dtype)
    make = init_decoder_cache if isinstance(net, DecoderLM) else init_cache
    cache = make(ref.config, seq.shape[0], seq.shape[1], dtype=dtype, kv_bits=kv_bits,
                 device=engine.device)
    logits, _ = ref.decode(torch.from_numpy(seq.astype(np.int64)).to(engine.device), cache, 0)
    out = logits[:, T - 1:T - 1 + new].float().transpose(0, 1).contiguous()
    del cache, logits
    return out


def p26_rms(a, b) -> float:
    return float((a - b).pow(2).mean().sqrt())


def p26_kv_rule(label, got, ref32, ref16, control=None):
    """Phase 6's int8-KV error rule: the engine's step logits against the
    fp32 reference within twice the dense bf16 reference's rms error; a
    control run must fall outside it."""
    limit = 2 * p26_rms(ref16, ref32)
    err = p26_rms(got, ref32)
    out = {"rms": err, "max": float((got - ref32).abs().max()), "dense_bf16_rms": limit / 2,
           "limit": limit}
    if control is not None:
        out["control_rms"] = p26_rms(control, ref32)
    print(f"phase 26 {label} logits " + json.dumps(out), flush=True)
    if not err <= limit:
        raise AssertionError(f"phase 26 {label}: logits rms {err} > limit {limit}")
    if control is not None and not out["control_rms"] > limit:
        raise AssertionError(f"phase 26 {label}: the control ({out['control_rms']}) passes "
                             f"the rule (limit {limit})")
    return out


def p26_tie_check(label, stream, ref_logits, limit):
    """``same_or_near_tie`` of a greedy ``stream`` [B, new] against the
    argmax of ``ref_logits`` [new, B, V] taken along the same stream: where
    they first part, the reference's top-2 gap must be below ``limit``."""
    ref = ref_logits.argmax(-1).t().cpu().numpy()
    same_or_near_tie(label, stream, ref, lambda i, s: p26_gap(ref_logits, s, i), limit)


def p26_same(label, a, b) -> None:
    import torch
    if not (np.array_equal(a["stream"], b["stream"]) and torch.equal(a["logits"], b["logits"])):
        raise AssertionError(f"phase 26 {label}: streams or logits are not bit-equal")


def p26_prompts(B, T, V, seed):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)


def p26_engine(model, conf, params, dev):
    import deepspeed_tpu_torch
    return deepspeed_tpu_torch.init_inference(model, config=conf, model_parameters=params,
                                              device=dev)


def p26_free(dev) -> None:
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def p26_generate(label, engine, prompts, new, run) -> None:
    """``generate`` (the user's entry point) gives the stream of the
    step-by-step loop ``run``."""
    got = engine.generate(prompts, max_new_tokens=new)[:, prompts.shape[1]:]
    if not np.array_equal(got, run["stream"]):
        raise AssertionError(f"phase 26 {label}: generate() differs from its decode steps")


def p26_llama(dev, cfg=None) -> dict:
    """(a) Llama-2-7B at 32 layers through ``init_inference``: int8 weights
    (group 64), then int8 weights + the int8 cache."""
    import torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.runtime.zero.zeropp import tree_bytes
    B, T, new = P26_A
    cfg = cfg or LlamaConfig.llama2_7b(dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    prompts = p26_prompts(B, T, cfg.vocab_size, 26)
    conf = {"dtype": "bfloat16", "max_tokens": T + new, "max_out_tokens": new}
    out = {}

    def build(label, extra, params):
        p26_free(dev)
        p26_reset_peak(dev)
        before = p26_gib(dev)
        t0 = time.perf_counter()
        eng = p26_engine(model, {**conf, **extra}, params, dev)
        out[label] = {"build_s": time.perf_counter() - t0,
                      "param_bytes": tree_bytes(eng.params),
                      "build_peak_above_gib": p26_peak_gib(dev) - before}
        return eng

    def record(label, run):
        out[label].update({k: run[k] for k in ("prefill_ms", "decode_ms_per_step",
                                                "cache_bytes", "decode_peak_above_gib")})
        out[label]["peak_gib"] = p26_peak_gib(dev)

    q = build("quant", {"quant": P26_QUANT}, model.flat_params())
    p26_reset_peak(dev)
    rq = p26_steps(q, prompts, new)
    record("quant", rq)
    p26_generate("(a) quant", q, prompts, new, rq)
    sd = q.module_state_dict()
    b = build("bf16_on_state_dict", {}, sd)
    del sd
    p26_reset_peak(dev)
    rb = p26_steps(b, prompts, new)
    record("bf16_on_state_dict", rb)
    p26_same("(a) quant vs the bf16 engine on its module_state_dict()", rq, rb)
    del b, rb
    c = build("bf16_original", {}, model.flat_params())
    p26_reset_peak(dev)
    rc = p26_steps(c, prompts, new, feed=rq["stream"])
    record("bf16_original", rc)
    if torch.equal(rc["logits"], rq["logits"]):
        raise AssertionError("phase 26 (a) control: the bf16 engine on the original "
                             "weights gives the quant engine's logits")
    out["control_max_abs_diff"] = float((rc["logits"] - rq["logits"]).abs().max())
    del c, rc
    kq = build("quant_kv_quant", {"quant": P26_QUANT, "kv_quant": {"enabled": True}},
               model.flat_params())
    p26_reset_peak(dev)
    rk = p26_steps(kq, prompts, new)
    record("quant_kv_quant", rk)
    p26_generate("(a) quant + kv_quant", kq, prompts, new, rk)
    seq = np.concatenate([prompts, rk["stream"][:, :-1]], 1)
    ref32 = p26_one_pass(kq, seq, torch.float32, 8, T, new)
    ref16 = p26_one_pass(kq, seq, torch.bfloat16, 8, T, new)
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)

    def corrupt(cache):
        for key in ("k_scale", "v_scale"):
            s = cache[key][:, :, :T]
            s.mul_(1 + P26_CORRUPT * (2 * torch.rand(s.shape, generator=gen, device=dev) - 1))

    rx = p26_steps(kq, prompts, new, feed=rk["stream"], corrupt=corrupt)
    out["kv_rule"] = p26_kv_rule("(a) quant + kv_quant", rk["logits"][1:], ref32[1:],
                                 ref16[1:], control=rx["logits"][1:])
    tie = 2 * float((ref16 - ref32).abs().max())
    # the int8 cache's stream against the bf16 cache's (int8 weights both)
    same_or_near_tie("(a) quant + kv_quant vs quant", rk["stream"], rq["stream"],
                     lambda i, s: p26_gap(ref32, s, i), tie)
    out["cache_ratio_int8_over_bf16"] = rk["cache_bytes"] / rq["cache_bytes"]
    out["param_ratio_quant_over_bf16"] = out["quant"]["param_bytes"] / \
        out["bf16_on_state_dict"]["param_bytes"]
    del kq, rk, rx, ref32, ref16, q, rq, model
    p26_free(dev)
    return out


def p26_falcon(dev, cfg=None) -> dict:
    """(b) Falcon-7B (4544 wide, 71 heads over one KV head, D 64) at 32
    layers: ``DecoderLM.decode`` through the v1 engine with a bf16 cache,
    then the int8 cache."""
    import torch
    from deepspeed_tpu_torch.models.decoder import DecoderConfig, DecoderLM
    B, T, new = P26_B
    cfg = cfg or DecoderConfig.falcon_7b(dtype=torch.bfloat16)
    model = DecoderLM(cfg, device=dev, seed=0)
    prompts = p26_prompts(B, T, cfg.vocab_size, 27)
    conf = {"dtype": "bfloat16", "max_tokens": T + new, "max_out_tokens": new}
    out = {}
    eng = p26_engine(model, conf, model.flat_params(), dev)
    p26_reset_peak(dev)
    r16 = p26_steps(eng, prompts, new)
    p26_generate("(b) bf16 cache", eng, prompts, new, r16)
    out["bf16_cache"] = {k: r16[k] for k in ("prefill_ms", "decode_ms_per_step", "cache_bytes",
                                             "decode_peak_above_gib")}
    out["bf16_cache"]["peak_gib"] = p26_peak_gib(dev)
    del eng
    p26_free(dev)
    seq = np.concatenate([prompts, r16["stream"][:, :-1]], 1)
    ids = torch.from_numpy(seq.astype(np.int64)).to(dev)
    f32 = model.forward_logits(ids, compute_dtype=torch.float32)[:, T - 1:].transpose(0, 1)
    f16 = model.forward_logits(ids, compute_dtype=torch.bfloat16)[:, T - 1:].transpose(0, 1)
    out["bf16_rule"] = p26_kv_rule("(b) bf16 cache", r16["logits"], f32, f16)
    tie = 2 * float((f16 - f32).abs().max())
    p26_tie_check("(b) bf16 cache vs dense fp32", r16["stream"], f32, tie)
    del f32, f16
    p26_free(dev)
    eng = p26_engine(model, {**conf, "kv_quant": {"enabled": True}}, model.flat_params(), dev)
    p26_reset_peak(dev)
    r8 = p26_steps(eng, prompts, new)
    p26_generate("(b) int8 cache", eng, prompts, new, r8)
    out["int8_cache"] = {k: r8[k] for k in ("prefill_ms", "decode_ms_per_step", "cache_bytes",
                                            "decode_peak_above_gib")}
    out["int8_cache"]["peak_gib"] = p26_peak_gib(dev)
    seq = np.concatenate([prompts, r8["stream"][:, :-1]], 1)
    ref32 = p26_one_pass(eng, seq, torch.float32, 8, T, new)
    ref16 = p26_one_pass(eng, seq, torch.bfloat16, 8, T, new)
    out["kv_rule"] = p26_kv_rule("(b) int8 cache", r8["logits"], ref32, ref16)
    same_or_near_tie("(b) int8 cache vs bf16 cache", r8["stream"], r16["stream"],
                     lambda i, s: p26_gap(ref32, s, i), tie)
    out["cache_ratio_int8_over_bf16"] = r8["cache_bytes"] / r16["cache_bytes"]
    del eng, model, ref32, ref16
    p26_free(dev)
    return out


def p26_mixtral(dev, cfg=None) -> dict:
    """(c) Mixtral-8x7B at full width (8 experts, top-2, dropless), 8 of its
    32 layers: the v1 ``decode`` in bf16 and with int8 weights."""
    import torch
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig, MixtralForCausalLM
    from deepspeed_tpu_torch.runtime.zero.zeropp import tree_bytes
    B, T, new = P26_C
    cfg = cfg or MixtralConfig.mixtral_8x7b(num_hidden_layers=P26_C_LAYERS,
                                            dtype=torch.bfloat16)
    model = MixtralForCausalLM(cfg, device=dev, seed=0)
    prompts = p26_prompts(B, T, cfg.vocab_size, 28)
    conf = {"dtype": "bfloat16", "max_tokens": T + new, "max_out_tokens": new}
    out = {}
    p26_reset_peak(dev)
    q = p26_engine(model, {**conf, "quant": P26_QUANT}, model.flat_params(), dev)
    out["quant"] = {"param_bytes": tree_bytes(q.params)}
    p26_reset_peak(dev)
    rq = p26_steps(q, prompts, new)
    p26_generate("(c) quant", q, prompts, new, rq)
    out["quant"].update({k: rq[k] for k in ("prefill_ms", "decode_ms_per_step",
                                            "decode_peak_above_gib")})
    out["quant"]["peak_gib"] = p26_peak_gib(dev)
    c = p26_engine(model, conf, model.flat_params(), dev)
    out["bf16_original"] = {"param_bytes": tree_bytes(c.params)}
    p26_reset_peak(dev)
    rc = p26_steps(c, prompts, new, feed=rq["stream"])
    out["bf16_original"].update({k: rc[k] for k in ("prefill_ms", "decode_ms_per_step",
                                                    "decode_peak_above_gib")})
    out["bf16_original"]["peak_gib"] = p26_peak_gib(dev)
    if torch.equal(rc["logits"], rq["logits"]):
        raise AssertionError("phase 26 (c) control: the bf16 engine on the original "
                             "weights gives the quant engine's logits")
    out["control_max_abs_diff"] = float((rc["logits"] - rq["logits"]).abs().max())
    del c, rc
    p26_free(dev)
    # the model takes the quant engine's export; the bf16 engine serves it
    sd = q.module_state_dict()
    model.load_flat(sd)
    del sd
    p26_free(dev)
    b = p26_engine(model, conf, model.flat_params(), dev)
    rb = p26_steps(b, prompts, new)
    p26_same("(c) quant vs the bf16 engine on its module_state_dict()", rq, rb)
    del b, rb
    p26_free(dev)
    seq = np.concatenate([prompts, rq["stream"][:, :-1]], 1)
    ids = torch.from_numpy(seq.astype(np.int64)).to(dev)
    f32 = model.forward_logits(ids, compute_dtype=torch.float32)[:, T - 1:].transpose(0, 1)
    f16 = model.forward_logits(ids, compute_dtype=torch.bfloat16)[:, T - 1:].transpose(0, 1)
    tie = 2 * float((f16 - f32).abs().max())
    out["logits_vs_fp32"] = {"rms": p26_rms(rq["logits"], f32),
                             "dense_bf16_rms": p26_rms(f16, f32), "tie_limit": tie}
    p26_tie_check("(c) quant vs dense fp32", rq["stream"], f32, tie)
    del q, rq, model, f32, f16
    p26_free(dev)
    return out


def p26_zipf_batches(V, n, T, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, V + 1) ** P20_ZIPF
    return [{"input_ids": rng.choice(V, size=(1, T), p=p / p.sum()).astype(np.int32)}
            for _ in range(n)]


def p26_train(engine, batches, dev):
    """Per step: (loss, grad norm) as floats and the warm step ms."""
    out, times = [], []
    for b in batches:
        p19_sync(dev)
        t0 = time.perf_counter()
        loss = engine.train_batch(b)
        p19_sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        out.append((float(loss), engine.get_global_grad_norm()))
    return out, times


def p26_qwz(dev, cfg=None, small=None) -> tuple:
    """(d) ZeRO++ qwZ at a world of one: Llama-2-7B width at ``P20_LAYERS``
    layers, T ``P26_D_T``, micro-batch 1, AdamW. Gate 1: step 1's loss and
    grad norm bit-equal to the plain engine started from the quantized
    master's dequantization; gate 2: the loss stream within JAX's
    ``test_qwz_training_tracks_fp`` rule of that plain run; gate 3: a qwZ
    save and load resume bit for bit (phase 20's GPT-2 small cut to 2
    layers: a 7B-width tag is ~22 GB). Returns (results, K1 launches)."""
    import shutil
    import tempfile
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from deepspeed_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from deepspeed_tpu_torch.runtime.zero.zeropp import (dequantize_param_tree,
                                                         quantize_param_tree, tree_bytes)
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=P20_LAYERS, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    master = {n: p.detach().float() for n, p in model.named_flat_parameters().items()}
    batches = p26_zipf_batches(cfg.vocab_size, P26_D_STEPS, P26_D_T, 26)
    out = {}
    rt = dequantize_param_tree(quantize_param_tree(master, torch.bfloat16), torch.float32)
    # AdamW over the whole master peaks near 67 GiB at this size: no second
    # fp32 tree may stay beside it (the qwZ engine rebuilds the model from
    # the same seed)
    del master
    p26_free(dev)
    p26_reset_peak(dev)
    plain = deepspeed_tpu_torch.initialize(model=model, model_parameters=rt,
                                           config=P26_D_CONFIG, device=dev)[0]
    del rt
    base, base_ms = p26_train(plain, batches, dev)
    out["plain"] = {"param_bytes": sum(t.numel() * t.element_size()
                                       for t in plain.state["params"].values()),
                    "step_ms": base_ms, "peak_gib": p26_peak_gib(dev)}
    plain.destroy()
    del plain, model
    p26_free(dev)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    p26_reset_peak(dev)
    reset_launches()
    qwz = deepspeed_tpu_torch.initialize(
        model=model, device=dev, config=dict(P26_D_CONFIG, zero_optimization=P26_QWZ))[0]
    got, q_ms = p26_train(qwz, batches, dev)
    launches = {k: LAUNCHES.get(k, 0) for k in K1_NAMES}
    params = qwz.state["params"]
    n_q = sum(1 for v in params.values() if isinstance(v, dict))
    out["qwz"] = {"param_bytes": tree_bytes(params), "quantized_leaves": n_q,
                  "leaves": len(params), "step_ms": q_ms, "peak_gib": p26_peak_gib(dev),
                  "k1_launches": launches}
    out["losses"] = {"qwz": [x[0] for x in got], "plain": [x[0] for x in base]}
    out["grad_norms"] = {"qwz": [x[1] for x in got], "plain": [x[1] for x in base]}
    print("phase 26 (d) " + json.dumps(out), flush=True)
    if got[0] != base[0]:
        raise AssertionError(f"phase 26 (d) gate 1: step 1 {got[0]} != plain {base[0]}")
    ql, pl = np.array(out["losses"]["qwz"]), np.array(out["losses"]["plain"])
    if not (np.isfinite(ql).all() and ql[-1] < ql[0]):
        raise AssertionError(f"phase 26 (d) gate 2: losses {ql} do not fall")
    np.testing.assert_allclose(ql, pl, rtol=0.1, atol=0.15)
    if not n_q or any(v["q"].dtype != torch.int8 for v in params.values()
                      if isinstance(v, dict)):
        raise AssertionError("phase 26 (d): the compute params are not int8")
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"phase 26 (d): K1 kernels never launched: {launches}")
    qwz.destroy()
    del qwz, model
    p26_free(dev)
    # gate 3: a qwZ save, then a load, resumes bit for bit
    root = tempfile.mkdtemp(prefix="chip_smoke_p26_")
    try:
        config = dict(P20_SMALL_CONFIG, optimizer={"type": "AdamW", "params": {"lr": 1e-3}},
                      zero_optimization=P26_QWZ)
        small = small or dict(P20_SMALL)
        gpt = GPT2LMHead(GPT2Config(**small, dtype=torch.bfloat16), device=dev, seed=0)
        e = deepspeed_tpu_torch.initialize(model=gpt, config=config, device=dev)[0]
        rows = p26_zipf_batches(gpt.config.vocab_size, 4 * (P26_RESUME_AT + 2),
                                gpt.config.n_positions // 4, 29)
        gb = [{"input_ids": np.concatenate([r["input_ids"] for r in rows[i:i + 4]])}
              for i in range(0, len(rows), 4)]
        for b in gb[:P26_RESUME_AT]:
            e.train_batch(b)
        e.save_checkpoint(root, tag="qwz")
        first = [float(e.train_batch(b)) for b in gb[P26_RESUME_AT:]]
        e.load_checkpoint(root, tag="qwz")
        again = [float(e.train_batch(b)) for b in gb[P26_RESUME_AT:]]
        out["resume"] = {"losses": first, "resumed": again}
        print("phase 26 (d) resume " + json.dumps(out["resume"]), flush=True)
        if first != again:
            raise AssertionError(f"phase 26 (d) gate 3: resumed {again} != {first}")
        e.destroy()
        del e, gpt
    finally:
        shutil.rmtree(root, ignore_errors=True)
    p26_free(dev)
    return out, launches


def run_quantized_v1(dev="cuda") -> dict:
    """Phase 26: (a) Llama-2-7B through ``init_inference`` with int8 weights
    and the int8 cache, (b) Falcon-7B's ``DecoderLM.decode``, (c)
    Mixtral-8x7B's decode at 8 layers, (d) ZeRO++ qwZ training. Returns K1's
    launches in (d); (a)-(c) run no kernel of the port (the v1 engine is
    plain torch, as the JAX engine is XLA)."""
    import torch
    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    res = {"nvidia_smi": smi_line() if dev.type == "cuda" else "cpu"}
    for part, fn in (("a", p26_llama), ("b", p26_falcon), ("c", p26_mixtral)):
        t = time.perf_counter()
        res[part] = fn(dev)
        res[part]["seconds"] = time.perf_counter() - t
        print(f"phase 26 ({part}) " + json.dumps(res[part]), flush=True)
    t = time.perf_counter()
    res["d"], launches = p26_qwz(dev)
    res["d"]["seconds"] = time.perf_counter() - t
    res["seconds"] = time.perf_counter() - t_phase
    print("phase 26 " + json.dumps({"nvidia_smi": res["nvidia_smi"], "launches": launches,
                                    "seconds": res["seconds"]}), flush=True)
    print(f"phase 26: {res['seconds']:.1f} s", flush=True)
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
    gc.collect()
    torch.cuda.empty_cache()
    # phase 19: checkpoint and resume; K1's rows keep phase 5's counts
    run_checkpoint()
    gc.collect()
    torch.cuda.empty_cache()
    # phase 20: Llama-2-7B-width training; K1's rows keep phase 5's counts,
    # its own launches and the D 128 timings are on its lines
    run_llama_training()
    gc.collect()
    torch.cuda.empty_cache()
    # phases 21 and 22: the serving frontend and the router on Llama-2-7B;
    # the kernel rows keep their counts and carry these phases' beside them
    model, serving_launches = run_frontend()
    # phase 22 at P22_LAYERS (8) of the 32: the script's time went to phase 24
    del model
    gc.collect()
    torch.cuda.empty_cache()
    cluster_launches = run_cluster(p17_model(P22_LAYERS))
    gc.collect()
    torch.cuda.empty_cache()
    # phase 23: the colocated rollout and the hybrid engine; likewise
    rollout_launches = run_rollout()
    gc.collect()
    torch.cuda.empty_cache()
    # phase 24: the offload tier; K1's D 128 rows and the K2 and decode rows
    # carry its launches beside theirs
    offload_launches = run_offload()
    gc.collect()
    torch.cuda.empty_cache()
    # phase 25: observability and resilience; K1's, K2's, K5's and the decode
    # rows carry its launches beside theirs
    observability_launches = run_observability()
    gc.collect()
    torch.cuda.empty_cache()
    # phase 26: the v1 engine's int8 tiers, the DecoderLM and Mixtral
    # decodes and qwZ training; K1's D 128 rows carry (d)'s launches
    quant_launches = run_quantized_v1()
    gc.collect()
    torch.cuda.empty_cache()
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
                         if "library_covers" in r else {}),
                      **({"serving_launches": {
                          "phase21": serving_launches.get(name, 0),
                          "phase22": cluster_launches.get(name, 0),
                          "phase23": rollout_launches.get(name, 0),
                          "phase24": offload_launches.get(name, 0),
                          "phase25": observability_launches.get(name, 0),
                          "phase26": quant_launches.get(name, 0)}}
                         if serving_launches.get(name) or cluster_launches.get(name)
                         or rollout_launches.get(name) or offload_launches.get(name)
                         or observability_launches.get(name) or quant_launches.get(name)
                         else {})})
    print(f"chip_smoke.py: {time.perf_counter() - t0:.1f} s from the build on", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
