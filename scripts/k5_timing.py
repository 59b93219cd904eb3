#!/usr/bin/env python3
"""Time the paged chunk kernel (K5) in one or more trees of the port on one
GPU, and K5 against the plain-torch split path that chunks at split rungs
above 1 took before the engine routed them through K5.

For each tree it runs that tree's own phase 3 checks that hold K5
(``chip_smoke.check_window_kernels``, ``check_alibi_kernels``,
``check_quant_kernels``, ``check_quant_window_kernels`` and
``check_quant_alibi_kernels``) plus the Llama-2-7B chunk row (6 slots x
128 rows, 32/32 heads, D = 128, pages of 128, as ``check_kernels`` builds
it), and prints one ``k5-timing`` JSON line: each kernel-table row of
``paged_chunk*`` with its case, ms, bound and plain ms
(``chip_smoke.time_ms``: CUDA events around back-to-back launches queued
behind a GPU sleep). A failed check is printed, not raised. Then, on one
``k5-rungs`` line, K5 against ``paged_splitk.paged_chunk_attention_xla`` at
2, 4 and 8 splits at the shape of the second pass of the longest prompt of
the serving phases whose chunks ran the split path: 6 (Llama-2-13B, int8
pages), 9 (Mistral-7B, window 4096), 11 (Mistral-7B, int8 pages under the
window) and 12 (BLOOM-7b1, int8 pages, ALiBi): every slot of a pass's
take filled with one prompt's continuation chunks, the rest empty, the
engine's own block-table width, each call checked against K5's plain
version. A split count that runs out of device memory reads "OOM".

With ``--phases`` it then runs that tree's serving phases (4, 6 and 9 to
13: ``run_slice``, ``run_13b``, ``run_mistral``, ``run_bloom``,
``run_mistral_lean``, ``run_bloom_7b1``, ``run_phi2``), whose lines give
prefill tok/s and, through ``chip_smoke.continuation_pass``, the device
time of one continuation pass at each rung. A tree whose ``chip_smoke.py``
has no ``continuation_pass`` gets this repository's, run on the phase's
engine after the phase returns.

With ``--sweep`` it instead times K5 and the split path at 4 splits
against context length: 4 slots of 128 rows at the end of contexts of
256, 1024, 4096 and 12000 tokens (pages of 128, D = 128) at Mistral-7B's
heads (32 over 8, no window and the window of 4096) and Llama-2-13B's (40
over 40), over bf16 and int8 pages, each beside its bound, on one
``k5-sweep`` line.

Run from the repository root; each TREE is a directory holding a
``deepspeed_tpu_torch/`` and its ``chip_smoke.py`` (``.``, or a ``git
archive`` of another commit unpacked under ``_archive/``), timed in its own
process, in the order given (e.g. parent, change, change, parent):

    python3 scripts/k5_timing.py [--phases] _archive/parent . . _archive/parent
    python3 scripts/k5_timing.py --sweep .
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_PREFIX = "paged_chunk"
SPLITS = (2, 4, 8)
# (phase, H, Hkv, D, pages, block-table width, slots, rows a slot, prompt,
#  window, alibi, int8 pages): each phase's engine and its longest prompt
RUNG_PASSES = (("phase 6 Llama-2-13B int8", 40, 40, 128, 128, 36, 6, 128, 4200, None,
                False, True),
               ("phase 9 Mistral-7B", 32, 8, 128, 128, 128, 64, 128, 12000, 4096, False,
                False),
               ("phase 11 Mistral-7B int8 KV", 32, 8, 128, 128, 128, 64, 128, 12000, 4096,
                False, True),
               ("phase 12 BLOOM-7b1 int8 KV", 32, 32, 128, 128, 16, 6, 128, 1900, None, True,
                True))
SWEEP_LENS = (256, 1024, 4096, 12000)
SWEEP_SHAPES = (("Mistral-7B", 32, 8, None), ("Mistral-7B window", 32, 8, 4096),
                ("Llama-2-13B", 40, 40, None))
SERVING = (("run_slice", "Llama-2-7B", "P_NAMES"), ("run_13b", "Llama-2-13B int8", "Q_NAMES"),
           ("run_mistral", "Mistral-7B", "W_NAMES"), ("run_bloom", "BLOOM-560M", "A_NAMES"),
           ("run_mistral_lean", "Mistral-7B int4 + int8 KV", "M8_NAMES"),
           ("run_bloom_7b1", "BLOOM-7b1 int8 KV", "A_NAMES"), ("run_phi2", "phi-2", "P_NAMES"))


def pool_of(g, NB, Hkv, bs, D, quant, dev):
    """A random pool [NB, 2, Hkv, bs, D]: bf16, or int8 with its scale
    tiles (``kv_scales``)."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_quantize_rows, scales_to_tiles
    x = torch.randn(NB, 2, Hkv, bs, D, generator=g, device=dev)
    if not quant:
        return x.to(torch.bfloat16), {}
    pool, scl = kv_quantize_rows(x)
    return pool, {"kv_scales": scales_to_tiles(scl).contiguous()}


def chunk_7b_row(cs, dev, randn, record):
    """check_kernels' Llama-2-7B chunk row: 6 slots x 128 rows."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import (paged_chunk_attention_batched,
                                                 paged_chunk_attention_batched_plain)
    bs, H, Hkv, D, MB, Cs = 128, 32, 32, 128, 16, 128
    ctxs = [2048, 1536, 1000, 300, 128, 0]
    NB = sum(-(-c // bs) for c in ctxs) + 4
    pool = randn(NB, 2, Hkv, bs, D)
    bt = cs.block_tables(ctxs, bs, MB, NB, dev)
    ctx = torch.tensor(ctxs, dtype=torch.int32, device=dev)
    q0 = torch.clamp(ctx - Cs, min=0)
    qc = randn(len(ctxs), Cs, H, D)
    fn = lambda: paged_chunk_attention_batched(qc, pool, bt, q0, ctx)
    out = fn()
    ref = paged_chunk_attention_batched_plain(qc, pool, bt, q0, ctx)
    vis = sum(min(c, q + r + 1) for c, q in zip(ctxs, q0.tolist()) for r in range(Cs) if c > 0)
    b_ms, b_by = cs.bound(2 * qc.numel() * 2 + sum(ctxs) * Hkv * D * 2 * 2, 4 * D * H * vis)
    record("paged_chunk", f"6x{Cs} rows ctx={ctxs} bs={bs}", cs.err((out, ref)), row=True,
           ms=cs.time_ms(fn), plain_ms=None, library_ms=None, bound_ms=b_ms, bound_by=b_by)


def second_pass(P, NC, Cs, take):
    """(q_starts, ctx) of the second pass of a P-token prompt whose passes
    take ``take`` tokens in slots of Cs rows: filled slots first, then
    empty ones (ctx 0)."""
    q0, ctx = [], []
    for j in range(NC):
        lo = take + j * Cs
        if j * Cs < take and lo < P:
            q0.append(lo)
            ctx.append(min(lo + Cs, P))
        else:
            q0.append(0)
            ctx.append(0)
    return q0, ctx


def rungs(cs, dev, g) -> dict:
    """K5 against the split path at the serving passes' shapes (module doc)."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.paged_chunk import (
        paged_chunk_attention_batched, paged_chunk_attention_batched_plain)
    from deepspeed_tpu_torch.ops.kernels.paged_splitk import paged_chunk_attention_xla
    out = {}
    for label, H, Hkv, D, bs, MB, NC, Cs, P, window, alibi, quant in RUNG_PASSES:
        take = NC * Cs if window is None else min(window + bs, NC * Cs)
        q0s, ctxs = second_pass(P, NC, Cs, take)
        NB = MB + 1
        pool, kw = pool_of(g, NB, Hkv, bs, D, quant, dev)
        bt = torch.arange(MB, dtype=torch.int32, device=dev).repeat(NC, 1)
        q0 = torch.tensor(q0s, dtype=torch.int32, device=dev)
        ctx = torch.tensor(ctxs, dtype=torch.int32, device=dev)
        qc = torch.randn(NC, Cs, H, D, generator=g, device=dev).to(torch.bfloat16)
        kw.update(window=window, alibi=alibi)
        k5 = lambda: paged_chunk_attention_batched(qc, pool, bt, q0, ctx, **kw)
        ref = paged_chunk_attention_batched_plain(qc, pool, bt, q0, ctx, **kw)
        r = {"slots": f"{sum(c > 0 for c in ctxs)} of {NC} x {Cs} rows from q_start {take}",
             "k5_ms": cs.time_ms(k5), "k5_err": cs.err((k5(), ref))}
        for n in SPLITS:
            split = lambda: paged_chunk_attention_xla(qc, pool, bt, q0, ctx, n_splits=n, **kw)
            try:
                r[f"split{n}_err"] = cs.err((split(), ref))
                r[f"split{n}_ms"] = cs.time_ms(split, 5, 1)
            except torch.cuda.OutOfMemoryError:
                r[f"split{n}_ms"] = "OOM"
            torch.cuda.empty_cache()
        out[label] = r
        del pool, kw, ref
        torch.cuda.empty_cache()
    return out


def sweep(cs, dev, g) -> dict:
    """K5 and the split path at 4 splits against context length."""
    import torch
    from deepspeed_tpu_torch.ops.kernels.paged_chunk import paged_chunk_attention_batched
    from deepspeed_tpu_torch.ops.kernels.paged_splitk import paged_chunk_attention_xla
    S, Cs, D, bs = 4, 128, 128, 128
    out = {}
    for label, H, Hkv, window in SWEEP_SHAPES:
        for quant in (False, True):
            for L in SWEEP_LENS:
                MB = -(-L // bs)
                pool, kw = pool_of(g, S * MB + 1, Hkv, bs, D, quant, dev)
                bt = torch.arange(S * MB, dtype=torch.int32, device=dev).view(S, MB)
                ctx = torch.full((S,), L, dtype=torch.int32, device=dev)
                q0 = ctx - Cs
                qc = torch.randn(S, Cs, H, D, generator=g, device=dev).to(torch.bfloat16)
                kw["window"] = window
                lo = max(0, L - Cs - window + 1) if window else 0
                keys = S * (L - lo)
                vis = S * sum(min(L - Cs + r + 1, window or L) for r in range(Cs))
                per_key = 2 * D * (1 if quant else 2) + (8 if quant else 0)
                out[f"{label}{' int8' if quant else ''} L={L}"] = {
                    "k5_ms": cs.time_ms(lambda: paged_chunk_attention_batched(
                        qc, pool, bt, q0, ctx, **kw)),
                    "split4_ms": cs.time_ms(lambda: paged_chunk_attention_xla(
                        qc, pool, bt, q0, ctx, n_splits=4, **kw), 5, 1),
                    "bound_ms": cs.bound(keys * Hkv * per_key + 2 * qc.numel() * 2,
                                         4 * D * H * vis)[0]}
                del pool, kw
                torch.cuda.empty_cache()
    return out


def change_continuation_pass():
    """This repository's ``chip_smoke.continuation_pass``, loaded under
    another module name; it drives any tree's engine through the modules
    already imported."""
    spec = importlib.util.spec_from_file_location("k5_change_chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.continuation_pass


def run_phases(cs) -> None:
    """The tree's serving phases; continuation passes from this repository's
    chip_smoke.py where the tree's has none (on the phase's first engine,
    after the phase returns, with its sequences flushed)."""
    import torch
    own = getattr(cs, "continuation_pass", None)
    built = []
    if own is None:
        cont = change_continuation_pass()
        cls = sys.modules["deepspeed_tpu_torch.inference.v2.engine_v2"].InferenceEngineV2
        init = cls.__init__

        def recording(self, *args, **kw):
            init(self, *args, **kw)
            built.append(self)

        cls.__init__ = recording
    for fn, label, names in SERVING:
        getattr(cs, fn)()
        if own is None and built:
            engine = built[0]
            engine.flush(list(engine.scheduler.seqs))
            cont(engine, label, getattr(cs, names))
        built.clear()
        torch.cuda.empty_cache()


def time_tree(tree: str, phases: bool, do_sweep: bool) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops.kernels import _loader

    if not (_loader.__file__.startswith(root) and cs.__file__.startswith(root)):
        raise SystemExit(f"imported {_loader.__file__} and {cs.__file__}, not the tree at {root}")
    _loader.load_library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    head = {"tree": tree, "device": torch.cuda.get_device_name(0), "nvidia_smi": cs.smi_line()}
    if do_sweep:
        print("k5-sweep " + json.dumps({**head, "rows": sweep(cs, dev, g)}), flush=True)
        return
    rows, failed = {}, []

    def record(name, case, e, row=False, **extra):
        if not e["ok"]:
            failed.append([name, case, e["max_abs_err"]])
        if row and name.startswith(ROW_PREFIX):
            rows[name] = {"case": case, **{k: v for k, v in extra.items()
                                           if k in ("ms", "plain_ms", "bound_ms")}}

    checks = (lambda: chunk_7b_row(cs, dev, randn, record),
              lambda: cs.check_window_kernels(dev, randn, record),
              lambda: cs.check_alibi_kernels(dev, randn, record),
              lambda: cs.check_quant_kernels(dev, g, randn, record),
              lambda: cs.check_quant_window_kernels(dev, g, randn, record),
              lambda: cs.check_quant_alibi_kernels(dev, g, randn, record))
    for check in checks:
        try:
            check()
        except Exception:   # a failed check is reported with the tree's rows
            failed.append(traceback.format_exc(limit=2)[-600:])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print("k5-timing " + json.dumps({**head, "rows": rows, "failed": failed}), flush=True)
    print("k5-rungs " + json.dumps({**head, "passes": rungs(cs, dev, g)}), flush=True)
    if phases:
        run_phases(cs)


def main(argv) -> int:
    flags = [a for a in argv if a.startswith("--") and a != "--one"]
    argv = [a for a in argv if a not in flags]
    if argv[:1] == ["--one"]:
        time_tree(argv[1], "--phases" in flags, "--sweep" in flags)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    rc = 0
    for tree in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]
                             + flags).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
