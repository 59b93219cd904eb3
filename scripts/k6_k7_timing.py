#!/usr/bin/env python3
"""Time the paged decode kernel (K3/K4/K6) and K7's split-K pair in one or
more trees of the port on one GPU, at ``chip_smoke.py``'s kernel-table
shapes.

For each tree it runs that tree's own phase 3 checks that hold the decode
kernel and K7 (``chip_smoke.check_window_kernels``, ``check_side_kernels``,
``check_alibi_kernels``, ``check_quant_kernels``,
``check_quant_window_kernels`` and ``check_quant_alibi_kernels``) plus the
Llama-2-7B decode row (S = 4, 32/32 heads, D = 128, pages of 128, one side
row, as ``check_kernels`` builds it), and prints one ``k6-k7-timing`` JSON
line: each kernel-table row of ``paged_decode*``, ``paged_splitk*`` and
``splitk_merge`` with its case, ms, bound and plain ms
(``chip_smoke.time_ms``: CUDA events around back-to-back launches queued
behind a GPU sleep). A failed check is printed, not raised. With
``--phases`` it then runs that tree's ``chip_smoke.run_13b()`` (phase 6:
Llama-2-13B int8 serving, rung 8), ``run_mistral()`` (phase 9: Mistral-7B
bf16 under the window, rung 4) and ``run_mistral_lean()`` (phase 11: int4
weights and int8 KV), whose profile lines give the device time of a
decode step.

With ``--sweep`` it instead times both kernels against context length:
4 sequences of 256, 1024, 4096 and 8192 tokens each (pages of 128, D =
128) at Mistral-7B's heads (32 over 8) and Llama-2-13B's (40 over 40),
over bf16 and int8 pages, the decode kernel and K7 at 2/4/8 splits, each
beside its bound, on one ``k6-k7-sweep`` line; ``--clusters=N`` pins the
decode kernel's cluster size to N (and times only the decode kernel).

Run from the repository root; each TREE is a directory holding a
``deepspeed_tpu_torch/`` and its ``chip_smoke.py`` (``.``, or a ``git
archive`` of another commit unpacked under ``_archive/``), timed in its own
process, in the order given (e.g. parent, change, change, parent):

    python3 scripts/k6_k7_timing.py [--phases] _archive/parent . . _archive/parent
    python3 scripts/k6_k7_timing.py --sweep [--clusters=4] .
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import traceback

import numpy as np

ROW_PREFIXES = ("paged_decode", "paged_splitk", "splitk_merge")
SWEEP_LENS = (256, 1024, 4096, 8192)
SWEEP_SHAPES = (("Mistral-7B", 32, 8), ("Llama-2-13B", 40, 40))   # (label, H, Hkv)


def decode_7b_row(cs, dev, randn, record):
    """check_kernels' Llama-2-7B decode row: S = 4, one side row."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import (paged_decode_attention,
                                                 paged_decode_attention_plain)
    S, H, Hkv, D, bs, MB, C = 4, 32, 32, 128, 128, 16, 1
    rng = np.random.RandomState(S * 131 + Hkv + D + C)
    ctxs = [int(x) for x in rng.randint(1, 2049, size=S)]
    ctxs[0], ctxs[1] = 2048, 0
    NB = sum(-(-c // bs) for c in ctxs) + 2
    pool = randn(NB, 2, Hkv, bs, D)
    bt = cs.block_tables(ctxs, bs, MB, NB, dev)
    qd = randn(S, H, D)
    lens = torch.clamp(torch.tensor(ctxs, dtype=torch.int32, device=dev) - 1, min=0)
    side = (randn(S, C * Hkv, D), randn(S, C * Hkv, D))
    fn = lambda: paged_decode_attention(qd, pool, bt, lens, *side, j=0)
    out = fn()
    ref = paged_decode_attention_plain(qd, pool, bt, lens, *side, j=0)
    toks = int(lens.sum()) + S
    b_ms, b_by = cs.bound(toks * Hkv * D * 2 * 2 + 2 * qd.numel() * 2, 4 * D * H * toks)
    record("paged_decode", f"S={S} H={H} Hkv={Hkv} D={D} C={C} j=0", cs.err((out, ref)),
           row=True, ms=cs.time_ms(fn), plain_ms=None, library_ms=None, bound_ms=b_ms,
           bound_by=b_by)


def sweep(cs, dev, g, clusters) -> dict:
    """Decode kernel and K7 ms against context length (see the module doc)."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import paged_decode as pd
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention, splitk_attention
    from deepspeed_tpu_torch.ops.kernels.kv_quant import kv_quantize_rows, scales_to_tiles
    if clusters:
        pd.cluster_ranks = lambda S, Hkv, sms, quant=False: clusters
    S, D, bs = 4, 128, 128
    out = {}
    for label, H, Hkv in SWEEP_SHAPES:
        for quant in (False, True):
            for L in SWEEP_LENS:
                MB = L // bs
                x = torch.randn(S * MB + 1, 2, Hkv, bs, D, generator=g, device=dev)
                kw = {}
                if quant:
                    pool, scl = kv_quantize_rows(x)
                    kw["kv_scales"] = scales_to_tiles(scl).contiguous()
                else:
                    pool = x.to(torch.bfloat16)
                del x
                bt = torch.arange(S * MB, dtype=torch.int32, device=dev).view(S, MB)
                lens = torch.full((S,), L, dtype=torch.int32, device=dev)
                q = torch.randn(S, H, D, generator=g, device=dev).to(torch.bfloat16)
                r = {"decode_ms": cs.time_ms(lambda: paged_decode_attention(q, pool, bt, lens,
                                                                            **kw))}
                for n in (() if clusters else (2, 4, 8)):
                    r[f"splitk{n}_ms"] = cs.time_ms(
                        lambda: splitk_attention(q, pool, bt, lens, n, **kw))
                r["bound_ms"] = cs.bound(S * L * Hkv * (2 * D * (1 if quant else 2)
                                                        + (8 if quant else 0)), 0)[0]
                out[f"{label}{' int8' if quant else ''} L={L}"] = r
                del pool, kw
                torch.cuda.empty_cache()
    return out


def time_tree(tree: str, phases: bool, sweep_clusters=None) -> None:
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
    if sweep_clusters is not None:
        print("k6-k7-sweep " + json.dumps({
            "tree": tree, "device": torch.cuda.get_device_name(0), "nvidia_smi": cs.smi_line(),
            "clusters": sweep_clusters or "cluster_ranks",
            "rows": sweep(cs, dev, g, sweep_clusters)}), flush=True)
        return
    rows, failed = {}, []

    def record(name, case, e, row=False, **extra):
        if not e["ok"]:
            failed.append([name, case, e["max_abs_err"]])
        if row and name.startswith(ROW_PREFIXES):
            rows[name] = {"case": case, **{k: v for k, v in extra.items()
                                           if k in ("ms", "plain_ms", "bound_ms")}}

    checks = (lambda: decode_7b_row(cs, dev, randn, record),
              lambda: cs.check_window_kernels(dev, randn, record),
              lambda: cs.check_side_kernels(dev, randn, record),
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
    print("k6-k7-timing " + json.dumps({
        "tree": tree, "device": torch.cuda.get_device_name(0), "nvidia_smi": cs.smi_line(),
        "rows": rows, "failed": failed}), flush=True)
    if phases:
        for run in (cs.run_13b, cs.run_mistral, cs.run_mistral_lean):
            run()
            torch.cuda.empty_cache()


def main(argv) -> int:
    flags = [a for a in argv if a.startswith("--") and a != "--one"]
    argv = [a for a in argv if a not in flags]
    phases = "--phases" in flags
    sweep_clusters = None
    if "--sweep" in flags:
        sweep_clusters = next((int(f.split("=", 1)[1]) for f in flags
                               if f.startswith("--clusters=")), 0)
    if argv[:1] == ["--one"]:
        time_tree(argv[1], phases, sweep_clusters)
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
