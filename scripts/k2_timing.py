#!/usr/bin/env python3
"""Time the packed-prefill kernel (K2) of one or more trees of the port on
one GPU, at ``chip_smoke.py``'s two kernel-table shapes: Llama-2-7B's
prefill pass (768 rows, segments 300/200/150/100 plus padding, 32 heads,
D = 128) and Mistral-7B's (4640 rows, segments 4224/300/100 plus padding,
32/8 heads, window 4096). For each tree and shape it prints one ``k2-timing``
JSON line: CUDA events around 20 back-to-back launches with and without
the GPU sleep that lets the host enqueue them first (``chip_smoke.time_ms``;
without it a launch shorter than its host call is timed at the host's
rate), the profiler's device time of the kernel, and SDPA over the same
boolean mask timed the same three ways. With ``--phase9`` it also runs
``chip_smoke.run_mistral()`` (phase 9: Mistral-7B serving, whose prefill
pass profile names K2's device time) on that tree's package.

Run from the repository root, which holds ``chip_smoke.py``; each TREE is
a directory holding a ``deepspeed_tpu_torch/`` (``.``, or a ``git archive``
of another commit unpacked under ``_archive/``), timed in its own process,
in the order given (e.g. parent, change, change, parent):

    python3 scripts/k2_timing.py [--phase9] _archive/parent . . _archive/parent
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = (("unwindowed", 768, [300, 200, 150, 100], 32, 32, None),
          ("window", 4640, [4224, 300, 100], 32, 8, 4096))


def time_tree(tree: str, phase9: bool) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    sys.path.insert(1, os.getcwd())
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops.kernels import _loader, flash_attention_packed

    if not _loader.__file__.startswith(root):
        raise SystemExit(f"imported {_loader.__file__}, not the tree at {root}")
    _loader.load_library()
    g = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
    sleep = cs.SLEEP_CYCLES_PER_ITER
    for label, R, segs, H, Hkv, window in SHAPES:
        seg = cs.packed_segments(R, segs, "cuda")
        q, k, v = randn(R, H, 128), randn(R, Hkv, 128), randn(R, Hkv, 128)
        idx = torch.arange(R, device="cuda")
        mask = (idx[:, None] >= idx[None]) & (seg[:, None] == seg[None])
        if window:
            mask &= idx[:, None] - idx[None] < window
        qt = q.transpose(0, 1)[None]
        kt, vt = (x.repeat_interleave(H // Hkv, 1).transpose(0, 1)[None] for x in (k, v))
        out = {"tree": tree, "case": label, "rows": R, "heads": [H, Hkv], "window": window,
               "device": torch.cuda.get_device_name(0), "nvidia_smi": cs.smi_line()}
        for name, fn, kernel in (
                ("k2", lambda: flash_attention_packed(q, k, v, seg, window=window),
                 "flash_packed"),
                ("sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                 None)):
            for s in (0, sleep):
                cs.SLEEP_CYCLES_PER_ITER = s
                out[f"{name}_event_ms_sleep{s}"] = cs.time_ms(fn)
            cs.SLEEP_CYCLES_PER_ITER = sleep
            dt = cs.device_time(lambda: [fn() for _ in range(20)], [kernel] if kernel else [])
            out[f"{name}_profiler_ms"] = (dt["port_kernels_ms"][kernel] if kernel
                                          else dt["device_ms"]) / 20
        print("k2-timing " + json.dumps(out), flush=True)
        del q, k, v, qt, kt, vt, mask
    if phase9:
        torch.cuda.empty_cache()
        cs.run_mistral()


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        time_tree(argv[1], "--phase9" in argv)
        return 0
    phase9 = "--phase9" in argv
    trees = [a for a in argv if not a.startswith("--")]
    if not trees:
        raise SystemExit(__doc__)
    rc = 0
    for tree in trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree] + (
            ["--phase9"] if phase9 else [])
        rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
