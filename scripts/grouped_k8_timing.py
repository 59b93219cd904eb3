#!/usr/bin/env python3
"""Time K8's two grouped entries, the grouped gemv and the grouped
``wgmma`` product, at the same row counts, to place the cut between them
(``quantized_matmul.GROUPED_GEMV_MAX_R``: the wrapper takes the gemv up
to that many rows). One GPU, Mixtral-8x7B's expert shapes: gate/up (4096
-> 14336) and down (14336 -> 4096), 8 experts; R rows are R / 2 tokens,
each routed to 2 distinct experts drawn at random (seed 0), sorted by
expert as ``_moe_ffn`` sorts them; and, the gemv's worst case, R rows all
in one expert (``SKEWED``).

For each (shape, R) it prints one ``grouped-k8-timing`` JSON line: both
kernels' ms (``chip_smoke.time_ms``: CUDA events around back-to-back
launches queued behind a GPU sleep), ``torch._grouped_mm`` on the bf16
weights, the rows per expert, the bound over the routed experts' bytes
(``chip_smoke.bound``), and the card's name and power limit. Both outputs
are held against the plain version (``chip_smoke.err``); a disagreement
fails the run. Run from the repository root:

    python3 scripts/grouped_k8_timing.py [R ...]   (R given: both routings at each)
"""

from __future__ import annotations

import json
import os
import sys

ROWS = (8, 16, 24, 32, 34, 40, 48, 64, 96, 128)
SKEWED = (16, 32, 64, 96, 128)


def main(rows, skewed) -> int:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.inference.v2.ragged_model import quantize_weight_int8
    from deepspeed_tpu_torch.ops.kernels import _loader
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import (
        GROUPED_GEMV_MAX_R, _grouped_gemv, _grouped_mma, quantized_matmul_grouped_plain)

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    _loader.load_library()
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    E, smi, ok = 8, cs.smi_line(), True
    for label, K, N in (("gate/up", cs.MOE_HID, cs.MOE_FF), ("down", cs.MOE_FF, cs.MOE_HID)):
        w = torch.randn(E, K, N, generator=g, device="cuda") * K ** -0.5
        q = quantize_weight_int8(w)
        wb = w.to(torch.bfloat16)
        del w
        w8, s = q["w8"], q["scale"].reshape(E, N)
        cases = [(R, "uniform") for R in rows] + [(R, "one expert") for R in skewed]
        for R, routing in cases:
            if routing == "uniform":
                experts = np.stack([rng.choice(E, 2, replace=False) for _ in range(R // 2)])
                counts = np.bincount(experts.reshape(-1), minlength=E)
            else:
                counts = np.zeros(E, np.int64)
                counts[3] = R
            ends = torch.tensor(np.cumsum(counts), dtype=torch.int32, device="cuda")
            a = (torch.randn(int(counts.sum()), K, generator=g, device="cuda")
                 .to(torch.bfloat16))
            Rr = a.shape[0]
            ref = quantized_matmul_grouped_plain(a, ends, w8, s)
            errs = {n: cs.err((f(a, ends, w8, s), ref))
                    for n, f in (("gemv", _grouped_gemv), ("mma", _grouped_mma))}
            routed = int((counts > 0).sum())
            b_ms, b_by = cs.bound(routed * (K * N + 4 * N) + 2 * Rr * K + 2 * Rr * N + 4 * E,
                                  2 * Rr * K * N)
            line = {"shape": label, "K": K, "N": N, "R": Rr, "routing": routing,
                    "rows_per_expert": counts.tolist(),
                    "routed_experts": routed,
                    "gemv_ms": cs.time_ms(lambda: _grouped_gemv(a, ends, w8, s)),
                    "mma_ms": cs.time_ms(lambda: _grouped_mma(a, ends, w8, s)),
                    "grouped_mm_bf16_ms": cs.time_ms(
                        lambda: torch._grouped_mm(a, wb, offs=ends)),
                    "bound_ms": b_ms, "bound_by": b_by, "wrapper_takes":
                    "gemv" if Rr <= GROUPED_GEMV_MAX_R else "mma",
                    "max_abs_err": {n: e["max_abs_err"] for n, e in errs.items()},
                    "nvidia_smi": smi}
            print("grouped-k8-timing " + json.dumps(line), flush=True)
            ok = ok and all(e["ok"] for e in errs.values())
        del w8, s, wb, q
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    rows = [int(r) for r in sys.argv[1:]]
    sys.exit(main(rows or ROWS, rows or SKEWED))
