#!/usr/bin/env python3
"""Time K9's backward, the block-sparse op and K8's ``qmm_mma`` of one or
more trees of the port on one GPU, at ``chip_smoke.py``'s kernel-table
shapes: K9's dq and dk/dv and ``sparse_self_attention`` forward and
forward + backward at phase 7's layout A (B = 2, H = 16, S = 4096, D =
64); K8 at Llama-2-13B's gate/up (M = 736, 5120 -> 13824) and on
Mistral-7B's unpacked int4 gate/up (M = 4224, 4096 -> 14336), each beside
``torch.matmul`` on the bf16 weight. For each tree it prints one
``k8-k9-timing`` JSON line (``chip_smoke.time_ms``: CUDA events around
back-to-back launches queued behind a GPU sleep; the op also one call at
a time on the host's clock). With ``--phase6`` it
also runs ``chip_smoke.run_13b()`` (phase 6: Llama-2-13B int8 serving,
whose profile of a 736-token prefill pass names K8's device time) on that
tree's package.

Run from the repository root, which holds ``chip_smoke.py``; each TREE is
a directory holding a ``deepspeed_tpu_torch/`` (``.``, or a ``git archive``
of another commit unpacked under ``_archive/``), timed in its own process,
in the order given (e.g. parent, change, change, parent):

    python3 scripts/k8_k9_timing.py [--phase6] _archive/parent . . _archive/parent
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

QMM = (("13B gate/up", 736, 5120, 13824, 8), ("Mistral int4 gate/up", 4224, 4096, 14336, 4))


def wall_ms(fn, n: int = 5) -> float:
    """Median host ms of ``n`` calls of ``fn``, each between device syncs."""
    import torch
    fn()
    runs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return sorted(runs)[n // 2]


def time_tree(tree: str, phase6: bool) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    sys.path.insert(1, os.getcwd())
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.inference.v2.ragged_model import (quantize_weight_int4,
                                                               quantize_weight_int8)
    from deepspeed_tpu_torch.ops import sparse_self_attention
    from deepspeed_tpu_torch.ops.kernels import (_loader, block_sparse_delta,
                                                 block_sparse_dkv, block_sparse_dq,
                                                 block_sparse_fwd, get_tables)
    from deepspeed_tpu_torch.ops.kernels.quantized_matmul import quantized_matmul
    from deepspeed_tpu_torch.ops.quantizer import unpack_int4

    if not _loader.__file__.startswith(root):
        raise SystemExit(f"imported {_loader.__file__}, not the tree at {root}")
    _loader.load_library()
    g = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "nvidia_smi": cs.smi_line()}

    label, cfg, S, D, _ = cs.sparse_cases()[0]
    B, H = cs.SPARSE_B, cs.SPARSE_H
    tables = get_tables(cfg.make_layout(S), cfg.block, False, S, "cuda")
    scale = D ** -0.5
    q, k, v, do = (randn(B, H, S, D) for _ in range(4))
    o, lse = block_sparse_fwd(q, k, v, tables, scale)
    delta = block_sparse_delta(o, do)
    out["k9_dq_ms"] = cs.time_ms(lambda: block_sparse_dq(q, k, v, do, lse, delta, tables,
                                                         scale), 10)
    out["k9_dkv_ms"] = cs.time_ms(lambda: block_sparse_dkv(q, k, v, do, lse, delta, tables,
                                                           scale), 10)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out["op_fwd_ms"] = cs.time_ms(lambda: sparse_self_attention(q, k, v, cfg), 10)
    out["op_fwd_bwd_ms"] = cs.time_ms(
        lambda: sparse_self_attention(qg, kg, vg, cfg).backward(do), 10)
    # one call at a time on the host's clock (the queued launches above hide
    # host work behind the device's): median of 5
    out["op_fwd_wall_ms"] = wall_ms(lambda: sparse_self_attention(q, k, v, cfg))
    out["op_fwd_bwd_wall_ms"] = wall_ms(
        lambda: sparse_self_attention(qg, kg, vg, cfg).backward(do))
    out["make_layout_ms"] = cs.time_ms(lambda: cfg.make_layout(S), 3, 1)
    del q, k, v, do, o, lse, delta, qg, kg, vg

    for name, M, K, N, bits in QMM:
        a = randn(M, K)
        w = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
        if bits == 8:
            qd = quantize_weight_int8(w)
            w8 = qd["w8"]
        else:
            qd = quantize_weight_int4(w)
            w8 = unpack_int4(qd["w4"])
        wb = w.to(torch.bfloat16)
        del w
        out[f"k8 {name} ms"] = cs.time_ms(lambda: quantized_matmul(a, w8, qd["scale"]))
        out[f"cublas bf16 {name} ms"] = cs.time_ms(lambda: torch.matmul(a, wb))
        del a, wb, w8, qd
    print("k8-k9-timing " + json.dumps(out), flush=True)
    if phase6:
        torch.cuda.empty_cache()
        cs.run_13b()


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        time_tree(argv[1], "--phase6" in argv)
        return 0
    phase6 = "--phase6" in argv
    trees = [a for a in argv if not a.startswith("--")]
    if not trees:
        raise SystemExit(__doc__)
    rc = 0
    for tree in trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", tree] + (
            ["--phase6"] if phase6 else [])
        rc |= subprocess.run(cmd).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
