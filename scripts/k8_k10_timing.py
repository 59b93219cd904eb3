#!/usr/bin/env python3
"""Time K10's forward and K8's decode matmul (``qmm_gemv``, int8 and packed
int4) in one or more trees of the port on one GPU, at ``chip_smoke.py``'s
kernel-table shapes:

- K10's forward at phase 8's MSA row shape (L = 512, S = 384, H = 8, D =
  32, R = 512, bf16 pair bias, the mask bias) beside SDPA (efficient
  backend, float bias [L, H, S, S] bf16); ``DS4Sci_EvoformerAttention``
  MSA row forward and forward + backward, and the triangle attention
  (starting node) forward and forward + backward at 384 x 384, H = 4;
- K8 at Llama-2-13B's gate/up (5120 -> 13824) at M = 1, 4 and 8, and the
  engine's ``_mm`` over Mistral-7B's packed int4 gate/up (4096 -> 14336)
  at M = 4, each beside ``torch.matmul`` on the bf16 weight.

For each tree it prints one ``k8-k10-timing`` JSON line (``chip_smoke.time_ms``:
CUDA events around back-to-back launches queued behind a GPU sleep). With
``--phases`` it then runs that tree's ``chip_smoke.run_13b()`` (phase 6:
Llama-2-13B int8 serving) and ``run_mistral_lean()`` (phase 11: Mistral-7B
int4 weights and int8 KV), whose profile lines give the device time of a
decode step.

Run from the repository root; each TREE is a directory holding a
``deepspeed_tpu_torch/`` and its ``chip_smoke.py`` (``.``, or a ``git archive``
of another commit unpacked under ``_archive/``), timed in its own process,
in the order given (e.g. parent, change, change, parent):

    python3 scripts/k8_k10_timing.py [--phases] _archive/parent . . _archive/parent
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

GEMV_MS = (1, 4, 8)


def time_tree(tree: str, phases: bool) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import chip_smoke as cs
    from deepspeed_tpu_torch.inference.v2.ragged_model import (_mm, quantize_weight_int4,
                                                               quantize_weight_int8)
    from deepspeed_tpu_torch.ops import (DS4Sci_EvoformerAttention, msa_row_attention_mask_bias,
                                         triangle_attention_starting_node)
    from deepspeed_tpu_torch.ops.kernels import _loader, evoformer_fwd, quantized_matmul

    if not (_loader.__file__.startswith(root) and cs.__file__.startswith(root)):
        raise SystemExit(f"imported {_loader.__file__} and {cs.__file__}, not the tree at {root}")
    _loader.load_library()
    g = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "nvidia_smi": cs.smi_line()}

    # ---- K10's forward and the Evoformer op ---- #
    L, S, H, D, R = cs.EVO_CLUST, cs.EVO_RES, cs.EVO_MSA_H, cs.EVO_D, cs.EVO_CLUST
    scale = D ** -0.5
    q, k, v, do = (randn(L, S, H, D) for _ in range(4))
    pair = randn(1, H, S, S)
    keep = cs.keep_mask(g, (L, S), 1)
    mask = torch.where(keep > 0, 0.0, -1e9)
    out["k10_fwd_ms"] = cs.time_ms(lambda: evoformer_fwd(q, k, v, mask, pair, scale, R), 10, 2)
    bhsd = lambda t: t.transpose(1, 2)
    bias = (pair[:, None] + mask.to(torch.bfloat16).view(1, R, 1, 1, S)).view(L, H, S, S)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out["sdpa_fwd_msa_ms"] = cs.time_ms(lambda: F.scaled_dot_product_attention(
            bhsd(q), bhsd(k), bhsd(v), attn_mask=bias), 10, 2)
    del bias
    msa_shape = (1, L, S, H, D)
    bias1 = msa_row_attention_mask_bias(keep.view(1, L, S))
    Q, K, V = (t.view(msa_shape).detach().clone().requires_grad_() for t in (q, k, v))
    b2 = pair.view(1, 1, H, S, S).detach().clone().requires_grad_()
    msa = lambda: DS4Sci_EvoformerAttention(Q, K, V, [bias1, b2], fused=True)
    out["evoformer_op_fwd_ms"] = cs.time_ms(msa, 5, 1)
    out["evoformer_op_fwd_bwd_ms"] = cs.time_ms(
        lambda: torch.autograd.grad(msa(), (Q, K, V, b2), do.view(msa_shape)), 5, 1)
    del q, k, v, do, Q, K, V, b2
    Ht = cs.EVO_TRI_H
    zq, zk, zv = (randn(1, S, S, Ht, D).requires_grad_() for _ in range(3))
    dz = randn(1, S, S, Ht, D)
    pb = randn(1, Ht, S, S).requires_grad_()
    pair_mask = cs.keep_mask(g, (1, S, S), (0, 1))
    tri = lambda: triangle_attention_starting_node(zq, zk, zv, pb, pair_mask)
    out["triangle_start_fwd_ms"] = cs.time_ms(tri, 5, 1)
    out["triangle_start_fwd_bwd_ms"] = cs.time_ms(
        lambda: torch.autograd.grad(tri(), (zq, zk, zv, pb), dz), 5, 1)
    del zq, zk, zv, dz, pb
    torch.cuda.empty_cache()

    # ---- K8's gemv, int8 and packed int4 ---- #
    K, N = 5120, 13824
    w = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
    qd = quantize_weight_int8(w)
    wb = w.to(torch.bfloat16)
    del w
    for M in GEMV_MS:
        a = randn(M, K)
        out[f"gemv_M{M}_ms"] = cs.time_ms(lambda: quantized_matmul(a, qd["w8"], qd["scale"]))
        out[f"cublas_bf16_M{M}_ms"] = cs.time_ms(lambda: torch.matmul(a, wb))
    del qd, wb
    K, N = 4096, 14336
    w = torch.randn(K, N, generator=g, device="cuda") * K ** -0.5
    qd = quantize_weight_int4(w)
    wb = w.to(torch.bfloat16)
    del w
    a = randn(4, K)
    out["int4_mm_M4_ms"] = cs.time_ms(lambda: _mm(a, qd))
    out["int4_cublas_bf16_M4_ms"] = cs.time_ms(lambda: torch.matmul(a, wb))
    del qd, wb
    torch.cuda.empty_cache()
    print("k8-k10-timing " + json.dumps(out), flush=True)
    if phases:
        cs.run_13b()
        torch.cuda.empty_cache()
        cs.run_mistral_lean()


def main(argv) -> int:
    phases = "--phases" in argv
    argv = [a for a in argv if a != "--phases"]
    if argv[:1] == ["--one"]:
        time_tree(argv[1], phases)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    rc = 0
    for tree in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]
                             + (["--phases"] if phases else [])).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
