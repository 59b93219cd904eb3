#!/usr/bin/env python3
"""Time K9's forward, K10's backward and their two ops in one or more trees
of the port on one GPU, at ``chip_smoke.py``'s kernel-table shapes:

- K9's forward at phase 7's layouts A, B and C (B = 2, H = 16, S = 4096,
  D = 64), beside SDPA (efficient backend) over layout A's boolean token
  mask; ``sparse_self_attention`` forward and forward + backward at A;
- K10's dq, dk/dv and d(pair) at phase 8's MSA row shape (L = 512, S =
  384, H = 8, D = 32, R = 512, bf16 pair bias, the mask bias), beside
  SDPA's backward alone (efficient backend, float bias [L, H, S, S] bf16,
  d(bias) reduced to d(pair)); ``DS4Sci_EvoformerAttention`` MSA row
  forward and forward + backward.

For each tree it prints one ``k9-k10-timing`` JSON line (``chip_smoke.time_ms``:
CUDA events around back-to-back launches queued behind a GPU sleep). Run
from the repository root, which holds ``chip_smoke.py``; each TREE is a
directory holding a ``deepspeed_tpu_torch/`` (``.``, or a ``git archive`` of
another commit unpacked under ``_archive/``), timed in its own process, in
the order given (e.g. parent, change, change, parent):

    python3 scripts/k9_k10_timing.py _archive/parent . . _archive/parent
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def time_tree(tree: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    sys.path.insert(1, os.getcwd())
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import (DS4Sci_EvoformerAttention, msa_row_attention_mask_bias,
                                         sparse_self_attention)
    from deepspeed_tpu_torch.ops.kernels import (_loader, block_sparse_fwd, evoformer_dbias,
                                                 evoformer_delta, evoformer_dkv, evoformer_dq,
                                                 evoformer_fwd, get_tables)

    if not _loader.__file__.startswith(root):
        raise SystemExit(f"imported {_loader.__file__}, not the tree at {root}")
    _loader.load_library()
    g = torch.Generator(device="cuda").manual_seed(7)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "nvidia_smi": cs.smi_line()}

    # ---- K9's forward and the sparse op ---- #
    B, H = cs.SPARSE_B, cs.SPARSE_H
    for label, cfg, S, D, timed in cs.sparse_cases():
        if not timed:
            continue
        causal = cfg.attention == "unidirectional"
        tables = get_tables(cfg.make_layout(S), cfg.block, causal, S, "cuda")
        q, k, v, do = (randn(B, H, S, D) for _ in range(4))
        tag = label[:1]
        out[f"k9_fwd_{tag}_ms"] = cs.time_ms(
            lambda: block_sparse_fwd(q, k, v, tables, D ** -0.5), 10)
        if tag == "A":
            mask = tables.token_mask("cuda")[torch.arange(H, device="cuda") %
                                             tables.num_layout_heads]
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                out["sdpa_fwd_A_ms"] = cs.time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask[None]))
            del mask
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            out["sparse_op_fwd_ms"] = cs.time_ms(lambda: sparse_self_attention(q, k, v, cfg), 10)
            out["sparse_op_fwd_bwd_ms"] = cs.time_ms(
                lambda: sparse_self_attention(qg, kg, vg, cfg).backward(do), 10)
            del qg, kg, vg
        del q, k, v, do
    torch.cuda.empty_cache()

    # ---- K10's backward and the Evoformer op ---- #
    L, S, H, D, R = cs.EVO_CLUST, cs.EVO_RES, cs.EVO_MSA_H, cs.EVO_D, cs.EVO_CLUST
    scale = D ** -0.5
    q, k, v, do = (randn(L, S, H, D) for _ in range(4))
    pair = randn(1, H, S, S)
    keep = cs.keep_mask(g, (L, S), 1)
    mask = torch.where(keep > 0, 0.0, -1e9)
    o, lse = evoformer_fwd(q, k, v, mask, pair, scale, R)
    args = (q, k, v, mask, pair, do, lse, evoformer_delta(o, do), scale, R)
    for name, fn in (("dq", evoformer_dq), ("dkv", evoformer_dkv), ("dbias", evoformer_dbias)):
        out[f"k10_{name}_ms"] = cs.time_ms(lambda: fn(*args), 10, 2)
    out["k10_bwd_sum_ms"] = out["k10_dq_ms"] + out["k10_dkv_ms"] + out["k10_dbias_ms"]
    bhsd = lambda t: t.transpose(1, 2)
    mask_bf = mask.to(torch.bfloat16).view(1, R, 1, 1, S)
    qg, kg, vg = (bhsd(t).detach().requires_grad_() for t in (q, k, v))
    pg = pair.detach().requires_grad_()
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        sdpa = F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=(pg[:, None] + mask_bf).view(L, H, S, S))
        out["sdpa_bwd_msa_ms"] = cs.time_ms(lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg, pg), bhsd(do), retain_graph=True), 5, 1)
    del sdpa, qg, kg, vg, pg, o, lse, args
    torch.cuda.empty_cache()
    msa_shape = (1, L, S, H, D)
    bias1 = msa_row_attention_mask_bias(keep.view(1, L, S))
    Q, K, V = (t.view(msa_shape).detach().clone().requires_grad_() for t in (q, k, v))
    dO = do.view(msa_shape)
    b2 = pair.view(1, 1, H, S, S).detach().clone().requires_grad_()
    msa = lambda: DS4Sci_EvoformerAttention(Q, K, V, [bias1, b2], fused=True)
    out["evoformer_op_fwd_ms"] = cs.time_ms(msa, 5, 1)
    out["evoformer_op_fwd_bwd_ms"] = cs.time_ms(
        lambda: torch.autograd.grad(msa(), (Q, K, V, b2), dO), 5, 1)
    print("k9-k10-timing " + json.dumps(out), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        time_tree(argv[1])
        return 0
    if not argv:
        raise SystemExit(__doc__)
    rc = 0
    for tree in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
