"""Weight-only int8 matmul (K8): CUDA kernels ``csrc/quantized_matmul.cu``
and their plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/quantized_matmul.py``
``quantized_matmul`` (:82): ``a [M, K] @ (w8 [K, N] int8 * scale[N])`` with
the sum in f32 and the per-column f32 scale applied once to it, the
function of the v2 engine's int8 ``_mm`` (``inference/v2/ragged_model.py``).
Every projection and the LM head of an engine built with
``quantization.weight_bits = 8`` runs here.

Two kernels, picked by M: ``qmm_gemv`` for M <= 8 (the decode step; bound
by the K*N weight bytes it streams, with the K range split across blocks
and the partial sums added by the last block of each column group), and
``qmm_mma`` for larger M (the prefill passes; bf16 tensor-core tiles with
the int8 tile converted in shared memory).
"""

from __future__ import annotations

from typing import Dict

import torch

from deepspeed_tpu_torch.ops.kernels import _loader

NAME = "quantized_matmul"
GEMV = "quantized_matmul_gemv"
MMA = "quantized_matmul_mma"
SOURCE = "deepspeed_tpu_torch/csrc/quantized_matmul.cu"
REPLACES = "deepspeed_tpu/ops/pallas/quantized_matmul.py:82 (body _qmm_kernel :64)"
GEMV_MAX_M = 8
_GEMV_COLS = 128         # columns per gemv block
_GEMV_MAX_ROWS = 512     # K rows per gemv split
_TARGET_BLOCKS = 264     # two blocks per SM of an H100

# per-device column-group counters of the gemv split-K reduction; each
# launch leaves them at 0 for the next
_counters: Dict[torch.device, torch.Tensor] = {}


def _gemv_counters(device: torch.device, n: int) -> torch.Tensor:
    c = _counters.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[device] = c
    return c


def gemv_splits(K: int, N: int):
    """(rows per split, splits) of the gemv kernel's K range: at most 512
    rows a split, and enough splits for about two blocks per SM (eight per
    SM measured slower on an H100: the split partials' extra traffic)."""
    col_blocks = -(-N // _GEMV_COLS)
    n = max(-(-K // _GEMV_MAX_ROWS), -(-_TARGET_BLOCKS // col_blocks))
    n = min(n, max(1, K // 32))
    rows = -(-K // n)
    return rows, -(-K // rows)


def quantized_matmul(a: torch.Tensor, w8: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``a [..., K]`` @ ``w8 [K, N]`` int8 with column scales ``scale``
    ([N] or [1, N] f32) -> ``[..., N]`` in a's dtype.

    CPU tensors run :func:`quantized_matmul_plain`; CUDA tensors launch a
    kernel (bf16 a, contiguous) or raise."""
    K, N = w8.shape
    if a.shape[-1] != K or scale.numel() != N or w8.dtype != torch.int8:
        raise ValueError(f"{NAME}: bad shapes a {tuple(a.shape)} w8 "
                         f"{tuple(w8.shape)} {w8.dtype} scale {tuple(scale.shape)}")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, K)
    M = a2.shape[0]
    s = scale.reshape(N)
    if _loader.on_cpu(NAME, a2, w8, s):
        return quantized_matmul_plain(a2, w8, s).reshape(*lead, N)
    a2 = a2.contiguous()
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if M == 0:
        return out.reshape(*lead, N)
    P = _loader.ptr
    if M <= GEMV_MAX_M:
        _loader.check_cuda(GEMV, a2.dtype, f32=("scale",), i8=("w8",), a=a2, w8=w8,
                           scale=s)
        rows, n_splits = gemv_splits(K, N)
        work = torch.empty((n_splits, M, N) if n_splits > 1 else (1,),
                           dtype=torch.float32, device=a.device)
        counters = _gemv_counters(a.device, -(-N // _GEMV_COLS))
        _loader.launch(GEMV, "dstorch_qmm_gemv", a.device, P(a2), P(w8), P(s), P(out),
                       P(work), P(counters), M, K, N, rows, n_splits)
    else:
        _loader.check_cuda(MMA, a2.dtype, f32=("scale",), i8=("w8",), a=a2, w8=w8,
                           scale=s)
        _loader.launch(MMA, "dstorch_qmm_mma", a.device, P(a2), P(w8), P(s), P(out),
                       M, K, N)
    return out.reshape(*lead, N)


def quantized_matmul_plain(a: torch.Tensor, w8: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the JAX package's
    ``quantized_matmul_reference``): ``a @ (w8 * scale)`` in f32, cast to
    a's dtype."""
    w = w8.float() * scale.reshape(1, -1).float()
    return (a.float() @ w).to(a.dtype)
