"""Weight-only int8 matmul (K8): CUDA kernels ``csrc/quantized_matmul.cu``
and their plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/quantized_matmul.py``
``quantized_matmul`` (:82): ``a [M, K] @ (w8 [K, N] int8 * scale[N])`` with
the sum in f32 and the per-column f32 scale applied once to it, the
function of the v2 engine's int8 ``_mm`` (``inference/v2/ragged_model.py``).
Every projection and the LM head of an engine built with
``quantization.weight_bits = 8`` runs here.

Two kernels, picked by M: ``qmm_gemv`` for M <= 8 (the decode step; bound
by the K*N weight bytes it streams, its K range split across one wave of
blocks sized from the SM count and the partial sums added in split order
by the last block of each column group), and ``qmm_mma`` for larger M (the
prefill passes; bf16 tensor-core tiles with the int8 tile converted in
shared memory).

Packed int4 weights (``quantization.weight_bits = 4``: ``w4 [K/2, N]``, two
values a byte as ``ops/quantizer.pack_int4`` stores them) go through
:func:`quantized_matmul_int4`: at M <= 8 the same ``qmm_gemv`` body reads
the packed bytes in the kernel (launches counted as
``quantized_matmul_gemv_int4``; the same sums in the same order, so the same
bits, as ``qmm_gemv`` on the unpacked weight); at larger M the weight is
unpacked in torch ops and ``qmm_mma`` runs on it.

An MoE layer's int8 expert products go through
:func:`quantized_matmul_grouped`: rows sorted by expert, the groups' ends on
the device, each row times its expert's weight and scale (the int8 branch
of the JAX package's ``_moe_ffn`` ``gg``). Its two entries are grouped
forms of the same kernels, picked from the row count R (a shape, never
from the group sizes, which live on the device): ``qmm_gemv_grouped``
(``quantized_matmul_grouped_gemv``) for R <= 32, a block per (128 columns,
K split, expert) that exits at once when its expert has no rows, so a
decode step reads only the routed experts' weights; and ``qmm_mma`` on a
tile schedule that each block reads from the ends
(``quantized_matmul_grouped_mma``) above.
"""

from __future__ import annotations

from typing import Dict

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
from deepspeed_tpu_torch.ops.quantizer import unpack_int4

NAME = "quantized_matmul"
GEMV = "quantized_matmul_gemv"
GEMV_INT4 = "quantized_matmul_gemv_int4"
MMA = "quantized_matmul_mma"
GROUPED_GEMV = "quantized_matmul_grouped_gemv"
GROUPED_MMA = "quantized_matmul_grouped_mma"
SOURCE = "deepspeed_tpu_torch/csrc/quantized_matmul.cu"
REPLACES = "deepspeed_tpu/ops/pallas/quantized_matmul.py:82 (body _qmm_kernel :64)"
REPLACES_INT4 = ("deepspeed_tpu/inference/v2/ragged_model.py:427-436 (_mm's w4 branch: "
                 "unpack_int4, then the int8 dot of quantized_matmul.py:82)")
REPLACES_GROUPED = ("deepspeed_tpu/inference/v2/ragged_model.py:382-393 (_moe_ffn's gg, int8 "
                    "branch: ragged_dot over w8 times the row's expert's scale) with "
                    "deepspeed_tpu/ops/pallas/quantized_matmul.py:82")
GEMV_MAX_M = 8
GROUPED_GEMV_MAX_R = 32  # rows up to which the grouped gemv runs (4 passes a weight at most)
_GEMV_COLS = 128         # columns per gemv block
_GEMV_ROWS = 128         # a split's K rows are a multiple of this: 16 per warp step x 8 warps
_GEMV_BLOCKS_PER_SM = 2  # resident gemv blocks an SM (its launch bounds)
H100_SMS = _loader.H100_SMS

# per-device column-group counters of the gemv split-K reduction; each
# launch leaves them at 0 for the next
_counters: Dict[torch.device, torch.Tensor] = {}


def _gemv_counters(device: torch.device, n: int) -> torch.Tensor:
    c = _counters.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[device] = c
    return c


def gemv_splits(K: int, N: int, sms: int = H100_SMS):
    """(rows per split, splits) of the gemv kernel's K range: one wave of
    at most ``2 * sms`` blocks (128-column groups x splits), each split a
    multiple of 128 rows (16 a warp step, 8 warps), the last one ragged.
    Split s covers rows ``[s * rows, min(K, (s + 1) * rows))``."""
    col_blocks = -(-N // _GEMV_COLS)
    units = max(1, -(-K // _GEMV_ROWS))
    n = max(1, min(units, (_GEMV_BLOCKS_PER_SM * sms) // col_blocks))
    rows = _GEMV_ROWS * -(-units // n)
    return rows, max(1, -(-K // rows))


def _launch_gemv(kernel: str, entry: str, a2, w, s, K: int, N: int) -> torch.Tensor:
    """One qmm_gemv launch (int8 ``w`` or packed int4) on [M <= 8, K] a."""
    M = a2.shape[0]
    out = torch.empty((M, N), dtype=a2.dtype, device=a2.device)
    rows, n_splits = gemv_splits(K, N, _loader.sm_count(a2.device))
    work = torch.empty((n_splits, M, N) if n_splits > 1 else (1,),
                       dtype=torch.float32, device=a2.device)
    counters = _gemv_counters(a2.device, -(-N // _GEMV_COLS))
    P = _loader.ptr
    _loader.launch(kernel, entry, a2.device, P(a2), P(w), P(s), P(out), P(work),
                   P(counters), M, K, N, rows, n_splits)
    return out


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
    if M == 0:
        return torch.empty((0, N), dtype=a.dtype, device=a.device).reshape(*lead, N)
    if M <= GEMV_MAX_M:
        _loader.check_cuda(GEMV, a2.dtype, f32=("scale",), i8=("w8",), a=a2, w8=w8,
                           scale=s)
        out = _launch_gemv(GEMV, "dstorch_qmm_gemv", a2, w8, s, K, N)
    else:
        _loader.check_cuda(MMA, a2.dtype, f32=("scale",), i8=("w8",), a=a2, w8=w8,
                           scale=s)
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
        P = _loader.ptr
        _loader.launch(MMA, "dstorch_qmm_mma", a.device, P(a2), P(w8), P(s), P(out),
                       M, K, N)
    return out.reshape(*lead, N)


def quantized_matmul_int4(a: torch.Tensor, w4: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``a [..., K]`` @ the packed int4 weight ``w4 [K/2, N]`` (int8 bytes,
    row 2i in byte i's low nibble, 2i + 1 in its high one) with column scales
    ``scale`` ([N] or [1, N] f32) -> ``[..., N]`` in a's dtype: the function
    of ``quantized_matmul(a, unpack_int4(w4), scale)``.

    CPU tensors run :func:`quantized_matmul_int4_plain`; CUDA tensors at M
    <= 8 launch ``qmm_gemv`` on the packed bytes (bf16 a, contiguous), at
    larger M unpack the weight and run :func:`quantized_matmul`."""
    Kh, N = w4.shape
    K = a.shape[-1]
    if w4.dtype != torch.int8 or K % 2 or K != 2 * Kh or scale.numel() != N:
        raise ValueError(f"{GEMV_INT4}: bad shapes a {tuple(a.shape)} w4 "
                         f"{tuple(w4.shape)} {w4.dtype} scale {tuple(scale.shape)}")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, K)
    M = a2.shape[0]
    s = scale.reshape(N)
    if _loader.on_cpu(GEMV_INT4, a2, w4, s):
        return quantized_matmul_int4_plain(a2, w4, s).reshape(*lead, N)
    if M == 0 or M > GEMV_MAX_M:
        return quantized_matmul(a2, unpack_int4(w4, axis=-2), s).reshape(*lead, N)
    a2 = a2.contiguous()
    _loader.check_cuda(GEMV_INT4, a2.dtype, f32=("scale",), i8=("w4",), a=a2, w4=w4,
                       scale=s)
    return _launch_gemv(GEMV_INT4, "dstorch_qmm_gemv_int4", a2, w4, s, K, N).reshape(
        *lead, N)


def quantized_matmul_grouped(a: torch.Tensor, ends: torch.Tensor, w8: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """Rows ``a [R, K]`` sorted by expert times their expert's int8 weight:
    expert e's rows are ``[ends[e - 1], ends[e])`` (``ends [E]`` int32, the
    cumulative row counts, ``ends[E - 1] == R``), ``w8 [E, K, N]`` int8 and
    ``scale [E, 1, N]`` f32 -> ``[R, N]`` in a's dtype, row r of expert e
    ``(a[r] @ w8[e]) * scale[e]`` with the sum in f32.

    CPU tensors run :func:`quantized_matmul_grouped_plain`; CUDA tensors
    launch a kernel (bf16 a, contiguous), chosen from R alone: nothing
    here reads ``ends`` on the host."""
    E, K, N = w8.shape
    R = a.shape[0]
    if (a.dim() != 2 or a.shape[1] != K or scale.numel() != E * N or ends.numel() != E
            or w8.dtype != torch.int8):
        raise ValueError(f"{GROUPED_MMA}: bad shapes a {tuple(a.shape)} ends "
                         f"{tuple(ends.shape)} w8 {tuple(w8.shape)} {w8.dtype} scale "
                         f"{tuple(scale.shape)}")
    s = scale.reshape(E, N)
    if _loader.on_cpu(GROUPED_MMA, a, ends, w8, s):
        return quantized_matmul_grouped_plain(a, ends, w8, s)
    return (_grouped_gemv if R <= GROUPED_GEMV_MAX_R else _grouped_mma)(a.contiguous(), ends,
                                                                        w8, s)


def _grouped_gemv(a, ends, w8, s) -> torch.Tensor:
    """The grouped gemv over CUDA tensors (a contiguous, ``s`` [E, N])."""
    E, K, N = w8.shape
    R = a.shape[0]
    out = torch.empty((R, N), dtype=a.dtype, device=a.device)
    if R == 0:
        return out
    _loader.check_cuda(GROUPED_GEMV, a.dtype, f32=("scale",), i8=("w8",), a=a, ends=ends,
                       w8=w8, scale=s)
    # the split count assumes every row in its own expert (at most min(E,
    # R) experts have rows)
    rows, n_splits = gemv_splits(K, N * min(E, R), _loader.sm_count(a.device))
    work = torch.empty((n_splits, R, N) if n_splits > 1 else (1,), dtype=torch.float32,
                       device=a.device)
    counters = _gemv_counters(a.device, E * -(-N // _GEMV_COLS))
    P = _loader.ptr
    _loader.launch(GROUPED_GEMV, "dstorch_qmm_gemv_grouped", a.device, P(a), P(w8), P(s),
                   P(ends), P(out), P(work), P(counters), R, K, N, E, rows, n_splits)
    return out


def _grouped_mma(a, ends, w8, s) -> torch.Tensor:
    """The grouped ``wgmma`` product over CUDA tensors (a contiguous, ``s``
    [E, N])."""
    E, K, N = w8.shape
    R = a.shape[0]
    out = torch.empty((R, N), dtype=a.dtype, device=a.device)
    if R == 0:
        return out
    _loader.check_cuda(GROUPED_MMA, a.dtype, f32=("scale",), i8=("w8",), a=a, ends=ends,
                       w8=w8, scale=s)
    P = _loader.ptr
    _loader.launch(GROUPED_MMA, "dstorch_qmm_mma_grouped", a.device, P(a), P(w8), P(s),
                   P(ends), P(out), R, K, N, E)
    return out


def quantized_matmul_grouped_plain(a: torch.Tensor, ends: torch.Tensor, w8: torch.Tensor,
                                   scale: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: each expert's rows through
    :func:`quantized_matmul_plain` (the group bounds read on the host; rows
    past ``ends[E - 1]`` are 0, as ``ragged_dot`` leaves them)."""
    out = torch.zeros((a.shape[0], w8.shape[-1]), dtype=a.dtype, device=a.device)
    start = 0
    for e, end in enumerate(ends.tolist()):
        out[start:end] = quantized_matmul_plain(a[start:end], w8[e], scale[e])
        start = end
    return out


def quantized_matmul_int4_plain(a: torch.Tensor, w4: torch.Tensor,
                                scale: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: the weight unpacked, then
    :func:`quantized_matmul_plain`."""
    return quantized_matmul_plain(a, unpack_int4(w4, axis=-2), scale)


def quantized_matmul_plain(a: torch.Tensor, w8: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch (the JAX package's
    ``quantized_matmul_reference``): ``a @ (w8 * scale)`` in f32, cast to
    a's dtype."""
    w = w8.float() * scale.reshape(1, -1).float()
    return (a.float() @ w).to(a.dtype)
