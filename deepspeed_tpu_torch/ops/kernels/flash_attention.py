"""Training flash attention (K1): CUDA kernels ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``, their plain PyTorch versions, and the torch op that
joins them (``dstorch::flash_attention_fwd`` with its autograd formula).

Counterpart of the JAX package's ``ops/pallas/flash_attention.py``
``flash_attention`` (custom VJP ``_flash``): q [B, Tq, H, D], k/v [B, Tk,
Hkv, D] (GQA: k/v heads repeated here, as the JAX wrapper does) -> o [B, Tq,
H, D]. The forward saves (q, k, v, o, lse); the backward computes delta =
rowsum(dO * O) in plain torch and launches the dq and the dk/dv kernels,
which recompute the probabilities from lse.

Causal masking is TOP-LEFT aligned (query i sees key j iff j <= i), as in
the Pallas kernel, also when Tq != Tk; ``ops.attention.reference_attention``
aligns bottom-right, so the two agree only for Tq == Tk, the self-attention
of the training path. Any T is taken: the kernels mask the ragged edge (the
JAX wrapper pads T to a multiple of 128 instead). A row with no visible key
gets o = 0, lse = -1e30 and zero gradients.

CPU tensors run the plain versions; CUDA tensors launch the kernels (bf16,
contiguous; head dims 16, 32, 64 and 128, other multiples of 8 up to 128 are
zero-padded to the next of those) or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from deepspeed_tpu_torch.ops.kernels import _loader

NEG_INF = -1e30
FWD, DQ, DKV = "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"
_PALLAS = "deepspeed_tpu/ops/pallas/flash_attention.py"
# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    FWD: ("deepspeed_tpu_torch/csrc/flash_fwd.cu", f"{_PALLAS}:54"),
    DQ: ("deepspeed_tpu_torch/csrc/flash_bwd.cu", f"{_PALLAS}:288"),
    DKV: ("deepspeed_tpu_torch/csrc/flash_bwd.cu", f"{_PALLAS}:327"),
}
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _shapes(q, k, v) -> Tuple[int, int, int, int, int]:
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    return B, Tq, Tk, H, D


def _check_kernel(name, q, **tensors) -> None:
    D = q.shape[-1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head dims {KERNEL_HEAD_DIMS}, got {D}")
    _loader.check_cuda(name, q.dtype, f32=("lse", "delta"), q=q, **tensors)


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #

def flash_attention_fwd(q, k, v, causal: bool, scale: float):
    """(o [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32); q/k/v with equal
    head counts."""
    B, Tq, Tk, H, D = _shapes(q, k, v)
    if _loader.on_cpu(FWD, q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal, scale)
    _check_kernel(FWD, q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    P = _loader.ptr
    _loader.launch(FWD, "dstorch_flash_fwd_bf16", q.device, P(q), P(k), P(v), P(o),
                   P(lse), B, Tq, Tk, H, D, scale, int(causal))
    return o, lse


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working type: f32, or f64 for f64 input
    (gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q, k, causal: bool, scale: float):
    """Scores [B, H, Tq, Tk] in the working type with hidden pairs at -1e30,
    and the mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", _acc(q), _acc(k)) * scale
    Tq, Tk = q.shape[1], k.shape[1]
    if causal:
        mask = torch.arange(Tq, device=q.device)[:, None] >= \
            torch.arange(Tk, device=q.device)[None, :]
    else:
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def flash_attention_fwd_plain(q, k, v, causal: bool, scale: float):
    """The forward in plain PyTorch, computed in f32 (f64 for f64 input)."""
    s, mask = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bkhd->bqhd", p / safe_l, _acc(v))
    lse = torch.where(l > 0, m + torch.log(safe_l), torch.full_like(l, NEG_INF))
    return o.to(q.dtype), lse[..., 0]


# --------------------------------------------------------------------------- #
# backward
# --------------------------------------------------------------------------- #

def flash_delta(o, do):
    """rowsum(dO * O) in f32 (f64 for f64 input), [B, H, Tq]."""
    return torch.einsum("bqhd,bqhd->bhq", _acc(do), _acc(o)).contiguous()


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dq [B, Tq, H, D] in q's dtype."""
    B, Tq, Tk, H, D = _shapes(q, k, v)
    if _loader.on_cpu(DQ, q, k, v, do, lse, delta):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    _check_kernel(DQ, q, k=k, v=v, do=do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    P = _loader.ptr
    _loader.launch(DQ, "dstorch_flash_bwd_dq_bf16", q.device, P(q), P(k), P(v), P(do),
                   P(lse), P(delta), P(dq), B, Tq, Tk, H, D, scale, int(causal))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dk, dv) [B, Tk, H, D] in k's dtype."""
    B, Tq, Tk, H, D = _shapes(q, k, v)
    if _loader.on_cpu(DKV, q, k, v, do, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    _check_kernel(DKV, q, k=k, v=v, do=do, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    P = _loader.ptr
    _loader.launch(DKV, "dstorch_flash_bwd_dkv_bf16", q.device, P(q), P(k), P(v), P(do),
                   P(lse), P(delta), P(dk), P(dv), B, Tq, Tk, H, D, scale, int(causal))
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """(dq, dk, dv): delta in plain torch, then the dq and dk/dv kernels
    (their plain versions for CPU tensors)."""
    delta = flash_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _probs(q, k, lse, causal, scale):
    s, mask = _scores(q, k, causal, scale)
    return torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqhd,bkhd->bhqk", _acc(do), _acc(v))
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bhqk,bkhd->bqhd", ds, _acc(k)).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, scale: float):
    p = _probs(q, k, lse, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, _acc(do))
    dp = torch.einsum("bqhd,bkhd->bhqk", _acc(do), _acc(v))
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _acc(q))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward in plain PyTorch, computed in f32 (f64 for f64 input)."""
    delta = flash_delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------- #
# public entry
# --------------------------------------------------------------------------- #

@torch.library.custom_op("dstorch::flash_attention_fwd", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's forward as a torch op, (o, lse): the differentiable entry.
    Being an op, a selective activation-checkpoint policy can save its
    outputs (``attn_out_saveable``) so the backward does not run it again."""
    return flash_attention_fwd(q, k, v, causal, scale)


@flash_attention_op.register_fake
def _(q, k, v, causal, scale):
    B, Tq, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, Tq), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.scale = causal, scale


def _backward(ctx, do, dlse):
    # lse is not differentiated: its gradient is ignored
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.dstorch.flash_attention_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    """``FlopCounterMode``'s count of K1's forward, as torch counts its own
    SDPA: the two matmuls, 2 * B * H * Tq * Tk * D each, with no halving for
    the causal mask (the count the plain version's two einsums give)."""
    B, Tq, H, D = q_shape
    Tk = k_shape[1]
    return 4 * B * H * Tq * Tk * D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over [B, T, H, D] tensors, differentiable in q, k, v.

    GQA: k/v with fewer heads than q are repeated to match (HBM reads, no
    extra flops in the kernel)."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if Hkv != H:
        if H % Hkv:
            raise ValueError(f"GQA heads {H} not divisible by kv heads {Hkv}")
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D ** 0.5)
    Dp = next((d for d in KERNEL_HEAD_DIMS if d >= D), D)
    if q.is_cuda and Dp != D and D % 8 == 0:
        # zero dims add nothing to q.k, and v's zero dims are sliced off
        q, k, v = (F.pad(t, (0, Dp - D)) for t in (q, k, v))
        return flash_attention_op(q, k, v, causal, scale)[0][..., :D]
    return flash_attention_op(q, k, v, causal, scale)[0]
