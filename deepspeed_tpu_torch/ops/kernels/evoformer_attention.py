"""Evoformer pair-bias attention (K10): CUDA kernels ``csrc/evoformer_fwd.cu``
and ``csrc/evoformer_bwd.cu``, their plain PyTorch versions, the autograd
function that joins them, and the four AlphaFold attention modes.

Counterpart of the JAX package's ``ops/pallas/evoformer_attention.py``
(``evoformer_flash_attention`` :369, custom VJP ``_evo_core`` :349): q, k, v
``[L, S, H, D]`` (lead dims folded into L), a pair bias ``[G, H, S, S]``
shared by groups of ``R = rows_per_group`` rows (L = G * R, row l reads
group l // R) and an optional mask bias ``[L, S]`` added per key:

    o[l, :, h] = softmax((q k^T) * scale + mask[l] + pair[l // R, h]) v

The scores are summed in that order, in f32 (``_scores`` :54). Both biases
are finite additions: a row whose keys are all masked is NOT excluded (unlike
K1 and K9) and gets near-uniform weights (exactly uniform at -1e30). The
backward recomputes p from the saved lse and gives dq, dk, dv and d(pair) =
sum over the group's rows of p * (dp - delta), with no scale factor (the bias
enters after the scaling). The mask is a constant: its cotangent is zeros,
as JAX's (:362).

The kernels read q, k, v and dO in the caller's ``[L, S, H, D]`` layout (the
JAX wrapper transposes to ``[L, H, S, D]`` first); lse and delta are ``[L,
H, S]``. The d(pair) kernel sums each group's R rows in :func:`dbias_chunks`
contiguous chunks, one block per (k-tile, q-tile, group, head, chunk), into
f32 partials in scratch that the wrapper allocates; a second kernel of the
same launch adds them in chunk order.

CPU tensors run the plain versions (dense f32, or f64 for f64 input; p and
ds rounded to the inputs' type before their products, as the Pallas kernels
cast them); CUDA tensors launch the kernels (bf16 q, k, v, contiguous; head
dims 16, 32, 64 and 128; the pair bias bf16 or f32, read and its gradient
written in its own type; the mask cast to f32) or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.ops.kernels import _loader
# K1's working type, head dims and delta apply unchanged; delta's [B, T, H,
# D] -> [B, H, T] is [L, S, H, D] -> [L, H, S]
from deepspeed_tpu_torch.ops.kernels.flash_attention import (KERNEL_HEAD_DIMS, _acc,
                                                             flash_delta as evoformer_delta)

NEG_INF = -1e30
FWD, DQ, DKV, DBIAS = "evoformer_fwd", "evoformer_dq", "evoformer_dkv", "evoformer_dbias"
_PALLAS = "deepspeed_tpu/ops/pallas/evoformer_attention.py"
# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    FWD: ("deepspeed_tpu_torch/csrc/evoformer_fwd.cu", f"{_PALLAS}:70"),
    DQ: ("deepspeed_tpu_torch/csrc/evoformer_bwd.cu", f"{_PALLAS}:155"),
    DKV: ("deepspeed_tpu_torch/csrc/evoformer_bwd.cu", f"{_PALLAS}:184"),
    DBIAS: ("deepspeed_tpu_torch/csrc/evoformer_bwd.cu", f"{_PALLAS}:219"),
}


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def _in_type(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to ``like``'s type and back (the Pallas kernels' casts
    of p and ds before their products; no-op for f32 and f64 input)."""
    return t.to(like.dtype).to(t.dtype)


def _scores(q, k, mask, pair, scale: float, R: int) -> torch.Tensor:
    """[L, H, S, S] scores in the working type: (q . k) * scale, then + mask,
    then + pair, each step rounded as the Pallas kernel's ``_scores``."""
    L, S, H, _ = q.shape
    s = torch.einsum("lqhd,lkhd->lhqk", _acc(q), _acc(k)).contiguous().mul_(scale)
    if mask is not None:
        s.add_(mask.to(s.dtype)[:, None, None, :])
    s.view(L // R, R, H, S, S).add_(pair.to(s.dtype)[:, None])
    return s


def evoformer_fwd_plain(q, k, v, mask, pair, scale: float, R: int):
    """(o [L, S, H, D] in q's dtype, lse [L, H, S] f32 or f64) in plain
    PyTorch. The running max starts at -1e30 as in the Pallas kernel, so a
    row whose biases are all -inf gets o = 0 and lse = -1e30 (its safe_l)."""
    s = _scores(q, k, mask, pair, scale, R)
    m = s.amax(-1, keepdim=True).clamp_(min=NEG_INF)
    p = s.sub_(m).exp_()
    l = p.sum(-1, keepdim=True)
    l = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("lhqk,lkhd->lqhd", _in_type(p, v), _acc(v)) / l.transpose(1, 2)
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_dp(q, k, v, mask, pair, do, lse, scale: float, R: int):
    """p = exp(s - lse) and dp = dO . v, both [L, H, S, S]."""
    p = _scores(q, k, mask, pair, scale, R).sub_(lse[..., None]).exp_()
    return p, torch.einsum("lqhd,lkhd->lhqk", _acc(do), _acc(v))


def evoformer_dq_plain(q, k, v, mask, pair, do, lse, delta, scale: float, R: int):
    """dq [L, S, H, D] in q's dtype."""
    p, dp = _probs_dp(q, k, v, mask, pair, do, lse, scale, R)
    ds = p.mul_(dp.sub_(delta[..., None])).mul_(scale)
    return torch.einsum("lhqk,lkhd->lqhd", _in_type(ds, k), _acc(k)).to(q.dtype)


def evoformer_dkv_plain(q, k, v, mask, pair, do, lse, delta, scale: float, R: int):
    """(dk, dv) [L, S, H, D] in k's and v's dtypes."""
    p, dp = _probs_dp(q, k, v, mask, pair, do, lse, scale, R)
    dv = torch.einsum("lhqk,lqhd->lkhd", _in_type(p, do), _acc(do))
    ds = p.mul_(dp.sub_(delta[..., None])).mul_(scale)
    dk = torch.einsum("lhqk,lqhd->lkhd", _in_type(ds, q), _acc(q))
    return dk.to(k.dtype), dv.to(v.dtype)


def evoformer_dbias_plain(q, k, v, mask, pair, do, lse, delta, scale: float, R: int):
    """d(pair) [G, H, S, S] in pair's dtype: p * (dp - delta) summed over
    each group's R rows in the working type (no scale factor)."""
    L, S, H, _ = q.shape
    p, dp = _probs_dp(q, k, v, mask, pair, do, lse, scale, R)
    db = p.mul_(dp.sub_(delta[..., None]))
    return db.view(L // R, R, H, S, S).sum(1).to(pair.dtype)


def evoformer_bwd_plain(q, k, v, mask, pair, o, lse, do, scale: float, R: int):
    """(dq, dk, dv, dpair) in plain PyTorch."""
    delta = evoformer_delta(o, do)
    dq = evoformer_dq_plain(q, k, v, mask, pair, do, lse, delta, scale, R)
    dk, dv = evoformer_dkv_plain(q, k, v, mask, pair, do, lse, delta, scale, R)
    return dq, dk, dv, evoformer_dbias_plain(q, k, v, mask, pair, do, lse, delta, scale, R)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #

def _check_shapes(name, q, mask, pair, R: int, *rest) -> None:
    if q.dim() != 4 or any(t.shape != q.shape for t in rest):
        raise ValueError(f"{name}: q, k, v (and dO) must be [L, S, H, D] alike, got "
                         f"{[tuple(t.shape) for t in (q, *rest)]}")
    L, S, H, _ = q.shape
    if R < 1 or L % R or tuple(pair.shape) != (L // R, H, S, S):
        raise ValueError(f"{name}: pair bias {tuple(pair.shape)} must be [L / R, H, S, S] = "
                         f"[{L} / {R}, {H}, {S}, {S}]")
    if mask is not None and tuple(mask.shape) != (L, S):
        raise ValueError(f"{name}: mask bias {tuple(mask.shape)} must be [L, S] = [{L}, {S}]")


def _tensors(q, mask, pair, *rest):
    return (q, pair, *rest) + (() if mask is None else (mask,))


def _kernel_args(name, q, mask, pair, **tensors):
    """Check the CUDA inputs; returns (mask as f32 or None, pair_f32 flag)."""
    D = q.shape[-1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head dims {KERNEL_HEAD_DIMS}, got {D}")
    if pair.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the pair bias must be bfloat16 or float32, got {pair.dtype}")
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
        tensors["mask"] = mask
    pair_f32 = pair.dtype == torch.float32
    _loader.check_cuda(name, q.dtype, f32=("mask", "lse", "delta") + (
        ("pair",) if pair_f32 else ()), q=q, pair=pair, **tensors)
    return mask, int(pair_f32)


def evoformer_fwd(q, k, v, mask, pair, scale: float, R: int):
    """(o [L, S, H, D] in q's dtype, lse [L, H, S] f32)."""
    _check_shapes(FWD, q, mask, pair, R, k, v)
    if _loader.on_cpu(FWD, *_tensors(q, mask, pair, k, v)):
        return evoformer_fwd_plain(q, k, v, mask, pair, scale, R)
    mask, pair_f32 = _kernel_args(FWD, q, mask, pair, k=k, v=v)
    L, S, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((L, H, S), dtype=torch.float32, device=q.device)
    P = _loader.ptr
    _loader.launch(FWD, "dstorch_evoformer_fwd_bf16", q.device, P(q), P(k), P(v), P(mask),
                   P(pair), P(o), P(lse), L, S, H, D, R, scale, pair_f32)
    return o, lse


def evoformer_dq(q, k, v, mask, pair, do, lse, delta, scale: float, R: int):
    """dq [L, S, H, D] in q's dtype."""
    _check_shapes(DQ, q, mask, pair, R, k, v, do)
    if _loader.on_cpu(DQ, *_tensors(q, mask, pair, k, v, do, lse, delta)):
        return evoformer_dq_plain(q, k, v, mask, pair, do, lse, delta, scale, R)
    mask, pair_f32 = _kernel_args(DQ, q, mask, pair, k=k, v=v, do=do, lse=lse, delta=delta)
    L, S, H, D = q.shape
    dq = torch.empty_like(q)
    P = _loader.ptr
    _loader.launch(DQ, "dstorch_evoformer_dq_bf16", q.device, P(q), P(k), P(v), P(do),
                   P(mask), P(pair), P(lse), P(delta), P(dq), L, S, H, D, R, scale, pair_f32)
    return dq


def evoformer_dkv(q, k, v, mask, pair, do, lse, delta, scale: float, R: int):
    """(dk, dv) [L, S, H, D] in k's dtype."""
    _check_shapes(DKV, q, mask, pair, R, k, v, do)
    if _loader.on_cpu(DKV, *_tensors(q, mask, pair, k, v, do, lse, delta)):
        return evoformer_dkv_plain(q, k, v, mask, pair, do, lse, delta, scale, R)
    mask, pair_f32 = _kernel_args(DKV, q, mask, pair, k=k, v=v, do=do, lse=lse, delta=delta)
    L, S, H, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    P = _loader.ptr
    _loader.launch(DKV, "dstorch_evoformer_dkv_bf16", q.device, P(q), P(k), P(v), P(do),
                   P(mask), P(pair), P(lse), P(delta), P(dk), P(dv), L, S, H, D, R, scale,
                   pair_f32)
    return dk, dv


# the d(pair) kernel's target grid: enough (k-tile, q-tile, group, head,
# chunk) blocks for several waves of resident blocks on an H100's 132 SMs
DBIAS_BLOCKS = 2048


def dbias_chunks(S: int, H: int, G: int, R: int) -> int:
    """How many contiguous chunks the d(pair) kernel cuts each group's R rows
    into: the fewest that give the grid ``DBIAS_BLOCKS`` blocks, at most R.
    Chunk c holds rows ``[R * c // C, R * (c + 1) // C)``."""
    nt = -(-S // 64)
    return max(1, min(R, -(-DBIAS_BLOCKS // (nt * nt * G * H))))


def evoformer_dbias(q, k, v, mask, pair, do, lse, delta, scale: float, R: int):
    """d(pair) [G, H, S, S] in pair's dtype."""
    _check_shapes(DBIAS, q, mask, pair, R, k, v, do)
    if _loader.on_cpu(DBIAS, *_tensors(q, mask, pair, k, v, do, lse, delta)):
        return evoformer_dbias_plain(q, k, v, mask, pair, do, lse, delta, scale, R)
    mask, pair_f32 = _kernel_args(DBIAS, q, mask, pair, k=k, v=v, do=do, lse=lse,
                                  delta=delta)
    L, S, H, D = q.shape
    chunks = dbias_chunks(S, H, L // R, R)
    dpair = torch.empty_like(pair)
    partials = torch.empty((chunks, *pair.shape), dtype=torch.float32, device=q.device)
    P = _loader.ptr
    _loader.launch(DBIAS, "dstorch_evoformer_dbias_bf16", q.device, P(q), P(k), P(v), P(do),
                   P(mask), P(pair), P(lse), P(delta), P(dpair), P(partials), L, S, H, D, R,
                   chunks, scale, pair_f32)
    return dpair


def evoformer_bwd(q, k, v, mask, pair, o, lse, do, scale: float, R: int):
    """(dq, dk, dv, dpair): delta in plain torch, then the dq, dk/dv and
    d(pair) kernels (their plain versions for CPU tensors)."""
    delta = evoformer_delta(o, do)
    dq = evoformer_dq(q, k, v, mask, pair, do, lse, delta, scale, R)
    dk, dv = evoformer_dkv(q, k, v, mask, pair, do, lse, delta, scale, R)
    return dq, dk, dv, evoformer_dbias(q, k, v, mask, pair, do, lse, delta, scale, R)


# --------------------------------------------------------------------------- #
# public fused op
# --------------------------------------------------------------------------- #

class EvoformerAttention(torch.autograd.Function):
    """o = pair-bias attention(q, k, v, mask, pair); the backward launches
    the dq, dk/dv and d(pair) kernels on the saved (q, k, v, o, lse). The
    mask's gradient is zeros (a constant, as in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, pair, scale: float, R: int):
        o, lse = evoformer_fwd(q, k, v, mask, pair, scale, R)
        ctx.save_for_backward(q, k, v, mask, pair, o, lse)
        ctx.scale, ctx.R = scale, R
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, pair, o, lse = ctx.saved_tensors
        dq, dk, dv, dpair = evoformer_bwd(q, k, v, mask, pair, o, lse, do.contiguous(),
                                          ctx.scale, ctx.R)
        dmask = torch.zeros_like(mask) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dmask, dpair, None, None


def evoformer_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              pair_bias: torch.Tensor,
                              mask_bias: Optional[torch.Tensor] = None,
                              rows_per_group: int = 1,
                              softmax_scale: Optional[float] = None,
                              block: int = 256) -> torch.Tensor:
    """Fused pair-bias attention, differentiable in q, k, v and pair_bias.

    q/k/v:      [L, S, H, D]  (lead dims folded into L)
    pair_bias:  [G, H, S, S], L == G * rows_per_group
    mask_bias:  [L, S] additive per-key bias, a constant (zero gradient)
    Returns [L, S, H, D]. The scale is ``1/sqrt(D)`` unless
    ``softmax_scale`` is given. ``block`` chose the TPU kernel's tiling; it
    is accepted and changes nothing here (the CUDA kernels tile by 64)."""
    L, S, H, D = q.shape
    G, Hb, Sb, Sb2 = pair_bias.shape
    assert (Hb, Sb, Sb2) == (H, S, S), (pair_bias.shape, q.shape)
    assert L == G * rows_per_group, (L, G, rows_per_group)
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D ** 0.5)
    return EvoformerAttention.apply(q, k, v, mask_bias, pair_bias, scale,
                                    int(rows_per_group))


# --------------------------------------------------------------------------- #
# the four Evoformer attention modes (AlphaFold naming)
# --------------------------------------------------------------------------- #

def _mask_to_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    return torch.where(mask > 0, 0.0, NEG_INF).to(torch.float32)


def msa_row_attention(m_q, m_k, m_v, pair_bias, msa_mask=None):
    """MSA row-wise attention core: rows attend along the residue axis with
    a pair bias shared across rows. m_*: [B, N, S, H, D]; pair_bias [B, H,
    S, S]; msa_mask [B, N, S] (1 = keep)."""
    B, N, S, H, D = m_q.shape
    fold = lambda t: t.reshape(B * N, S, H, D).contiguous()
    mask = None
    if msa_mask is not None:
        mask = _mask_to_bias(msa_mask).reshape(B * N, S)
    out = evoformer_flash_attention(fold(m_q), fold(m_k), fold(m_v), pair_bias, mask,
                                    rows_per_group=N)
    return out.reshape(B, N, S, H, D)


def msa_col_attention(m_q, m_k, m_v, msa_mask=None):
    """MSA column-wise attention: residues attend along the MSA-row axis
    (NO pair bias). m_*: [B, N, S, H, D]. Plain torch through the reference
    ``ops.evoformer.evoformer_attention`` on every device, as the JAX
    package sends it to its jnp path: bias-free and along the short MSA
    axis, it needs no fused pair-bias kernel."""
    from deepspeed_tpu_torch.ops.evoformer import evoformer_attention
    t = lambda x: x.transpose(1, 2)          # [B, S, N, H, D]
    biases = ()
    if msa_mask is not None:
        # [B, S, N] keep-mask -> additive bias over keys [B, S, 1, 1, N]
        biases = (_mask_to_bias(msa_mask.transpose(1, 2))[:, :, None, None, :],)
    out = evoformer_attention(t(m_q), t(m_k), t(m_v), biases)
    return out.transpose(1, 2)


def triangle_attention_starting_node(z_q, z_k, z_v, pair_bias, pair_mask=None):
    """Triangle attention around the STARTING node: row i of the pair
    representation attends over k with bias from the pair representation.
    z_*: [B, S, S, H, D] (i, j axes); pair_bias [B, H, S, S]; pair_mask
    [B, S, S]."""
    B, S, S2, H, D = z_q.shape
    # a transposed view (the ending node's) folds to a strided view when
    # B = 1: the kernels take contiguous rows
    fold = lambda t: t.reshape(B * S, S2, H, D).contiguous()
    mask = None
    if pair_mask is not None:
        mask = _mask_to_bias(pair_mask).reshape(B * S, S2)
    out = evoformer_flash_attention(fold(z_q), fold(z_k), fold(z_v), pair_bias, mask,
                                    rows_per_group=S)
    return out.reshape(B, S, S2, H, D)


def triangle_attention_ending_node(z_q, z_k, z_v, pair_bias, pair_mask=None):
    """Triangle attention around the ENDING node: the transpose (column j
    attends over i), through the starting-node path on transposed (i, j),
    whose fold copies the transposed views into the kernels' layout."""
    t = lambda x: x.transpose(1, 2)
    mask = None if pair_mask is None else pair_mask.transpose(1, 2)
    out = triangle_attention_starting_node(t(z_q), t(z_k), t(z_v), pair_bias, mask)
    return out.transpose(1, 2)
