"""Packed int4 storage, as the JAX package's ``ops/quantizer.py``
``pack_int4`` / ``unpack_int4`` (:59, :74): two int4 values per byte along
one axis, byte i holding value 2i in its low nibble and 2i+1 in its high
nibble. The bytes are the JAX package's for the same input, so a packed
weight tree moves between the two packages unchanged.

Plain PyTorch ops on any device. The v2 engine's ``_mm`` unpacks a packed
weight before the int8 matmul kernel (K8) runs on the unpacked values at
more than 8 rows; at most 8 rows, K8's ``qmm_gemv`` reads the packed bytes
itself (``ops/kernels/quantized_matmul.quantized_matmul_int4``).
"""

from __future__ import annotations

import torch


def pack_int4(q: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack int4 values (int8 tensor, range [-8, 7]) two per byte along
    ``axis`` (even size) -> int8 with that axis halved."""
    axis = axis % q.ndim
    if q.shape[axis] % 2 != 0:
        raise ValueError(f"axis {axis} size {q.shape[axis]} must be even")
    qm = q.movedim(axis, 0).to(torch.int32)
    byte = ((qm[1::2] & 0xF) << 4) | (qm[0::2] & 0xF)
    return byte.to(torch.uint8).view(torch.int8).movedim(0, axis).contiguous()


def unpack_int4(p: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 ``[.., K/2, ..]`` -> int8
    ``[.., K, ..]``, each nibble sign-extended (the high one by an
    arithmetic shift on int8, the low one by ``((n ^ 8) - 8)``, which gives
    what JAX's ``(p << 4) >> 4`` gives without an int8 overflow)."""
    axis = axis % p.ndim
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4
    shape = list(p.shape)
    shape[axis] *= 2
    return torch.stack([lo, hi], dim=axis + 1).reshape(shape)
