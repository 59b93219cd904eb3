"""int8 KV pages: per-row quantization and the scale-tile layout.

Counterpart of the JAX package's ``ops/pallas/paged_attention.py``
``kv_quantize_rows`` (:73), ``kv_dequantize_rows`` (:86),
``kv_write_dequant`` (:97), ``_scale_tile_rows`` (:124),
``_scales_to_tiles`` (:133) and ``kv_scale_tiles_shape`` (:156). The int8
values, the f32 scales and the tile layout are byte-equal to the JAX
package's, so pages stay movable between the two packages:

  - one f32 scale per (token, kv head) row, ``s = fl(amax / 127)``, and
    ``q = round_half_even(x / max(s, 1e-20))``, each an IEEE quotient (a
    tensor divisor: on CUDA, PyTorch divides by a Python scalar through
    its reciprocal, which rounds differently);
  - a page's scales sit in one f32 tile ``[R8, 128]`` at rest: flat index
    ``kv * Hkv * bs + h * bs + t`` at ``(idx // 128, idx % 128)``, the row
    count padded up to a multiple of 8 (pool ``[NB, R8, 128]``).

Plain PyTorch; the kernels read the tiles directly.
"""

from __future__ import annotations

from typing import Tuple

import torch


def kv_quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., D]`` -> (int8 values ``[..., D]``, f32 scales ``[...]``)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    s = amax / torch.full_like(amax, 127.0)
    q = torch.round(xf / torch.clamp_min(s, 1e-20)[..., None])
    return q.to(torch.int8), s


def kv_dequantize_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`kv_quantize_rows`: f32 rows ``q * s``."""
    return q.float() * s[..., None]


def kv_write_dequant(x: torch.Tensor) -> torch.Tensor:
    """Quantize then dequantize: the value an int8 page stores and every
    reader dequantizes back. Returns f32, not ``x``'s dtype: the kernels
    dequantize pages as int8 x f32 scale in f32, so a bf16 round trip here
    would move the attended value away from what every pool read computes.
    Re-quantizing the result gives the same int8 values and scales (the
    max-abs element maps to exactly +-127, and ``fl(fl(127 s) / 127) ==
    s``), so a writer of raw rows and a writer of these rows store the same
    page bytes for the same token."""
    return kv_dequantize_rows(*kv_quantize_rows(x))


def scale_tile_rows(h_kv: int, bs: int) -> int:
    """Rows of one page's scale tile: ``2 * Hkv * bs / 128`` rounded up to
    a multiple of 8."""
    r = (2 * h_kv * bs) // 128
    return -(-r // 8) * 8


def kv_scale_tiles_shape(num_blocks: int, h_kv: int, bs: int) -> Tuple[int, int, int]:
    """At-rest shape of a scale pool: ``[NB, R8, 128]`` f32."""
    return (num_blocks, scale_tile_rows(h_kv, bs), 128)


def scales_to_tiles(s: torch.Tensor) -> torch.Tensor:
    """``[NB, 2, Hkv, bs]`` logical scales -> ``[NB, R8, 128]`` tiles
    (zero padding)."""
    NB, _, h_kv, bs = s.shape
    r8 = scale_tile_rows(h_kv, bs)
    flat = s.reshape(NB, 2 * h_kv * bs).float()
    pad = r8 * 128 - 2 * h_kv * bs
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(NB, r8, 128)


def scales_from_tiles(tiles: torch.Tensor, h_kv: int, bs: int) -> torch.Tensor:
    """``[NB, R8, 128]`` tiles -> ``[NB, 2, Hkv, bs]`` logical scales (a
    view when the tiles are contiguous)."""
    NB = tiles.shape[0]
    return tiles.reshape(NB, -1)[:, :2 * h_kv * bs].reshape(NB, 2, h_kv, bs)


def scale_write_index(rows: torch.Tensor, h_kv: int, bs: int) -> torch.Tensor:
    """Flat value-row indices of one layer's pool (``page * 2 * Hkv * bs +
    kv * Hkv * bs + h * bs + t``) -> flat indices into its scale tiles
    ``[NB * R8 * 128]``."""
    hb2 = 2 * h_kv * bs
    return (rows // hb2) * (scale_tile_rows(h_kv, bs) * 128) + rows % hb2
