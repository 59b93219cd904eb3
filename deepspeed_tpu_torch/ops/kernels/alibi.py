"""ALiBi slopes for the paged attention kernels.

Counterpart of the JAX package's ``ops/pallas/paged_attention.py``
``_alibi_slope`` (:204): the geometric schedule ``s1 ** (h + 1)`` with
``s1 = 2 ** (-8 / H)``, and for a head count that is not a power of two
the interpolation (the first ``closest`` heads from ``closest``'s
schedule, the rest from every other head of ``2 * closest``'s), computed
analytically in f32 as ``exp2(log2(s1) * (h + 1))``.

The paged kernels add ``slope[h] * k_pos`` to every visible score, with
``k_pos`` the key's ABSOLUTE position (the ``-slope[h] * q_pos`` term of
the relative form is constant along a softmax row and is dropped, as in
the JAX package, so an lse differs from the relative form's by a row
constant). The kernels take the slopes as an ``[H]`` f32 operand and the
plain versions read the same tensor, so both use the same slope bytes.
"""

from __future__ import annotations

import functools
import math

import torch


def alibi_slope(head: torch.Tensor, H: int) -> torch.Tensor:
    """Slopes of the q-head indices ``head`` (f32) for ``H`` heads."""
    head = head.float()

    def powers(n: int, exponent: torch.Tensor) -> torch.Tensor:
        s1 = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return torch.exp2(math.log2(s1) * exponent)

    if math.log2(H).is_integer():
        return powers(H, head + 1.0)
    closest = 2 ** math.floor(math.log2(H))
    return torch.where(head < closest, powers(closest, head + 1.0),
                       powers(2 * closest, 2.0 * (head - closest) + 1.0))


@functools.lru_cache(maxsize=32)
def alibi_slopes(H: int, device: torch.device) -> torch.Tensor:
    """The ``[H]`` f32 slopes of heads ``0 .. H-1`` on ``device``, computed
    on the CPU and copied once per (H, device); callers only read it."""
    return alibi_slope(torch.arange(H, dtype=torch.float32), H).to(device)
