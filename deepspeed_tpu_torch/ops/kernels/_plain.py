"""Shared piece of the kernels' plain PyTorch versions."""

from __future__ import annotations

import torch


def masked_softmax_av(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
                      spec: str) -> torch.Tensor:
    """``einsum(spec, softmax(s), v)`` with the softmax over the entries
    ``mask`` admits; a row that admits none gives zeros (not NaN)."""
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    p = p / torch.where(l > 0, l, torch.ones_like(l))
    return torch.einsum(spec, p, v)
