"""Helpers over flat parameter trees (``Dict[str, Tensor]`` keyed by flax
names), the port's counterpart of the JAX package's ``utils/tree.py``."""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over all leaves as a 0-d f32 tensor: each leaf's sum of
    squares in f32, summed in the tree's order (no host sync)."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves))


def tree_cast(tree: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Floating leaves cast to ``dtype``; other leaves unchanged."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}
