"""Reusable host bounce buffers for swapping (the JAX package's
``runtime/swap_tensor/buffer_pool.py``): a fixed pool of uint8 buffers that
swap reads land in and swap writes stage from, so steady-state swapping
allocates nothing.

The buffers are CPU tensors, page-pinned (``pin_memory=True``) when the
pool serves a CUDA device, so device copies into and out of them run as
DMA without a pageable staging copy; sizes round up to 4 KiB as in the JAX
package (whose buffers are page-aligned numpy arrays).
"""

from __future__ import annotations

from typing import Dict, List

import torch

_ALIGN = 4096


def _round_up(n: int) -> int:
    return max(_ALIGN, (n + _ALIGN - 1) // _ALIGN * _ALIGN)


class SwapBufferPool:
    """Size-bucketed free lists of uint8 host buffers (pinned when
    ``pin_memory``)."""

    def __init__(self, max_buffers: int = 16, pin_memory: bool = False):
        self.max_buffers = max_buffers
        self.pin_memory = bool(pin_memory)
        self._free: Dict[int, List[torch.Tensor]] = {}
        self._outstanding = 0

    def get(self, nbytes: int) -> torch.Tensor:
        """A uint8 buffer of at least ``nbytes`` (the rounded-up size)."""
        size = _round_up(nbytes)
        bucket = self._free.get(size)
        self._outstanding += 1
        if bucket:
            return bucket.pop()
        return torch.empty((size,), dtype=torch.uint8, pin_memory=self.pin_memory)

    def put(self, buf: torch.Tensor) -> None:
        self._outstanding -= 1
        bucket = self._free.setdefault(buf.numel(), [])
        if sum(len(b) for b in self._free.values()) < self.max_buffers:
            bucket.append(buf)

    @staticmethod
    def view(buf: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
        """Typed window into a pooled buffer (no copy)."""
        shape = tuple(shape)
        count = 1
        for n in shape:
            count *= int(n)
        itemsize = torch.empty((), dtype=dtype).element_size()
        return buf[:count * itemsize].view(dtype).view(shape)

    @property
    def outstanding(self) -> int:
        return self._outstanding
