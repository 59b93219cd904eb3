"""ZeRO++ quantized weights (qwZ) on one device, as the JAX package's
``runtime/zero/zeropp.py``: the quantize / dequantize transforms of a
leaf and of a flat parameter tree.

A quantized leaf is ``{"q": int8, "s": f32}``: symmetric ``num_bits``
integers (8, or 4 held in int8 storage) over groups of ``group_size``
columns along the last dim (default: one group a row), with the scales
shaped ``x.shape[:-1] + (n_groups, 1)`` so the dequantize broadcast needs
nothing but the two tensors. A zero group's scale is 1.0. The training
engine keeps its compute params in this form under
``zero_optimization.zero_quantized_weights`` (leaves of two or more dims
and at least :data:`QWZ_MIN_SIZE` elements), and the v1 inference engine
its matmul weights under ``quant`` (at ``quant.bits`` and
``quant.group_size``).

:class:`QuantizedWeight` is the seam the models read such a weight
through: ``w.to(dt)`` dequantizes it where it is used, as
``(q.float() * s).to(dt)`` in the JAX function's order of operations,
so the full-width tensor lives only as long as its matmul. The JAX
package leaves that expansion to XLA's fusion into the consuming matmul;
here it is plain torch, one weight at a time.

Tensors of a world of more than one rank (the quantized all-gather's
sharding trees and the qgZ gradient collective) are not ported here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

#: leaves smaller than this stay unquantized (qwZ quantizes weights, not
#: biases and norms), as in the JAX package
QWZ_MIN_SIZE = 2048


def _is_qleaf(x) -> bool:
    return isinstance(x, Mapping) and set(x) == {"q", "s"}


def _should_quantize(x) -> bool:
    return x.dim() >= 2 and x.numel() >= QWZ_MIN_SIZE


def _groups(shape, group_size: Optional[int]):
    """The grouped view's shape: ``shape[:-1] + (n_groups, group)``; one
    group a row unless ``group_size`` divides the last dim into several."""
    d = shape[-1]
    if group_size and 0 < group_size < d and d % group_size == 0:
        return tuple(shape[:-1]) + (d // group_size, group_size)
    return tuple(shape[:-1]) + (1, d)


def quantize_leaf(x: torch.Tensor, num_bits: int = 8,
                  group_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Symmetric group-wise intN of ``x`` in int8 storage: ``{"q": int8
    x.shape, "s": f32 x.shape[:-1] + (n_groups, 1)}``. The quotient
    rounds half to even, as ``jnp.round``, and clips to ``[-qmax - 1,
    qmax]``."""
    g = x.float().reshape(_groups(x.shape, group_size))
    qmax = float(2 ** (num_bits - 1) - 1)
    scale = g.abs().amax(dim=-1, keepdim=True) / qmax
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = (g / scale).round_().clamp_(-qmax - 1, qmax).to(torch.int8)
    return {"q": q.reshape(x.shape), "s": scale}


def dequantize_leaf(d: Mapping[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``(q.float() * s).to(dtype)`` over the groups of ``q``: one f32
    temporary of the leaf's size, multiplied in place."""
    q, s = d["q"], d["s"]
    grouped = q.float().reshape(tuple(s.shape[:-1]) + (-1,))
    return grouped.mul_(s).reshape(q.shape).to(dtype)


def quantize_param_tree(master: Mapping[str, torch.Tensor],
                        dtype: torch.dtype) -> Dict[str, object]:
    """A flat fp32 master -> the qwZ compute tree: every leaf of two or
    more dims and at least ``QWZ_MIN_SIZE`` elements as ``{q, s}`` (8 bits,
    one group a row), every other leaf cast to ``dtype``."""
    return {n: quantize_leaf(x) if _should_quantize(x) else x.to(dtype)
            for n, x in master.items()}


def dequantize_param_tree(tree: Mapping[str, object], dtype: torch.dtype) -> Dict[str, object]:
    """The compute tree with every ``{q, s}`` leaf dequantized to
    ``dtype``; the other leaves as they are."""
    return {n: dequantize_leaf(x, dtype) if _is_qleaf(x) else x for n, x in tree.items()}


@torch.no_grad()
def requantize_into(params: Mapping[str, object], master: Mapping[str, torch.Tensor],
                    num_bits: int = 8, group_size: Optional[int] = None) -> None:
    """Rebuild ``params`` from ``master`` IN PLACE (the step's and a
    load's recast): a ``{q, s}`` leaf is quantized anew into its own
    tensors, any other leaf takes the master's values in its dtype."""
    plain_dst, plain_src = [], []
    for n, x in master.items():
        dst = params[n]
        if _is_qleaf(dst):
            d = quantize_leaf(x, num_bits, group_size)
            dst["q"].copy_(d["q"])
            dst["s"].copy_(d["s"])
        elif dst is not x:
            plain_dst.append(dst)
            plain_src.append(x)
    if plain_dst:
        torch._foreach_copy_(plain_dst, plain_src)


def tree_bytes(tree: Mapping[str, object]) -> int:
    """Bytes the tree's tensors hold (both tensors of a ``{q, s}`` leaf)."""
    total = 0
    for x in tree.values():
        for t in (x.values() if _is_qleaf(x) else (x,)):
            total += t.numel() * t.element_size()
    return total


class QuantizedWeight:
    """A ``{q, s}`` leaf where a model reads a weight tensor: the models
    call ``w.to(dt)`` (or ``w.float()``) on a weight just before its
    matmul, and here that dequantizes, first to the tree's own ``dtype``
    (what the JAX engine's ``dequantize_param_tree`` gives the model),
    then to ``dt``. ``w[e]`` is expert ``e`` of an expert stack, still
    quantized. ``q`` and ``s`` are the engine's own tensors (no copy)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype):
        self.q, self.s, self.dtype = q, s, dtype

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def __getitem__(self, idx) -> "QuantizedWeight":
        return QuantizedWeight(self.q[idx], self.s[idx], self.dtype)

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        w = dequantize_leaf({"q": self.q, "s": self.s}, self.dtype)
        return w if dtype == self.dtype else w.to(dtype)

    def float(self) -> torch.Tensor:
        return self.to(torch.float32)
