"""LoRA adapter checkpoint loading for the v2 serving engine (the JAX
package's ``module_inject/lora.py``).

Validates a per-tenant adapter checkpoint against the base model the
engine serves (refusing at load time, in the JAX package's words) and packs
it into the registry's page layout.

Checkpoint shape (the PEFT convention; torch, numpy or any array leaves)::

    {"q": {"A": [d_in, r], "B": [r, d_out]}, "v": {...}, ..., "alpha": a}

with ``delta = alpha / r * (x @ A @ B)``. Packing folds ``alpha / r`` into
B once; one pool page is one rank slice, column ``j`` of every targeted
projection's A plus (scaled) row ``j`` of its B across all layers
(``ragged_model.lora_page_layout``), so adapters of different ranks share
one fixed-page-size pool. Per-layer checkpoints stack a leading ``[L, ...]``
axis on each leaf; flat leaves mean the same delta in every layer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.ragged_model import (lora_page_layout,
                                                           lora_target_dims)


def _leaf(t) -> np.ndarray:
    """A torch tensor or any array -> f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").float().numpy()
    return np.asarray(t, np.float32)


def validate_lora_adapter(spec, targets, state: Dict[str, Any],
                          name: str = "<adapter>",
                          max_rank: Optional[int] = None) -> int:
    """Validate an adapter checkpoint against the base model ``spec`` and the
    engine's ``targets``; returns the adapter rank. Refused: a target the
    engine applies no delta to, a missing A/B pair, an A/B rank mismatch,
    projection dims that do not match the base model's, inconsistent ranks
    across targets or layers, and a rank past ``max_rank``. An empty state
    is a rank-0 (no-op) adapter."""
    targets = tuple(targets)
    rank = None
    L = spec.num_layers
    for t, pair in state.items():
        if t in ("alpha",):
            continue
        if t not in targets:
            raise ValueError(
                f"adapter {name!r} carries a delta for projection {t!r} but "
                f"this engine applies LoRA to {targets} (lora.targets) — "
                "loading it would silently drop the delta; refuse instead")
        if not isinstance(pair, dict) or "A" not in pair or "B" not in pair:
            raise ValueError(
                f"adapter {name!r} target {t!r} must be a dict with 'A' "
                f"[d_in, r] and 'B' [r, d_out] (the PEFT layout)")
        a, b = _leaf(pair["A"]), _leaf(pair["B"])
        if a.ndim == 3 or b.ndim == 3:
            if a.ndim != 3 or b.ndim != 3 or a.shape[0] != L or \
                    b.shape[0] != L:
                raise ValueError(
                    f"adapter {name!r} target {t!r}: per-layer leaves need "
                    f"a [{L}, ...] leading axis on BOTH A and B (got "
                    f"A {a.shape}, B {b.shape})")
            a, b = a[0], b[0]
        din, dout = lora_target_dims(spec, t)
        if a.ndim != 2 or a.shape[0] != din:
            raise ValueError(
                f"adapter {name!r} target {t!r}: A has shape {a.shape}, "
                f"expected [{din}, r] — the base model's {t} projection "
                f"takes {din} input features (shape/sharding mismatch)")
        if b.ndim != 2 or b.shape[1] != dout:
            raise ValueError(
                f"adapter {name!r} target {t!r}: B has shape {b.shape}, "
                f"expected [r, {dout}] — the base model's {t} projection "
                f"emits {dout} features (shape/sharding mismatch)")
        if a.shape[1] != b.shape[0]:
            raise ValueError(
                f"adapter {name!r} target {t!r}: A rank {a.shape[1]} != "
                f"B rank {b.shape[0]}")
        r = a.shape[1]
        if rank is None:
            rank = r
        elif r != rank:
            raise ValueError(
                f"adapter {name!r}: inconsistent ranks across targets "
                f"({rank} vs {r}) — one adapter, one rank")
    rank = rank or 0
    if max_rank is not None and rank > max_rank:
        raise ValueError(
            f"adapter {name!r} rank {rank} exceeds lora.max_rank "
            f"({max_rank}) — the warmed (bucket, rank-bucket) program grid "
            "stops there; raise lora.max_rank (and re-warm)")
    return rank


def pack_lora_pages(spec, targets, state: Dict[str, Any],
                    alpha: Optional[float] = None,
                    dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    """Pack a validated checkpoint into registry pages ``[rank, elements]``,
    a CPU tensor (f32, or ``dtype``): page j holds, per (layer, target)
    block, A's column j in the first ``in_max`` slots and the alpha /
    rank-scaled B's row j in the next ``out_max``
    (``lora_page_layout``); absent targets stay zero. ``state["alpha"]``
    wins over ``alpha``; neither means a scale of 1. Returns None for a
    rank-0 adapter."""
    targets = tuple(targets)
    elements, in_max, out_max = lora_page_layout(spec, targets)
    L, nproj, io = spec.num_layers, len(targets), in_max + out_max
    if "alpha" in state:
        alpha = float(state["alpha"])
    rank = validate_lora_adapter(spec, targets, state)
    if rank == 0:
        return None
    scale = (alpha / rank) if alpha is not None else 1.0
    pages = np.zeros((rank, L, nproj, io), np.float32)
    for p, t in enumerate(targets):
        pair = state.get(t)
        if pair is None:
            continue
        a, b = _leaf(pair["A"]), _leaf(pair["B"])
        if a.ndim == 2:                      # flat: the same delta every layer
            a = np.broadcast_to(a, (L,) + a.shape)
            b = np.broadcast_to(b, (L,) + b.shape)
        din, dout = lora_target_dims(spec, t)
        # [L, din, r] -> page-major [r, L, din]; the scale folded into B once
        pages[:, :, p, :din] = np.moveaxis(a, 2, 0)
        pages[:, :, p, in_max:in_max + dout] = np.moveaxis(b * scale, 1, 0)
    out = torch.from_numpy(pages.reshape(rank, elements))
    return out if dtype is None else out.to(dtype)


def load_lora_adapter(engine, name: str, state: Dict[str, Any],
                      alpha: Optional[float] = None) -> int:
    """Validate ``state`` against ``engine``'s base model, pack it in the
    pool's dtype and register it with ``engine.lora``. Returns the adapter
    rank. The registry's duplicate-name rules apply (an identical payload
    re-registers as a no-op; a different one refuses while requests hold
    the old)."""
    if getattr(engine, "lora", None) is None:
        raise RuntimeError(
            "this engine has no LoRA registry — enable "
            "RaggedInferenceEngineConfig.lora before loading adapters")
    targets = engine.config.lora.targets
    validate_lora_adapter(engine.spec, targets, state, name=name,
                          max_rank=engine.config.lora.max_rank)
    pages = pack_lora_pages(engine.spec, targets, state, alpha=alpha,
                            dtype=engine.lora.pool.dtype)
    engine.lora.register(name, pages)
    return engine.lora.rank(name)
