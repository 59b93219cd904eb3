"""fp16 loss scaling, as the JAX package's ``runtime/loss_scaler.py``.

The scaler state is a small dict of 0-d tensors on the engine's device,
updated with ``torch.where`` instead of Python branches, so a step never
syncs to the host to decide a skip.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


def make_loss_scale_state(enabled: bool, static_scale: float = 0.0,
                          initial_scale_power: int = 16, hysteresis: int = 2,
                          device=None) -> Dict[str, Any]:
    """Dynamic if static_scale == 0. ``hysteresis`` seeds the counter at the
    configured delayed_shift, so the first overflow is absorbed rather than
    backing off at once."""
    scale = 1.0
    if enabled:
        scale = static_scale if static_scale > 0 else float(2 ** initial_scale_power)
    return {"scale": torch.tensor(scale, dtype=torch.float32, device=device),
            "growth_tracker": torch.tensor(0, dtype=torch.int32, device=device),
            "hysteresis": torch.tensor(hysteresis, dtype=torch.int32, device=device),
            "dynamic": bool(enabled and static_scale == 0)}


def update_loss_scale(state: Mapping[str, Any], overflow: torch.Tensor,
                      loss_scale_window: int = 1000, hysteresis: int = 2,
                      min_loss_scale: float = 1.0,
                      scale_factor: float = 2.0) -> Dict[str, Any]:
    """One dynamic-loss-scaler step, branch-free: on overflow consume
    hysteresis, then halve (not below ``min_loss_scale``); after
    ``loss_scale_window`` clean steps, double and reset the tracker."""
    if not state.get("dynamic", True):
        return dict(state)
    scale = state["scale"]
    tracker = state["growth_tracker"]
    hyst = state["hysteresis"]

    new_hyst = torch.where(overflow, torch.clamp(hyst - 1, min=0),
                           torch.full_like(hyst, hysteresis))
    do_backoff = overflow & (hyst <= 1)
    scale_after_overflow = torch.clamp(scale / scale_factor, min=min_loss_scale)

    new_tracker = torch.where(overflow, torch.zeros_like(tracker), tracker + 1)
    do_growth = (~overflow) & (new_tracker >= loss_scale_window)
    new_scale = torch.where(do_backoff, scale_after_overflow,
                            torch.where(do_growth, scale * scale_factor, scale))
    new_tracker = torch.where(do_growth, torch.zeros_like(new_tracker), new_tracker)
    return {"scale": new_scale, "growth_tracker": new_tracker,
            "hysteresis": new_hyst, "dynamic": state["dynamic"]}


def has_overflow(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """True (0-d bool tensor) when any leaf holds a non-finite value."""
    leaves = list(grads.values())
    if not leaves:
        return torch.tensor(False)
    out = ~torch.isfinite(leaves[0].float()).all()
    for x in leaves[1:]:
        out = out | ~torch.isfinite(x.float()).all()
    return out
