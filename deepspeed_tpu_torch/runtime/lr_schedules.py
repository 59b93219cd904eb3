"""Learning-rate schedules, as the JAX package's ``runtime/lr_schedules.py``.

The same registry names (``LRRangeTest``, ``OneCycle``, ``WarmupLR``,
``WarmupDecayLR``, ``WarmupCosineLR``) and parameter spellings. Each
schedule is a function of the step counter, a 0-d integer tensor on the
engine's device, and returns a 0-d f32 tensor on that device, so the lr
never leaves the card during a step.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

LRSchedule = Callable[[torch.Tensor], torch.Tensor]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"


def _f32(step: torch.Tensor) -> torch.Tensor:
    return step.to(torch.float32)


def _warmup_factor(step, warmup_num_steps: int, warmup_type: str):
    t = torch.clamp(_f32(step) / max(1, warmup_num_steps), 0.0, 1.0)
    if warmup_type == "log":
        return torch.where(t > 0, torch.log1p(t * (math.e - 1.0)), torch.zeros_like(t))
    return t


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              last_batch_iteration: int = -1) -> LRSchedule:
    """``WarmupLR``: warm up then hold."""

    def schedule(step):
        f = _warmup_factor(step, warmup_num_steps, warmup_type)
        return warmup_min_lr + f * (warmup_max_lr - warmup_min_lr)

    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", last_batch_iteration: int = -1) -> LRSchedule:
    """``WarmupDecayLR``: warmup then linear decay to 0 at total_num_steps."""

    def schedule(step):
        f = _warmup_factor(step, warmup_num_steps, warmup_type)
        warm = warmup_min_lr + f * (warmup_max_lr - warmup_min_lr)
        decay_span = max(1, total_num_steps - warmup_num_steps)
        decay = torch.clamp((total_num_steps - _f32(step)) / decay_span, 0.0, 1.0)
        return torch.where(step < warmup_num_steps, warm, warmup_max_lr * decay)

    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_type: str = "linear", lr: float = 0.001,
                     last_batch_iteration: int = -1) -> LRSchedule:
    """``WarmupCosineLR``: ratio-based warmup then cosine to cos_min_ratio."""

    def schedule(step):
        f = _warmup_factor(step, warmup_num_steps, warmup_type)
        warm_ratio = warmup_min_ratio + f * (1.0 - warmup_min_ratio)
        span = max(1, total_num_steps - warmup_num_steps)
        progress = torch.clamp((_f32(step) - warmup_num_steps) / span, 0.0, 1.0)
        cos_ratio = cos_min_ratio + 0.5 * (1.0 - cos_min_ratio) * (
            1.0 + torch.cos(math.pi * progress))
        return lr * torch.where(step < warmup_num_steps, warm_ratio, cos_ratio)

    return schedule


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, decay_lr_rate: float = 0.0,
              cycle_first_step_size: int = 2000, cycle_second_step_size: Optional[int] = None,
              cycle_first_stair_count: int = 0, cycle_second_stair_count: Optional[int] = None,
              decay_step_size: int = 0, cycle_momentum: bool = True,
              cycle_min_mom: float = 0.85, cycle_max_mom: float = 0.99,
              decay_mom_rate: float = 0.0, last_batch_iteration: int = -1) -> LRSchedule:
    """``OneCycle``: triangular up, down, then decay. Momentum cycling is not
    applied: the optimizer takes static betas."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        s = _f32(step)
        up = torch.clamp(s / cycle_first_step_size, 0.0, 1.0)
        down = torch.clamp((s - cycle_first_step_size) / max(1, second), 0.0, 1.0)
        in_cycle_lr = torch.where(
            s < cycle_first_step_size,
            cycle_min_lr + up * (cycle_max_lr - cycle_min_lr),
            cycle_max_lr - down * (cycle_max_lr - cycle_min_lr))
        post = s - total_cycle
        decay_steps = torch.floor(post / decay_step_size) if decay_step_size > 0 else post
        decayed = cycle_min_lr / (1.0 + decay_lr_rate * torch.clamp(decay_steps, min=0.0))
        return torch.where(s <= total_cycle, in_cycle_lr, decayed)

    return schedule


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                  last_batch_iteration: int = -1) -> LRSchedule:
    """``LRRangeTest``: linearly or staircase increasing lr."""

    def schedule(step):
        s = _f32(step) / max(1, lr_range_test_step_size)
        if lr_range_test_staircase:
            s = torch.floor(s)
        return lr_range_test_min_lr * (1.0 + s * lr_range_test_step_rate)

    return schedule


SCHEDULE_REGISTRY: Dict[str, Callable[..., LRSchedule]] = {
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
    ONE_CYCLE: one_cycle,
    LR_RANGE_TEST: lr_range_test,
}


def build_lr_schedule(sched_type: Optional[str], params: Dict[str, Any],
                      base_lr: float) -> LRSchedule:
    """Build a schedule from the config ``scheduler`` block; None -> constant lr."""
    if sched_type is None:
        return lambda step: torch.full((), base_lr, dtype=torch.float32, device=step.device)
    if sched_type not in SCHEDULE_REGISTRY:
        raise ValueError(f"unknown scheduler '{sched_type}'; known: {sorted(SCHEDULE_REGISTRY)}")
    return SCHEDULE_REGISTRY[sched_type](**params)
