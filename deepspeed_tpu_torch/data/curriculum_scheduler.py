"""Curriculum learning scheduler, a copy of the JAX package's
``data/curriculum_scheduler.py``: global step -> difficulty (e.g. sequence
length) under ``fixed_linear`` / ``fixed_root`` / ``fixed_discrete`` /
``custom`` schedules, rounded to ``difficulty_step`` buckets. The engine
truncates each batch to the scheduled seqlen as it stages it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:

    def __init__(self, config):
        """``config`` is a ``CurriculumLearningConfig`` or a plain dict with the
        same keys (min_difficulty / max_difficulty / schedule_type /
        schedule_config)."""
        if isinstance(config, dict):
            get = config.get
        else:
            get = lambda k, d=None: getattr(config, k, d)
        self.min_difficulty = int(get("min_difficulty", 8))
        self.max_difficulty = int(get("max_difficulty", 1024))
        self.schedule_type = get("schedule_type", FIXED_LINEAR)
        self.schedule_config: Dict[str, Any] = dict(get("schedule_config", {}) or {})
        self.custom_fn: Optional[Callable[[int], int]] = \
            self.schedule_config.get("difficulty_fn")
        self.current_difficulty = self.min_difficulty
        if self.schedule_type in (FIXED_LINEAR, FIXED_ROOT):
            self.total_steps = int(self.schedule_config.get("total_curriculum_step",
                                                            1000))
            self.step_size = int(self.schedule_config.get("difficulty_step", 8))
            if self.step_size < 1:
                raise ValueError("difficulty_step must be >= 1")
        elif self.schedule_type == FIXED_DISCRETE:
            self.difficulties = list(self.schedule_config["difficulty"])
            self.max_steps = list(self.schedule_config["max_step"])
            if len(self.difficulties) != len(self.max_steps) + 1:
                raise ValueError("need len(difficulty) == len(max_step) + 1")
        elif self.schedule_type == CUSTOM:
            if self.custom_fn is None:
                raise ValueError("custom schedule needs schedule_config"
                                 "['difficulty_fn']")
        else:
            raise ValueError(f"unknown curriculum schedule {self.schedule_type}")

    def _root_degree(self) -> float:
        return float(self.schedule_config.get("root_degree", 2))

    def get_difficulty(self, global_steps: int) -> int:
        """Difficulty at a given step (parity: get_difficulty)."""
        if self.schedule_type == CUSTOM:
            return int(self.custom_fn(global_steps))
        if self.schedule_type == FIXED_DISCRETE:
            for d, s in zip(self.difficulties, self.max_steps):
                if global_steps <= s:
                    return d
            return self.difficulties[-1]
        frac = min(1.0, global_steps / max(1, self.total_steps))
        if self.schedule_type == FIXED_ROOT:
            frac = frac ** (1.0 / self._root_degree())
        span = self.max_difficulty - self.min_difficulty
        raw = self.min_difficulty + frac * span
        # round UP to the bucket grid so difficulty 0 still yields min_difficulty
        bucketed = self.step_size * math.ceil(raw / self.step_size)
        return int(min(self.max_difficulty, max(self.min_difficulty, bucketed)))

    def update_difficulty(self, global_steps: int) -> int:
        self.current_difficulty = self.get_difficulty(global_steps)
        return self.current_difficulty

    def get_state(self) -> Dict[str, Any]:
        return {"current_difficulty": self.current_difficulty}

    def set_state(self, state: Dict[str, Any]):
        self.current_difficulty = state["current_difficulty"]
