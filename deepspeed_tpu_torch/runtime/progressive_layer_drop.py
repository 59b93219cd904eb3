"""Progressive layer drop (stochastic depth schedule), as the JAX
package's ``runtime/progressive_layer_drop.py``.

theta(t) = theta_bar + (1 - theta_bar) * exp(-gamma * t) falls from 1
toward theta_bar; layer i of L is kept with probability 1 - (i / L) * (1 -
theta(t)) (the PLD paper, arXiv:2010.13369).

The JAX models draw each layer's Bernoulli from a per-step PRNG key; the
port draws it on the host from a ``torch.Generator`` seeded from the
batch's ``pld_rng`` seed (itself drawn from (base seed, global step) when
the batch is staged, so synchronous and prefetched staging draw the same
layers). A layer that is dropped is not run: its output is the skip input
and its parameters get zero gradients, as under the JAX model's ``where``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Mapping, Optional, Tuple

import torch


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def theta_at(self, global_step: int) -> float:
        """theta at a step, without changing state; ``theta_at(0) == 1.0``,
        so staging ahead of the step counter reads what ``update_state``
        then ``get_theta`` would."""
        return (1.0 - self.theta) * math.exp(-self.gamma * global_step) + self.theta

    def update_state(self, global_step: int) -> float:
        self.current_theta = self.theta_at(global_step)
        return self.current_theta

    def keep_prob(self, layer_idx: int, n_layers: int) -> float:
        return pld_keep_prob(layer_idx, n_layers, self.current_theta)


def pld_keep_prob(layer_idx: int, n_layers: int, theta):
    """1 - (i / L)(1 - theta): the schedule models and the engine share."""
    return 1.0 - (layer_idx / max(1, n_layers)) * (1.0 - theta)


def layer_keeps(seed: int, theta: float, n_layers: int) -> List[bool]:
    """Which of ``n_layers`` layers run this forward: layer i runs when the
    i-th uniform draw of a generator seeded with ``seed`` is below its keep
    probability (a keep probability of 1 always runs)."""
    u = torch.rand(n_layers, generator=torch.Generator().manual_seed(int(seed)),
                   dtype=torch.float64)
    return [bool(u[i] < pld_keep_prob(i, n_layers, theta)) for i in range(n_layers)]


def apply_layer_drop(x_new: torch.Tensor, x_skip: torch.Tensor, keep_prob: float,
                     keep: bool, deterministic: bool = False) -> torch.Tensor:
    """The stochastic-depth residual combine: a kept layer's output scaled
    by 1 / keep_prob about the skip input (``x_skip + (x_new - x_skip) /
    keep_prob``, exactly ``x_new`` at keep_prob 1), else the skip input."""
    if deterministic or keep_prob >= 1.0:
        return x_new
    if not keep:
        return x_skip
    return x_skip + (x_new - x_skip) / keep_prob


def batch_layer_plan(batch: Mapping, n_layers: int) -> Optional[Tuple[float, List[bool]]]:
    """(theta, which layers run) from a batch's ``pld_theta`` / ``pld_rng``
    (row 0: the micro-batch's), or None without them. Both are read on the
    host: the engine stages them as CPU tensors."""
    if "pld_theta" not in batch:
        return None
    theta = float(batch["pld_theta"][0])
    return theta, layer_keeps(int(batch["pld_rng"][0]), theta, n_layers)


def run_layer(layer: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, i: int,
              n_layers: int, plan: Optional[Tuple[float, List[bool]]]) -> torch.Tensor:
    """Layer ``i`` of ``n_layers`` on ``x`` under a :func:`batch_layer_plan`
    (None: the layer always runs). A dropped layer is not run."""
    if plan is None:
        return layer(x)
    theta, keeps = plan
    keep_prob = pld_keep_prob(i, n_layers, theta)
    if keep_prob < 1.0 and not keeps[i]:
        return x
    return apply_layer_drop(layer(x), x, keep_prob, keeps[i])
