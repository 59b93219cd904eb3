"""Optimizer protocol, as the JAX package's ``ops/optimizer.py``.

An optimizer is an (init, update) pair over the fp32 master tree (a flat
``Dict[str, Tensor]``). ``update`` returns NEW master tensors and a new
state instead of stepping in place, because the engine owns the
master-weight flow (grads -> fp32 master update -> cast back) and gates the
update on overflow without a host sync. State keys follow torch naming
(``exp_avg``/``exp_avg_sq``), as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch


class TPUOptimizer:

    def __init__(self, lr: float = 1e-3):
        self.lr = lr

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        raise NotImplementedError

    def update(self, grads: Mapping[str, torch.Tensor], state: Mapping[str, Any],
               params: Mapping[str, torch.Tensor],
               lr: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """Return (new_params, new_state); ``lr`` overrides the static default."""
        raise NotImplementedError
