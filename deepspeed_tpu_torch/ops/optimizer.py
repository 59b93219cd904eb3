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

    def _lr_tensor(self, lr: Optional[torch.Tensor], device) -> torch.Tensor:
        """``lr`` as an f32 0-d tensor (the static default when None)."""
        return torch.full((), self.lr, dtype=torch.float32, device=device) \
            if lr is None else lr.to(torch.float32)

    @staticmethod
    def _zeros(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    @staticmethod
    def _step0(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        dev = next(iter(params.values())).device if params else None
        return torch.zeros((), dtype=torch.int32, device=dev)
