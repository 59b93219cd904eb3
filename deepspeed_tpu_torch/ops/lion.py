"""Fused Lion, as the JAX package's ``ops/lion.py`` ``FusedLion``.

fp32 math over the master tree in the JAX formula's order::

    p = p*(1 - lr*wd) - lr*sign(b1*m + (1-b1)*g)
    m = b2*m + (1-b2)*g

``torch._foreach_*`` ops, one at a time, as in ``ops/adam.py``.
``DeepSpeedCPULion`` (``cpulion``) is the same math under the host-offloaded
name; the offload tier steps it with ``ops/native``'s ``HostLion``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TPUOptimizer


class FusedLion(TPUOptimizer):

    def __init__(self, lr: float = 1e-4, betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(lr=lr)
        self.betas = tuple(betas)
        self.weight_decay = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return {"step": self._step0(params), "exp_avg": self._zeros(params)}

    def update(self, grads: Mapping[str, torch.Tensor], state: Mapping[str, Any],
               params: Mapping[str, torch.Tensor],
               lr: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        names = list(params)
        lr = self._lr_tensor(lr, state["step"].device)
        b1, b2 = self.betas
        g = [grads[k].float() for k in names]
        p = [params[k].float() for k in names]
        m = [state["exp_avg"][k] for k in names]
        direction = torch._foreach_sign(
            torch._foreach_add(torch._foreach_mul(m, b1), torch._foreach_mul(g, 1.0 - b1)))
        new_p = torch._foreach_sub(torch._foreach_mul(p, 1.0 - lr * self.weight_decay),
                                   torch._foreach_mul(direction, lr))
        del direction
        new_m = torch._foreach_add(torch._foreach_mul(m, b2), torch._foreach_mul(g, 1.0 - b2))
        return (dict(zip(names, new_p)),
                {"step": state["step"] + 1, "exp_avg": dict(zip(names, new_m))})


class DeepSpeedCPULion(FusedLion):
    """Host-offloaded Lion (the JAX package's ``ops/lion.py``
    ``DeepSpeedCPULion``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_offload = True
