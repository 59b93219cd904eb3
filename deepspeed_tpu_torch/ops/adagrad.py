"""Adagrad on the device, as the JAX package's ``ops/adagrad.py``
``Adagrad``.

The JAX package derives it from the host-offloaded ``DeepSpeedCPUAdagrad``;
the port derives ``DeepSpeedCPUAdagrad`` (``cpuadagrad``) from it instead:
the same math, which the offload tier steps with ``ops/native``'s
``HostAdagrad``. fp32 math over the master tree in the JAX formula's
order::

    g = g + wd*p           (wd > 0)
    ss = ss + g*g
    p = p - (lr*g) / (sqrt(ss) + eps)

``torch._foreach_*`` ops, one at a time, as in ``ops/adam.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TPUOptimizer


class Adagrad(TPUOptimizer):

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):
        super().__init__(lr=lr)
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return {"step": self._step0(params), "exp_avg_sq": self._zeros(params)}

    def update(self, grads: Mapping[str, torch.Tensor], state: Mapping[str, Any],
               params: Mapping[str, torch.Tensor],
               lr: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        names = list(params)
        lr = self._lr_tensor(lr, state["step"].device)
        g = [grads[k].float() for k in names]
        p = [params[k].float() for k in names]
        ss = [state["exp_avg_sq"][k] for k in names]
        if self.weight_decay > 0.0:
            g = torch._foreach_add(g, torch._foreach_mul(p, self.weight_decay))
        ss = torch._foreach_add(ss, torch._foreach_mul(g, g))
        new_p = torch._foreach_sub(p, torch._foreach_div(
            torch._foreach_mul(g, lr), torch._foreach_add(torch._foreach_sqrt(ss), self.eps)))
        return (dict(zip(names, new_p)),
                {"step": state["step"] + 1, "exp_avg_sq": dict(zip(names, ss))})


class DeepSpeedCPUAdagrad(Adagrad):
    """Host-offloaded Adagrad (the JAX package's ``ops/adagrad.py``
    ``DeepSpeedCPUAdagrad``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_offload = True
