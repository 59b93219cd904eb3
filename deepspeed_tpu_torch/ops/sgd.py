"""SGD with momentum, as the JAX package's ``ops/sgd.py`` ``SGD``.

fp32 math over the master tree in the JAX formula's order::

    g = g + wd*p                                   (wd != 0)
    momentum == 0:  p = p - lr*g
    else:           buf = momentum*buf + g
                    p = p - lr*(g + momentum*buf if nesterov else buf)

``torch._foreach_*`` ops, one at a time, as in ``ops/adam.py``; the state
holds ``momentum_buffer`` only with momentum, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TPUOptimizer


class SGD(TPUOptimizer):

    def __init__(self, lr: float = 1e-2, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False):
        super().__init__(lr=lr)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = {"step": self._step0(params)}
        if self.momentum:
            state["momentum_buffer"] = self._zeros(params)
        return state

    def update(self, grads: Mapping[str, torch.Tensor], state: Mapping[str, Any],
               params: Mapping[str, torch.Tensor],
               lr: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        names = list(params)
        lr = self._lr_tensor(lr, state["step"].device)
        g = [grads[k].float() for k in names]
        p = [params[k].float() for k in names]
        if self.weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, self.weight_decay))
        step = state["step"] + 1
        if not self.momentum:
            new_p = torch._foreach_sub(p, torch._foreach_mul(g, lr))
            return dict(zip(names, new_p)), {"step": step}
        buf = [state["momentum_buffer"][k] for k in names]
        buf = torch._foreach_add(torch._foreach_mul(buf, self.momentum), g)
        direction = torch._foreach_add(g, torch._foreach_mul(buf, self.momentum)) \
            if self.nesterov else buf
        new_p = torch._foreach_sub(p, torch._foreach_mul(direction, lr))
        return (dict(zip(names, new_p)),
                {"step": step, "momentum_buffer": dict(zip(names, buf))})
