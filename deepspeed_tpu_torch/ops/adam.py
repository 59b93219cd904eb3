"""Fused Adam / AdamW, as the JAX package's ``ops/adam.py``.

fp32 math over the master tree, in the JAX package's formula order::

    m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
    p = p - lr*(m/bc1) / (sqrt(v/bc2) + eps)       (bc = bias corrections)
    p = p - lr*wd*p_old                            (AdamW: decay on the OLD master)

This is not ``torch.optim.AdamW``'s order, which decays before the step.
The JAX package leaves this elementwise chain to XLA's fusion, so there is
no kernel here: ``torch._foreach_*`` ops run it over all leaves at once, one
op at a time, in that order.

``DeepSpeedCPUAdam`` is the registry's host-offloaded name (``cpuadam``):
the same math, which the engine steps on the host with
``ops/native``'s ``HostAdam`` when ``zero_optimization.offload_optimizer``
is on (``runtime/zero/offload.py``), and on the device otherwise, as in the
JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TPUOptimizer


class FusedAdam(TPUOptimizer):
    """Adam/AdamW with fp32 math; ``adam_w_mode=True`` (default) gives
    decoupled weight decay (AdamW)."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 amsgrad: bool = False):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad")
        super().__init__(lr=lr)
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return {"step": self._step0(params), "exp_avg": self._zeros(params),
                "exp_avg_sq": self._zeros(params)}

    def update(self, grads: Mapping[str, torch.Tensor], state: Mapping[str, Any],
               params: Mapping[str, torch.Tensor],
               lr: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        names = list(params)
        step = state["step"] + 1
        lr = self._lr_tensor(lr, step.device)
        b1, b2 = self.betas
        if self.bias_correction:
            bc1 = 1.0 - b1 ** step.to(torch.float32)
            bc2 = 1.0 - b2 ** step.to(torch.float32)
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32, device=step.device)
        g = [grads[k].float() for k in names]
        p = [params[k].float() for k in names]
        m = [state["exp_avg"][k] for k in names]
        v = [state["exp_avg_sq"][k] for k in names]
        wd = self.weight_decay
        if not self.adam_w_mode and wd > 0.0:
            g = torch._foreach_add(g, torch._foreach_mul(p, wd))  # classic L2
        m = torch._foreach_add(torch._foreach_mul(m, b1), torch._foreach_mul(g, 1.0 - b1))
        v = torch._foreach_add(torch._foreach_mul(v, b2),
                               torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_mul(torch._foreach_div(m, bc1), lr), denom)
        new_p = torch._foreach_sub(p, upd)
        if self.adam_w_mode and wd > 0.0:
            new_p = torch._foreach_sub(new_p, torch._foreach_mul(p, lr * wd))
        return (dict(zip(names, new_p)),
                {"step": step, "exp_avg": dict(zip(names, m)),
                 "exp_avg_sq": dict(zip(names, v))})


class DeepSpeedCPUAdam(FusedAdam):
    """Host-offloaded Adam (the JAX package's ``ops/adam.py``
    ``DeepSpeedCPUAdam``): FusedAdam's math, AdamW by default
    (``adamw_mode``); ``host_offload`` marks it for the offload tier."""

    def __init__(self, *args, adamw_mode: bool = True, fp32_optimizer_states: bool = True,
                 **kwargs):
        kwargs.setdefault("adam_w_mode", adamw_mode)
        super().__init__(*args, **kwargs)
        self.host_offload = True
