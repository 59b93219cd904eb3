"""Fused LAMB, as the JAX package's ``ops/lamb.py`` ``FusedLamb``.

Adam moments, then a per-tensor trust ratio ``||p|| / ||update||`` that
scales the step, clamped to [min_coeff, max_coeff]. fp32 math over the
master tree in the JAX formula's order::

    (max_grad_norm > 0: the gradient tree clipped to that global norm)
    m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*(g*g)
    u = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p
    trust = ||p|| / max(||u||, 1e-12)   (1 where ||u|| or ||p|| is 0)
    p = p - (lr*clip(trust, min_coeff, max_coeff)) * u

The norms come from ``torch._foreach_norm`` and the trust chain runs on
the device over all leaves at once (no host read); the elementwise chain is
``torch._foreach_*`` ops, one at a time, as in ``ops/adam.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.optimizer import TPUOptimizer
from deepspeed_tpu_torch.utils.tree import clip_by_global_norm


class FusedLamb(TPUOptimizer):

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 max_coeff: float = 10.0, min_coeff: float = 0.01):
        super().__init__(lr=lr)
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return {"step": self._step0(params), "exp_avg": self._zeros(params),
                "exp_avg_sq": self._zeros(params)}

    def update(self, grads: Mapping[str, torch.Tensor], state: Mapping[str, Any],
               params: Mapping[str, torch.Tensor],
               lr: Optional[torch.Tensor] = None
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        names = list(params)
        if self.max_grad_norm > 0.0:
            grads, _ = clip_by_global_norm(grads, self.max_grad_norm)
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
        m = torch._foreach_add(torch._foreach_mul(m, b1), torch._foreach_mul(g, 1.0 - b1))
        v = torch._foreach_add(torch._foreach_mul(v, b2),
                               torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)), self.eps)
        u = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        del denom
        if self.weight_decay > 0.0:
            u = torch._foreach_add(u, torch._foreach_mul(p, self.weight_decay))
        p_norm = torch.stack(torch._foreach_norm(p))
        u_norm = torch.stack(torch._foreach_norm(u))
        one = torch.ones_like(p_norm)
        trust = torch.where(u_norm > 0.0, p_norm / torch.clamp(u_norm, min=1e-12), one)
        trust = torch.where(p_norm > 0.0, trust, one)
        coeff = lr * torch.clamp(trust, self.min_coeff, self.max_coeff)
        new_p = torch._foreach_sub(p, torch._foreach_mul(u, list(coeff.unbind())))
        return (dict(zip(names, new_p)),
                {"step": step, "exp_avg": dict(zip(names, m)),
                 "exp_avg_sq": dict(zip(names, v))})
