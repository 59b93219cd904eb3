"""Weight carrier between the JAX package and the port.

The JAX package's parameters travel as a flat dict of numpy arrays keyed by
``/``-joined flax names (the JAX package's ``checkpoint/state.py``
``flatten_tree``: ``embed_tokens/embedding``,
``layers_0/self_attn/q_proj/kernel``, ...). The port keeps the SAME names
and the SAME layout: a projection ``kernel`` stays ``[in, out]`` and the port
computes ``x @ kernel``. So the carrier converts only containers, dtypes and
devices, never a layout, and a round trip is byte-equal.

bf16 arrays on the numpy side use the ``bfloat16`` extension dtype
(``ml_dtypes``); they cross as raw 16-bit words, so no value is rounded.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.device import resolve_device


def params_from_flat(flat: Mapping[str, np.ndarray], device=None,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Flat numpy tree -> flat torch tree on ``device`` (default: the CUDA
    device, raising where there is none, as every entry point of the port),
    optionally cast to ``dtype``."""
    device = resolve_device(device)
    out = {}
    for name, arr in flat.items():
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:     # arrays exported by jax are read-only
            arr = arr.copy()
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        t = t.to(device=device)
        if dtype is not None:
            t = t.to(dtype)
        out[name] = t
    return out


def params_to_flat(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Flat torch tree -> flat numpy tree on the host (bf16 stays bf16)."""
    out = {}
    for name, t in params.items():
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            out[name] = t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[name] = t.numpy()
    return out
