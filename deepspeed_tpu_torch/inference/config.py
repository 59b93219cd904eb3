"""The v1 inference engine's configuration (the JAX package's
``inference/config.py`` ``InferenceConfig``): every field of the JAX
package's, on the port's dataclass config tree.

The port's v1 engine runs on one device in plain PyTorch, so this slice
refuses by name, at load, what it does not run: tensor parallelism
(``tensor_parallel.tp_size > 1``), expert parallelism (``moe.ep_size >
1``), int8 weights (``quant.enabled``) and the int8 KV cache tier
(``kv_quant.enabled``). ``replace_with_kernel_inject`` and
``enable_cuda_graph`` are accepted and ignored, as in the JAX package.
"""

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.config import ConfigError, ConfigModel

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "int8": torch.int8}


@dataclass
class TPConfig(ConfigModel):
    enabled: bool = True
    tp_size: int = 1


@dataclass
class InferenceMoEConfig(ConfigModel):
    enabled: bool = True
    ep_size: int = 1
    moe_experts: Any = field(default_factory=lambda: [1])


@dataclass
class WeightQuantConfig(ConfigModel):
    enabled: bool = False
    bits: int = 8
    group_size: int = 64


@dataclass
class KVQuantConfig(ConfigModel):
    enabled: bool = False
    bits: int = 8

    def __post_init__(self):
        if self.enabled and self.bits != 8:
            raise ConfigError(f"kv_quant.bits must be 8, got {self.bits!r}")


@dataclass
class InferenceCheckpointConfig(ConfigModel):
    checkpoint_dir: Optional[str] = None
    tag: Optional[str] = None


@dataclass
class InferenceConfig(ConfigModel):
    dtype: str = "bfloat16"
    tensor_parallel: TPConfig = field(default_factory=TPConfig)
    moe: InferenceMoEConfig = field(default_factory=InferenceMoEConfig)
    quant: WeightQuantConfig = field(default_factory=WeightQuantConfig)
    kv_quant: KVQuantConfig = field(default_factory=KVQuantConfig)
    checkpoint: InferenceCheckpointConfig = field(default_factory=InferenceCheckpointConfig)
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_tokens: int = 4096          # prompt + generation KV budget per sequence
    replace_with_kernel_inject: bool = False   # accepted and ignored
    enable_cuda_graph: bool = False            # accepted and ignored
    model_family: Optional[str] = None
    seed: int = 0

    def __post_init__(self):
        self.check_slice()

    def check_slice(self) -> None:
        """Refuse, by name, every switched-on section the port's v1 engine
        does not run yet."""
        off = [name for name, on in [
            (f"tensor_parallel.tp_size = {self.tensor_parallel.tp_size}",
             self.tensor_parallel.enabled and self.tensor_parallel.tp_size > 1),
            (f"moe.ep_size = {self.moe.ep_size}", self.moe.enabled and self.moe.ep_size > 1),
            ("quant.enabled (int8 weights)", self.quant.enabled),
            ("kv_quant.enabled (the int8 KV cache tier)", self.kv_quant.enabled),
        ] if on]
        if off:
            raise NotImplementedError(
                f"{', '.join(off)}: not ported to deepspeed_tpu_torch's v1 inference "
                "engine yet (it serves on one device with a dense bf16/fp32 cache)")

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ConfigError(f"inference dtype {self.dtype!r} not in {sorted(_DTYPES)}")
        return _DTYPES[self.dtype]

    @classmethod
    def load(cls, config: Optional[Dict[str, Any]] = None, **kwargs) -> "InferenceConfig":
        data = copy.deepcopy(dict(config or {}))  # never mutate the caller's dict
        data.update(kwargs)
        # the legacy flat alias (DeepSpeed accepts mp_size at top level)
        if "mp_size" in data:
            tp = data.setdefault("tensor_parallel", {})
            if isinstance(tp, dict):
                tp.setdefault("tp_size", data.pop("mp_size"))
            else:
                data.pop("mp_size")
        data.pop("replace_method", None)  # deprecated upstream, ignored
        return cls.from_dict(data)
