"""Profiling (the JAX package's ``profiling/``): the flops profiler."""

from deepspeed_tpu_torch.profiling.flops_profiler import (FlopsProfiler, ModuleProfile,
                                                          get_model_profile)

__all__ = ["FlopsProfiler", "ModuleProfile", "get_model_profile"]
