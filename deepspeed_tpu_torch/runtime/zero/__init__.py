"""ZeRO on one device: the offload tier (``offload``: the host/NVMe
optimizer state and its group pipeline) and ZeRO++ qwZ's quantized
weights (``zeropp``). The partitioning stages are the identity on one
device (``runtime/engine.py``)."""

from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer, partition_leaves

__all__ = ["HostOffloadOptimizer", "partition_leaves"]
