"""Weight conversion between the JAX package's parameter tree and the port."""

from deepspeed_tpu_torch.checkpoint.convert import params_from_flat, params_to_flat
