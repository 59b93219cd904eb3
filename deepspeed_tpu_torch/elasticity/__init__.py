"""Elastic training (the JAX package's ``elasticity/``; parity:
``deepspeed/elasticity/``): the elastic batch-size solver and
``elastic_agent.DSElasticAgent``."""

from deepspeed_tpu_torch.elasticity.elasticity import (ElasticityError,
                                                 compute_elastic_config,
                                                 validate_elastic_nodes)

__all__ = ["ElasticityError", "compute_elastic_config", "validate_elastic_nodes"]
