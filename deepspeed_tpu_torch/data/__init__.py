"""Data pipeline pieces (the JAX package's ``data/``): the curriculum
scheduler, the data sampler and the mmap indexed dataset, copied numpy-only.
The data analyzer and random-LTD are not ported yet."""

from deepspeed_tpu_torch.data.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.data.data_sampler import DeepSpeedDataSampler
from deepspeed_tpu_torch.data.indexed_dataset import (MMapIndexedDataset,
                                                      MMapIndexedDatasetBuilder,
                                                      make_builder, make_dataset)

__all__ = ["CurriculumScheduler", "DeepSpeedDataSampler", "MMapIndexedDataset",
           "MMapIndexedDatasetBuilder", "make_builder", "make_dataset"]
