"""Speculative decoding for the v2 serving engine: draft and verify on the
steady-state decode path, as in the JAX package's ``inference/v2/spec/``.

- ``proposer.py``: :class:`DraftProposer` and :class:`NGramProposer`
  (prompt-lookup drafts from each sequence's own history).
- ``pipeline.py``: :class:`SpecDecodePipeline`, whose step verifies the
  drafts in ONE ragged forward (``ragged_model.build_verify_step``: K/V
  written for all k + 1 rows, attended through the chunk kernel, the greedy
  accept mask on the device) and advances each row by its accepted count,
  rolling reserved-but-unused pages back through the refcounted allocator
  (``scheduler.rollback_reserved``).
"""

from deepspeed_tpu_torch.inference.v2.spec.pipeline import SpecDecodePipeline
from deepspeed_tpu_torch.inference.v2.spec.proposer import DraftProposer, NGramProposer
