"""Elastic training agent: supervise, restart, and resize on failure (the
JAX package's ``elasticity/elastic_agent.py``, copied).

Parity: ``DSElasticAgent`` (reference ``elasticity/elastic_agent.py:28``,
extending torch's ``LocalElasticAgent``): when workers die or nodes
join/leave, the job restarts at a new world size while
``compute_elastic_config`` keeps the global batch invariant. This agent is a
host-side supervisor: it runs the training callable, and on failure
recomputes the valid (micro-batch, GAS, world-size) combination for the
surviving resources and restarts from the latest checkpoint
(``checkpoint.state.find_resume_tag`` + ``checkpoint.universal
.ds_to_universal``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from deepspeed_tpu_torch.elasticity.elasticity import compute_elastic_config
from deepspeed_tpu_torch.utils import fault_injection
from deepspeed_tpu_torch.utils.logging import logger


@dataclass
class RunRecord:
    world_size: int
    micro_batch: int
    gas: int
    error: Optional[str] = None
    restarts: int = 0
    #: universal-checkpoint dir the attempt was told to resume from (None on
    #: a cold start or when no complete checkpoint survived)
    resume_from: Optional[str] = None


class DSElasticAgent:
    """Supervise ``run_fn(world_size, micro_batch, gas, resume)``.

    ``ds_config`` must contain an ``elasticity`` block (the reference schema:
    max_train_batch_size, micro_batch_sizes, min/max_gpus...). On each
    (re)start the agent asks :func:`compute_elastic_config` for the valid
    batch split at the current world size; ``device_counts`` simulates
    membership changes (next entry after each failure).

    **Checkpoint-based recovery**: pass ``ckpt_dir`` (where the killed run's rolling/
    user checkpoints live) and restarts become elastic RESUMES — before each
    restart the agent finds the newest COMPLETE tag (torn tags from a
    mid-write death are skipped), converts it to a universal checkpoint
    (``ds_to_universal``), and passes ``resume_from=<universal dir>`` to
    ``run_fn``, which loads it at the NEW world size via
    ``load_universal_into_engine`` — step k on N devices resumes at step k
    on M devices with the global batch invariant.
    """

    def __init__(self, ds_config: Dict[str, Any], run_fn: Callable,
                 device_counts: List[int], max_restarts: int = 3,
                 backoff_s: float = 0.0, ckpt_dir: Optional[str] = None,
                 universal_dir: Optional[str] = None):
        self.ds_config = ds_config
        self.run_fn = run_fn
        self.device_counts = list(device_counts)
        if not self.device_counts:
            raise ValueError("device_counts must be non-empty")
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.ckpt_dir = ckpt_dir
        self.universal_dir = universal_dir or (
            os.path.join(ckpt_dir, "universal") if ckpt_dir else None)
        # honor the run's checkpoint.verify_load on the resume scan: a
        # checksum-corrupt newest tag must fall back to an older complete
        # one, not feed corrupted bytes into the resumed run
        self.verify_load = bool(
            (ds_config.get("checkpoint") or {}).get("verify_load", False))
        self.records: List[RunRecord] = []

    def _prepare_resume(self, attempt: int) -> Optional[str]:
        """Newest complete checkpoint -> universal fragments for this attempt.
        Returns the universal dir to resume from, or None when no loadable
        checkpoint exists (the run restarts from scratch, with a warning)."""
        if self.ckpt_dir is None:
            return None
        from deepspeed_tpu_torch.checkpoint.state import find_resume_tag
        from deepspeed_tpu_torch.checkpoint.universal import ds_to_universal
        tag = find_resume_tag(self.ckpt_dir, verify=self.verify_load)
        if tag is None:
            logger.warning(f"elastic agent: no complete checkpoint in "
                           f"{self.ckpt_dir}; restarting from scratch")
            return None
        # per-attempt dir: a conversion torn by ANOTHER preemption mid-convert
        # must never be mistaken for a complete universal checkpoint
        out = os.path.join(self.universal_dir, f"attempt{attempt}_{tag}")
        return ds_to_universal(self.ckpt_dir, out, tag=tag)

    def _resolve(self, world_size: int):
        final_batch, _valid, micro_batch = compute_elastic_config(
            self.ds_config, world_size=world_size, return_microbatch=True)
        gas = final_batch // (micro_batch * world_size)
        return final_batch, micro_batch, gas

    def run(self) -> RunRecord:
        """Run until success or restart budget exhausted (parity: the
        torchelastic restart loop with rendezvous rounds)."""
        attempt = 0
        idx = 0
        while True:
            world = self.device_counts[min(idx, len(self.device_counts) - 1)]
            rec = RunRecord(world_size=world, micro_batch=0, gas=0,
                            restarts=attempt)
            try:
                # injection point: a failure at (re)start — rendezvous loss,
                # a preempted replacement VM — exercises the restart budget
                fault_injection.maybe_fail("agent.run")
                # resolve INSIDE the retry scope: an incompatible resized world
                # size must advance to the next membership, not abort the agent
                final_batch, rec.micro_batch, rec.gas = self._resolve(world)
                logger.info(f"elastic agent: starting ws={world} "
                            f"micro={rec.micro_batch} gas={rec.gas} "
                            f"(global batch {final_batch}), attempt {attempt}")
                kwargs = {}
                if self.ckpt_dir is not None:
                    rec.resume_from = self._prepare_resume(attempt) \
                        if attempt > 0 else None
                    kwargs["resume_from"] = rec.resume_from
                self.run_fn(world_size=world, micro_batch=rec.micro_batch,
                            gas=rec.gas, resume=attempt > 0, **kwargs)
                self.records.append(rec)
                return rec
            except Exception as e:
                rec.error = f"{type(e).__name__}: {e}"
                self.records.append(rec)
                attempt += 1
                idx += 1
                if attempt > self.max_restarts:
                    logger.error(f"elastic agent: giving up after "
                                 f"{self.max_restarts} restarts: {rec.error}")
                    raise
                logger.warning(f"elastic agent: run failed ({rec.error}); "
                               f"restarting with next membership")
                if self.backoff_s:
                    time.sleep(self.backoff_s)
