"""Data-efficiency sampler, a copy of the JAX package's
``data/data_sampler.py``: a deterministic shuffled index stream over the
dataset, partitioned per data-parallel rank, optionally deferring samples
above the curriculum's current difficulty. Its state (epoch, consumed
samples) is checkpointable for exact resume.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.data.curriculum_scheduler import CurriculumScheduler


class DeepSpeedDataSampler:

    def __init__(self,
                 total_samples: int,
                 micro_batch_size: int,
                 data_parallel_rank: int = 0,
                 data_parallel_size: int = 1,
                 gradient_accumulation_steps: int = 1,
                 seed: int = 1234,
                 drop_last: bool = True,
                 shuffle: bool = True,
                 difficulties: Optional[Sequence[float]] = None,
                 curriculum: Optional[CurriculumScheduler] = None):
        if data_parallel_rank >= data_parallel_size:
            raise ValueError("data_parallel_rank >= data_parallel_size")
        self.total_samples = total_samples
        self.micro_batch_size = micro_batch_size
        self.dp_rank = data_parallel_rank
        self.dp_size = data_parallel_size
        self.gas = gradient_accumulation_steps
        self.seed = seed
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.difficulties = (np.asarray(difficulties, dtype=np.float64)
                             if difficulties is not None else None)
        self.curriculum = curriculum
        self.epoch = 0
        self.consumed_samples = 0
        self.global_batch_size = micro_batch_size * data_parallel_size * \
            gradient_accumulation_steps

    # -------------------------------------------------------------- #

    def _epoch_order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.total_samples)
        rng = np.random.default_rng(self.seed + self.epoch)
        return rng.permutation(self.total_samples)

    def __len__(self) -> int:
        n_batches = self.total_samples // self.global_batch_size
        if not self.drop_last and self.total_samples % self.global_batch_size:
            n_batches += 1
        return n_batches

    def __iter__(self) -> Iterator[List[int]]:
        """Yields this rank's micro-batch index lists, GAS micro-batches per
        global batch; under a curriculum, too-hard samples are deferred to the
        back of the epoch order (parity: difficulty-cluster sampling)."""
        order = self._epoch_order()
        step = self.consumed_samples // self.global_batch_size
        pos = self.consumed_samples % self.total_samples
        order = order[pos:]
        while len(order) >= (self.global_batch_size if self.drop_last else 1):
            if self.curriculum is not None and self.difficulties is not None:
                difficulty = self.curriculum.update_difficulty(step)
                easy = self.difficulties[order] <= difficulty
                if easy.sum() < self.global_batch_size:
                    easy_idx = order  # nothing easy enough: fall through as-is
                else:
                    easy_idx = np.concatenate([order[easy], order[~easy]])
                order = easy_idx
            batch = order[:self.global_batch_size]
            order = order[self.global_batch_size:]
            if len(batch) < self.global_batch_size and self.drop_last:
                break
            self.consumed_samples += len(batch)
            # per-rank slice, then split into GAS micro batches
            mine = batch[self.dp_rank::self.dp_size]
            for g in range(self.gas):
                mb = mine[g * self.micro_batch_size:(g + 1) * self.micro_batch_size]
                if len(mb):
                    yield [int(i) for i in mb]
            step += 1
        self.epoch += 1

    # -------------------------------------------------------------- #
    # checkpointable state (parity: state_dict/load_state_dict)
    # -------------------------------------------------------------- #

    def state_dict(self) -> Dict:
        state = {"epoch": self.epoch, "consumed_samples": self.consumed_samples,
                 "seed": self.seed}
        if self.curriculum is not None:
            state["curriculum"] = self.curriculum.get_state()
        return state

    def load_state_dict(self, state: Dict):
        self.epoch = state["epoch"]
        self.consumed_samples = state["consumed_samples"]
        self.seed = state.get("seed", self.seed)
        if self.curriculum is not None and "curriculum" in state:
            self.curriculum.set_state(state["curriculum"])
