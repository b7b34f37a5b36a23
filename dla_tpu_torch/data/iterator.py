"""Batch iteration with a seeded epoch order and a resumable position
(``dla_tpu.data.iterator``): the same order as the JAX package for the
same seed (numpy ``default_rng((seed, epoch))``) and the same
``state_dict`` ({epoch, step_in_epoch}), so a checkpoint's data position
means the same thing in both packages. With ``process_count`` > 1 each
process takes the slice ``process_index::process_count`` of every
global batch."""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np


class ShardedBatchIterator:
    def __init__(self, dataset: Any, global_batch_size: int, *,
                 seed: int = 0, shuffle: bool = True, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1):
        if global_batch_size % process_count != 0:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"{process_count} processes")
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // process_count
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.step_in_epoch = 0  # batches already emitted this epoch

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "step_in_epoch": self.step_in_epoch}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state.get("epoch", 0))
        self.step_in_epoch = int(state.get("step_in_epoch", 0))

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch_size
        return (n + self.global_batch_size - 1) // self.global_batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            order = self._epoch_order(self.epoch)
            spe = self.steps_per_epoch()
            if spe == 0:
                raise ValueError(
                    f"dataset of {len(self.dataset)} examples smaller than "
                    f"global batch {self.global_batch_size}")
            while self.step_in_epoch < spe:
                start = self.step_in_epoch * self.global_batch_size
                sl = order[start:start + self.global_batch_size]
                if len(sl) < self.global_batch_size:  # non-drop_last tail
                    sl = np.concatenate(
                        [sl, order[: self.global_batch_size - len(sl)]])
                local = sl[self.process_index::self.process_count]
                examples = [self.dataset[int(i)] for i in local]
                self.step_in_epoch += 1
                yield self.dataset.collate(examples)
            self.epoch += 1
            self.step_in_epoch = 0
