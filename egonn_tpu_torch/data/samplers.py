"""The batch sampler of training (port of `egonn_tpu/data/samplers.py`, the
reference's datasets/samplers.py without torch's Sampler base): batches of
(anchor, positive) pairs, and dynamic batch expansion, which the trainer
calls when the share of active triplets drops below `batch_expansion_th`.

A seeded sampler draws from `random.Random(f"{seed}:{epoch}")` after
`set_epoch`, as the JAX package's does, so both draw the same batches for
the same seed and epoch.  The sampler picks which elements form a batch;
the batch's shape is bucketed by `data/pipeline.py::make_global_batch`.
"""
from __future__ import annotations

import copy
import random
from typing import List, Optional


class ListDict:
    """A set with O(1) remove and indexable items."""

    def __init__(self, items):
        self.items = copy.deepcopy(list(items))
        self.item_to_position = {item: ndx for ndx, item in enumerate(self.items)}

    def remove(self, item):
        position = self.item_to_position.pop(item)
        last_item = self.items.pop()
        if position != len(self.items):
            self.items[position] = last_item
            self.item_to_position[last_item] = position

    def __contains__(self, item):
        return item in self.item_to_position

    def __len__(self):
        return len(self.items)


class BatchSampler:
    """Yields lists of element ids; each batch is pairs (anchor, positive)."""

    def __init__(self, dataset, batch_size: int, batch_size_limit: Optional[int] = None,
                 batch_expansion_rate: Optional[float] = None, seed: Optional[int] = None):
        if batch_expansion_rate is not None:
            if not batch_expansion_rate > 1.0:
                raise ValueError("batch_expansion_rate must exceed 1")
            if not batch_size <= batch_size_limit:
                raise ValueError("batch_size must not exceed batch_size_limit")
        self.batch_size = batch_size
        self.batch_size_limit = batch_size_limit
        self.batch_expansion_rate = batch_expansion_rate
        self.dataset = dataset
        self.k = 2
        if self.batch_size < 2 * self.k:
            self.batch_size = 2 * self.k
        self.batch_idx: List[List[int]] = []
        self.elems_ndx = list(dataset.queries)
        self._seed = seed
        self._rng = random.Random(seed) if seed is not None else random

    def set_epoch(self, epoch: int):
        """Reseed a seeded sampler for `epoch`: epoch E's batches then depend
        only on (seed, epoch, batch_size), so a run resumed at an epoch
        boundary draws the batches the uninterrupted run would have."""
        if self._seed is not None:
            self._rng = random.Random(f"{self._seed}:{epoch}")

    def __iter__(self):
        self.generate_batches()
        yield from self.batch_idx

    def __len__(self):
        return len(self.batch_idx)

    def expand_batch(self):
        if self.batch_expansion_rate is None:
            print("WARNING: batch_expansion_rate is None")
            return
        if self.batch_size >= self.batch_size_limit:
            return
        old = self.batch_size
        self.batch_size = min(int(self.batch_size * self.batch_expansion_rate),
                              self.batch_size_limit)
        print(f"=> Batch size increased from: {old} to {self.batch_size}")

    def generate_batches(self):
        self.batch_idx = []
        unused = ListDict(self.elems_ndx)
        current_batch: List[int] = []
        while True:
            if len(current_batch) >= self.batch_size or len(unused) == 0:
                if len(current_batch) >= 2 * self.k:
                    self.batch_idx.append(current_batch)
                    current_batch = []
                if len(unused) == 0:
                    break
            selected = self._rng.choice(unused.items)
            unused.remove(selected)
            positives = self.dataset.get_positives(selected)
            if len(positives) == 0:
                continue
            unused_positives = [e for e in positives if e in unused]
            if unused_positives:
                second = self._rng.choice(unused_positives)
                unused.remove(second)
            else:
                second = self._rng.choice(list(positives))
            current_batch += [selected, second]
