"""Input pipeline (port of `egonn_tpu/data/pipeline.py`): the point budget
per dataset, host-side padding of raw clouds, batch assembly, a prefetch
thread, and the on-device preprocess (augment -> quantize -> dedup ->
coordinate pyramid).

The host reads and pads the scans into fixed (B, N, 3) float32 buffers with
point masks; the trainer copies them to the device.  The global batch's
element count is rounded up to a bucket of the batch-expansion schedule;
the padding rows hold empty clouds (all-False point masks) and all-False
positive and negative rows, so no loss term reads them.

`Prefetcher` overlaps the host work with the device: its thread runs the
batch generator (file reads, padding, numpy dedup) and the consumer copies
to the device.  Unlike the JAX package's, it raises a worker's exception in
the consumer, where the JAX package's ends the iteration as if the epoch
were shorter.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from egonn_tpu_torch.data.augmentation import (
    draw_train_set_transform,
    draw_train_transform,
    train_set_transform,
    train_transform,
)
from egonn_tpu_torch.data.base import TrainingDataset, in_sorted
from egonn_tpu_torch.parallel.mesh import row_slice, world_size
from egonn_tpu_torch.sparse.pyramid import PyramidSpec, build_pyramid
from egonn_tpu_torch.sparse.types import Pyramid
from egonn_tpu_torch.utils.tracing import span


@dataclass
class GlobalBatch:
    """A padded batch for the global-descriptor loss."""

    clouds: np.ndarray          # (B, N, 3) float32, zero-padded
    point_mask: np.ndarray      # (B, N) bool
    positives_mask: np.ndarray  # (B, B) bool
    negatives_mask: np.ndarray  # (B, B) bool
    valid_elems: np.ndarray     # (B,) bool, False on the bucket's padding rows


@dataclass
class LocalBatch:
    """A padded batch of cloud pairs for the local-descriptor loss."""

    anc_clouds: np.ndarray   # (B, N, 3) float32
    anc_mask: np.ndarray     # (B, N) bool
    pos_clouds: np.ndarray   # (B, N, 3) float32
    pos_mask: np.ndarray     # (B, N) bool
    t_gt: np.ndarray         # (B, 4, 4) float32

# Truncations of overlong clouds since process start (read with
# pad_cloud_drop_stats); the first one also prints a warning.
_DROP_STATS = {"clouds_truncated": 0, "points_dropped": 0, "warned": False}


def pad_cloud_drop_stats() -> dict:
    return dict(_DROP_STATS)


def default_num_points(dataset_type: str) -> int:
    """Points per cloud: KITTI's velodyne scans hold ~120-130k points before
    ground and zero removal; MulRan and SouthBay fit in 65,536."""
    return 131072 if dataset_type.lower() == "kitti" else 65536


def resolve_num_points(model_params, dataset_type: str) -> int:
    """A num_points set in the config wins; otherwise the dataset's default."""
    if getattr(model_params, "num_points_explicit", True):
        return model_params.num_points
    return default_num_points(dataset_type)


def pad_cloud(pc: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad or trim an (M, 3) cloud to (n, 3) float32 + (n,) mask.  An
    overlong cloud is subsampled at random, with the generator seeded from
    the cloud's content, so the choice is deterministic per scan."""
    m = len(pc)
    out = np.zeros((n, 3), dtype=np.float32)
    mask = np.zeros((n,), dtype=bool)
    if m > n:
        seed = [m, int(abs(float(pc[0, 0])) * 1e6) % (1 << 31),
                int(abs(float(pc[m // 2, 1])) * 1e6) % (1 << 31)]
        sel = np.random.default_rng(seed).choice(m, n, replace=False)
        out[:] = pc[sel]
        mask[:] = True
        _DROP_STATS["clouds_truncated"] += 1
        _DROP_STATS["points_dropped"] += m - n
        if not _DROP_STATS["warned"]:
            _DROP_STATS["warned"] = True
            print(f"WARNING: cloud with {m} points subsampled to the {n}-point budget")
    else:
        out[:m] = pc
        mask[:m] = True
    return out, mask


def round_to_bucket(b: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that holds b elements (the largest if none does)."""
    for x in buckets:
        if b <= x:
            return x
    return buckets[-1]


def make_global_batch(dataset: TrainingDataset, element_ids: List[int], num_points: int,
                      buckets: Sequence[int], group=None) -> GlobalBatch:
    """The elements' padded clouds and their positive / negative masks (the
    reference's collate_fn, datasets/dataset_utils.py:60-95), in a bucket of
    rows; elements beyond the largest bucket are dropped.  With a
    data-parallel `group` only the rank's rows of the bucket are read:
    `clouds` and `point_mask` hold those rows, the masks and `valid_elems`
    stay whole."""
    b_real = len(element_ids)
    b = round_to_bucket(b_real, buckets)
    rows = row_slice(b, group)
    n_rows = rows.stop - rows.start
    clouds = np.zeros((n_rows, num_points, 3), dtype=np.float32)
    mask = np.zeros((n_rows, num_points), dtype=bool)
    for i, ndx in enumerate(element_ids[:b][rows]):
        pc, _ = dataset[ndx]
        clouds[i], mask[i] = pad_cloud(np.asarray(pc, dtype=np.float32), num_points)

    labels = np.array(list(element_ids[:b]) + [-1] * (b - min(b_real, b)), dtype=np.int64)
    valid = labels >= 0
    n = int(valid.sum())  # the real rows come first
    positives = np.zeros((b, b), dtype=bool)
    negatives = np.zeros((b, b), dtype=bool)
    for i in range(n):
        q = dataset.queries[int(labels[i])]
        positives[i, :n] = in_sorted(labels[:n], q.positives)
        negatives[i, :n] = ~in_sorted(labels[:n], q.non_negatives)
    return GlobalBatch(clouds, mask, positives, negatives, valid)


class Prefetcher:
    """Iterates over gen_fn()'s items, produced `depth` ahead by a thread.

    The thread runs host work only (the generator); an exception there is
    raised in the consumer after the items before it.  Leaving the loop
    early (or the iterator being collected) stops the thread.  `wait_s`
    sums the seconds the consumer waited for an item."""

    def __init__(self, gen_fn, depth: int = 2):
        self._gen_fn = gen_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = object()
        self._error: Optional[BaseException] = None
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self._gen_fn():
                if not self._put(item):
                    return
        except Exception as e:  # handed to the consumer, raised there
            self._error = e
        self._put(self._done)

    def __iter__(self):
        try:
            while True:
                t0 = time.perf_counter()
                item = self._q.get()
                self.wait_s += time.perf_counter() - t0
                if item is self._done:
                    if self._error is not None:
                        raise self._error
                    return
                yield item
        finally:
            self.close()

    def close(self):
        """Stop the thread and wait for it."""
        self._stop.set()
        self._thread.join()


def device_preprocess_global(clouds: torch.Tensor, point_mask: torch.Tensor, quantizer,
                             spec: PyramidSpec, gen: Optional[torch.Generator] = None,
                             aug_mode: int = 2, with_kmap_down: bool = False,
                             group=None) -> Pyramid:
    """(augment ->) quantize -> dedup -> pyramid, on the clouds' device.

    clouds (B, N, 3), point_mask (B, N).  With a generator the clouds are
    augmented first: each cloud's TrainTransform, then one TrainSetTransform
    for the batch.  With a data-parallel `group` the clouds are this rank's
    rows of the global batch: the draws are those of the whole global batch
    (from the generator every rank shares) and the rank takes its rows, so
    each cloud is augmented as in a single process.  with_kmap_down builds
    the maps a training forward needs."""
    if gen is not None:
        with span("egonn.augment"):
            b, n, _ = clouds.shape
            b_global = b * world_size(group)
            draws = draw_train_transform(gen, b_global, n, aug_mode)
            if b_global != b:
                rows = row_slice(b_global, group)
                draws = {k: v[rows] for k, v in draws.items()}
            clouds = train_transform(clouds, point_mask, draws, aug_mode)
            clouds = train_set_transform(clouds, draw_train_set_transform(gen, aug_mode),
                                         aug_mode)
    res = quantizer.quantize(clouds, point_mask, spec.capacities[0], need_index=False)
    return build_pyramid(res.coords_t, res.mask, spec, n_unique0=res.n_unique, keys0=res.keys,
                         with_kmap_down=with_kmap_down)
