"""The cloud-pair dataset of local-descriptor training (port of
`egonn_tpu/data/local_dataset.py`, the reference's
datasets/mulran/mulran_train.py).

Item `ndx` is the anchor's cloud, the cloud of one of its positives at
random, and their ground-truth transform: the pair's relative pose from the
tuple pickle, composed with a random z-rotation (|angle| <= rot_max) and xy
translation (|t| <= trans_max) that are also applied to the positive
(m @ transform, the reference's [[c, s], [-s, c]] matrix kept verbatim).
Both clouds keep one point per voxel (`quantize_np`).  After `set_epoch`
an item's draws come from `np.random.default_rng([0, epoch, ndx])`, so a
run resumed at an epoch boundary sees the uninterrupted run's pairs.  Any
dataset type whose tuples carry `positives_poses` works (MulRan,
synthetic).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from egonn_tpu_torch.data.base import TrainingDataset
from egonn_tpu_torch.data.pipeline import LocalBatch, pad_cloud
from egonn_tpu_torch.ops.quantization import AnyQuantizer, quantize_np


class Training6DOFDataset(TrainingDataset):
    def __init__(self, dataset_path: str, dataset_type: str, query_filename: str,
                 quantizer: AnyQuantizer, rot_max: float = 0.0, trans_max: float = 0.0):
        super().__init__(dataset_path, dataset_type, query_filename)
        self.quantizer = quantizer
        self.rot_max = rot_max
        self.trans_max = trans_max
        self.rng = np.random.default_rng()  # unseeded until set_epoch
        self._epoch: Optional[int] = None
        # anchors with at least one positive that has a relative pose
        self.valid_ids = [ndx for ndx, q in self.queries.items()
                          if len(q.positives) > 0 and q.positives_poses]

    def set_epoch(self, epoch: int):
        """Make each item's draws a function of (epoch, ndx)."""
        self._epoch = int(epoch)

    def _item_rng(self, ndx) -> np.random.Generator:
        if self._epoch is None:
            return self.rng
        return np.random.default_rng([0, self._epoch, int(ndx)])

    def __getitem__(self, ndx):
        rng = self._item_rng(ndx)
        query_pc, _ = super().__getitem__(ndx)
        poses = self.queries[ndx].positives_poses
        positives = [p for p in self.get_positives(ndx) if p in poses]
        if not positives:
            raise ValueError(f"element {ndx} has no positive with a relative pose")
        positive_idx = int(rng.choice(positives, 1)[0])
        positive_pc, _ = super().__getitem__(positive_idx)
        transform = poses[positive_idx]

        angle = rng.uniform(-self.rot_max, self.rot_max)
        c, s = np.cos(angle), np.sin(angle)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
        m[:2, 3] = rng.random(2) * 2.0 * self.trans_max - self.trans_max
        positive_pc = positive_pc @ m[:3, :3].T + m[:3, 3]
        transform = m @ transform

        _, idx1 = quantize_np(self.quantizer, query_pc)
        _, idx2 = quantize_np(self.quantizer, positive_pc)
        return (query_pc[idx1].astype(np.float32), positive_pc[idx2].astype(np.float32),
                transform.astype(np.float32))


def make_local_batch(dataset: Training6DOFDataset, element_ids: Sequence[int],
                     num_points: int) -> LocalBatch:
    """The elements' pairs, padded to num_points."""
    b = len(element_ids)
    anc = np.zeros((b, num_points, 3), np.float32)
    anc_m = np.zeros((b, num_points), bool)
    pos = np.zeros((b, num_points, 3), np.float32)
    pos_m = np.zeros((b, num_points), bool)
    t_gt = np.zeros((b, 4, 4), np.float32)
    for i, ndx in enumerate(element_ids):
        a, p, m = dataset[ndx]
        anc[i], anc_m[i] = pad_cloud(a, num_points)
        pos[i], pos_m[i] = pad_cloud(p, num_points)
        t_gt[i] = m
    return LocalBatch(anc, anc_m, pos, pos_m, t_gt)
