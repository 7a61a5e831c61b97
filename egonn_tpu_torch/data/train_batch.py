"""A full-width synthetic training batch of `lidar_sim` scans, in the shapes
of the EgoNN training step (`train/trainer.py`): the global half as places
with two scans each and positive / negative masks, the local half as cloud
pairs under known rigid transforms, prepared as the local training dataset
prepares them.  Used by `chip_smoke.py` and `profile_forward --train`.
"""
from __future__ import annotations

import numpy as np
import torch

from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.data.pipeline import pad_cloud
from egonn_tpu_torch.ops.geometry import rotz


def _dedup_first_point(quantizer, pc, n_points):
    """One point per voxel (the first, in source order), padded back to
    n_points, as the local training dataset prepares each cloud."""
    mask = torch.ones(pc.shape[:1], dtype=torch.bool, device=pc.device)
    res = quantizer.quantize(pc[None], mask[None], pc.shape[0], need_index=True)
    rows = torch.sort(res.index[0][res.mask[0]].long()).values
    return pad_cloud(pc[rows].cpu().numpy(), n_points)


def make_train_batch(tp, quantizer, device, n_places: int = 16, n_points: int = 65536,
                     seed: int = 0):
    """Global: n_places places x 2 scans; the second scan of a place is the
    first under a seeded z-rotation of at most 10 deg, an xy translation of
    at most 1 m and 1 cm jitter; positives are the same place, negatives the
    other places.  Local: local_batch_size pairs, the positive the anchor
    under a seeded rigid transform (z-rotation up to rot_max, xy translation
    up to trans_max, composed into t_gt as the local training dataset does),
    each cloud one point per voxel."""
    rng = np.random.default_rng(seed)
    base = lidar_scan_clouds(n_places, n_points, seed=seed)
    clouds = np.empty((2 * n_places, n_points, 3), np.float32)
    for p in range(n_places):
        m = rotz(np.deg2rad(rng.uniform(-10.0, 10.0)))
        heading = rng.uniform(0, 2 * np.pi)
        shift = rng.uniform(0, 1.0) * np.array([np.cos(heading), np.sin(heading), 0.0])
        clouds[2 * p] = base[p]
        clouds[2 * p + 1] = (base[p] @ m[:3, :3].T + shift
                             + rng.normal(0, 0.01, (n_points, 3)))
    labels = np.arange(2 * n_places) // 2
    positives = (labels[:, None] == labels[None]) & ~np.eye(2 * n_places, dtype=bool)
    negatives = labels[:, None] != labels[None]

    b_loc = tp.local_batch_size
    anchors = torch.from_numpy(lidar_scan_clouds(b_loc, n_points, seed=seed + 1)).to(device)
    anc, anc_m, pos, pos_m = [], [], [], []
    t_gt = np.zeros((b_loc, 4, 4), np.float32)
    for i in range(b_loc):
        angle = rng.uniform(-tp.rot_max, tp.rot_max)
        c, s_ = np.cos(angle), np.sin(angle)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.array([[c, s_, 0.0], [-s_, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
        m[:2, 3] = rng.random(2) * 2.0 * tp.trans_max - tp.trans_max
        mt = torch.from_numpy(m).to(device)
        positive = anchors[i] @ mt[:3, :3].T + mt[:3, 3]
        t_gt[i] = m  # m @ the pair's relative pose, here the identity
        for cloud, pts, msk in ((anchors[i], anc, anc_m), (positive, pos, pos_m)):
            a, b_ = _dedup_first_point(quantizer, cloud, n_points)
            pts.append(a)
            msk.append(b_)
    as_t = lambda x: torch.from_numpy(np.asarray(x)).to(device)  # noqa: E731
    g = dict(clouds=as_t(clouds), point_mask=torch.ones(clouds.shape[:2], dtype=torch.bool,
                                                        device=device),
             positives_mask=as_t(positives), negatives_mask=as_t(negatives))
    l = dict(anc_clouds=as_t(anc), anc_mask=as_t(anc_m), pos_clouds=as_t(pos),
             pos_mask=as_t(pos_m), t_gt=as_t(t_gt))
    return g, l
