"""Synthetic LiDAR place-recognition dataset (port of
`egonn_tpu/data/synthetic.py`): the same scans and pickles for the same seed.

A loop trajectory through a procedural city of random vertical structures
(walls, poles) over a ground disc; a scan at pose T holds the world points
within `scan_radius`, in the sensor frame, subsampled and with noise, so
nearby poses share geometry.  The on-disk contract is MulRan's: float32
N x 4 .bin scans, training-tuple pickles and an evaluation-set pickle.
"""
from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

from egonn_tpu_torch.data.base import (
    EvaluationSet,
    EvaluationTuple,
    PointCloudLoader,
    TrainingTuple,
)
from egonn_tpu_torch.data.mulran import read_bin_xyz
from egonn_tpu_torch.ops.geometry import rotz


class SyntheticPointCloudLoader(PointCloudLoader):
    """Reads the .bin scans of `generate_synthetic_dataset`."""

    def set_properties(self):
        self.ground_plane_level = -0.9

    def read_pc(self, file_pathname: str) -> np.ndarray:
        return read_bin_xyz(file_pathname)


def _make_world(rng: np.random.Generator, extent: float, n_structures: int):
    """Random vertical structures, each a small dense point cluster."""
    pts = []
    for _ in range(n_structures):
        cx, cy = rng.uniform(-extent, extent, 2)
        kind = rng.integers(0, 2)
        if kind == 0:  # wall segment
            length = rng.uniform(5, 25)
            angle = rng.uniform(0, np.pi)
            n = int(length * 24)
            t = rng.uniform(0, length, n)
            x = cx + t * np.cos(angle)
            y = cy + t * np.sin(angle)
            z = rng.uniform(0.0, rng.uniform(3, 12), n)
        else:  # pole / tree
            n = 160
            x = cx + rng.normal(0, 0.3, n)
            y = cy + rng.normal(0, 0.3, n)
            z = rng.uniform(0, rng.uniform(2, 8), n)
        pts.append(np.stack([x, y, z], 1))
    return np.concatenate(pts).astype(np.float32)


def _loop_trajectory(n_scans: int, extent: float):
    """Figure-of-eight loop with revisits; yaw follows the heading."""
    t = np.linspace(0, 2 * np.pi, n_scans, endpoint=False)
    x = 0.65 * extent * np.sin(t)
    y = 0.40 * extent * np.sin(2 * t)
    yaw = np.arctan2(np.gradient(y), np.gradient(x))
    poses = np.zeros((n_scans, 4, 4))
    for i in range(n_scans):
        m = rotz(yaw[i])
        m[0, 3], m[1, 3], m[2, 3] = x[i], y[i], 1.8
        poses[i] = m
    return poses


def _render_scan(rng, world: np.ndarray, pose: np.ndarray, scan_radius: float,
                 max_points: int) -> np.ndarray:
    pos = pose[:3, 3]
    d2 = np.sum((world[:, :2] - pos[None, :2]) ** 2, axis=1)
    near = world[d2 < scan_radius**2]
    # ground disc around the sensor
    n_ground = max(256, len(near) // 3)
    gr = np.sqrt(rng.uniform(1, scan_radius**2, n_ground))
    ga = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack(
        [pos[0] + gr * np.cos(ga), pos[1] + gr * np.sin(ga), np.zeros(n_ground)], 1
    ).astype(np.float32)
    pts_w = np.concatenate([near, ground])
    inv = np.linalg.inv(pose)  # world -> sensor frame
    pts = pts_w @ inv[:3, :3].T + inv[:3, 3]
    if len(pts) > max_points:
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    pts = pts + rng.normal(0, 0.02, pts.shape)
    return pts.astype(np.float32)


def generate_synthetic_dataset(
    root: str,
    n_scans: int = 64,
    extent: float = 160.0,
    scan_radius: float = 60.0,
    max_points: int = 16384,
    seed: int = 0,
    positive_radius: float = 10.0,
    non_negative_radius: float = 25.0,
    train_frac: float = 0.75,
) -> Tuple[str, str, str]:
    """Write the scans, train / val tuple pickles and an evaluation-set
    pickle under `root`; returns the three pickles' names relative to it.

    Positives and non-negatives by 2-D pose distance, `positives_poses` the
    ground-truth relative poses.  The radii are wider than the reference's
    2 / 10 m, because consecutive scans are several metres apart.  The
    evaluation set takes the even scans as the map and the odd ones as
    queries."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "scans"), exist_ok=True)
    world = _make_world(rng, extent, n_structures=240)
    poses = _loop_trajectory(n_scans, extent)

    rel_paths = []
    for i in range(n_scans):
        pc = _render_scan(rng, world, poses[i], scan_radius, max_points)
        refl = np.zeros((len(pc), 1), dtype=np.float32)
        rel = os.path.join("scans", f"{i:06d}.bin")
        np.concatenate([pc, refl], axis=1).astype(np.float32).tofile(os.path.join(root, rel))
        rel_paths.append(rel)

    xy = poses[:, :2, 3]
    d = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)

    def build_tuples(ids):
        ids_arr = np.asarray(sorted(ids))
        remap = {j: k for k, j in enumerate(ids_arr)}  # compact ids within the subset
        queries = {}
        for new_id, i in enumerate(ids_arr):
            pos_sel = [j for j in ids_arr if j != i and d[i, j] <= positive_radius]
            nneg_sel = [j for j in ids_arr if d[i, j] <= non_negative_radius]
            queries[new_id] = TrainingTuple(
                id=new_id,
                timestamp=i,
                rel_scan_filepath=rel_paths[i],
                positives=np.array(sorted(remap[j] for j in pos_sel), dtype=np.int64),
                non_negatives=np.array(sorted(remap[j] for j in nneg_sel), dtype=np.int64),
                pose=poses[i],
                positives_poses={remap[j]: np.linalg.inv(poses[j]) @ poses[i]
                                 for j in pos_sel},
            )
        return queries

    ids = np.arange(n_scans)
    n_train = int(train_frac * n_scans)
    train_ids, val_ids = ids[:n_train], ids[n_train:]

    train_name, val_name, eval_name = (
        "train_synthetic.pickle",
        "val_synthetic.pickle",
        "test_synthetic.pickle",
    )
    with open(os.path.join(root, train_name), "wb") as f:
        pickle.dump(build_tuples(train_ids), f)
    with open(os.path.join(root, val_name), "wb") as f:
        pickle.dump(build_tuples(val_ids), f)

    def eval_tuples(sel):
        return [EvaluationTuple(int(i), rel_paths[i], position=xy[i].astype(np.float32),
                                pose=poses[i]) for i in sel]

    EvaluationSet(eval_tuples(ids[1::2]), eval_tuples(ids[::2])).save(
        os.path.join(root, eval_name))
    return train_name, val_name, eval_name
