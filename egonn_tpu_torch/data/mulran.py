"""MulRan raw dataset access (port of `egonn_tpu/data/mulran.py`, host numpy):
the .bin scan loader (float32 N x 4, xyz kept, ground plane at -0.9 m), pose
CSV linking, the train / test geofence split and sequence concatenation, for
the offline generators (`data/generate_mulran.py`).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from egonn_tpu_torch.data.base import PointCloudLoader


def read_bin_xyz(file_pathname: str) -> np.ndarray:
    """(N, 3) xyz of a float32 N x 4 .bin scan (x, y, z, reflectance)."""
    pc = np.fromfile(file_pathname, dtype=np.float32)
    return np.reshape(pc, (-1, 4))[:, :3]


class MulranPointCloudLoader(PointCloudLoader):
    def set_properties(self):
        self.ground_plane_level = -0.9

    def read_pc(self, file_pathname: str) -> np.ndarray:
        return read_bin_xyz(file_pathname)


# Faulty point clouds (0 points) — reference datasets/mulran/utils.py:6
FAULTY_POINTCLOUDS = [1566279795718079314]

# Sejong test-region geofence — reference datasets/mulran/utils.py:8-16
TEST_REGION_CENTRES = np.array(
    [
        [345090.0743, 4037591.323],
        [345090.483, 4044700.04],
        [350552.0308, 4041000.71],
        [349252.0308, 4044800.71],
    ]
)
TEST_REGION_RADIUS = 500
TEST_TRAIN_BOUNDARY = 50


def _dist_to_centres(pos: np.ndarray) -> np.ndarray:
    return np.linalg.norm(pos[:, None, :] - TEST_REGION_CENTRES[None, :, :], axis=-1)


def in_train_split(pos: np.ndarray) -> np.ndarray:
    assert pos.ndim == 2 and pos.shape[1] == 2
    return (_dist_to_centres(pos) > TEST_REGION_RADIUS + TEST_TRAIN_BOUNDARY).all(axis=1)


def in_test_split(pos: np.ndarray) -> np.ndarray:
    assert pos.ndim == 2 and pos.shape[1] == 2
    return (_dist_to_centres(pos) < TEST_REGION_RADIUS).any(axis=1)


def find_nearest_ndx(ts: int, timestamps: np.ndarray) -> int:
    ndx = np.searchsorted(timestamps, ts)
    if ndx == 0:
        return ndx
    if ndx == len(timestamps):
        return ndx - 1
    assert timestamps[ndx - 1] <= ts <= timestamps[ndx]
    return ndx - 1 if ts - timestamps[ndx - 1] < timestamps[ndx] - ts else ndx


def read_lidar_poses(poses_filepath: str, lidar_filepath: str,
                     pose_time_tolerance: float = 1.0):
    """Link each LiDAR scan to the nearest global pose by timestamp
    (reference datasets/mulran/utils.py:51-108)."""
    with open(poses_filepath, "r") as h:
        txt_poses = h.readlines()

    n = len(txt_poses)
    system_timestamps = np.zeros((n,), dtype=np.int64)
    poses = np.zeros((n, 4, 4), dtype=np.float64)
    for ndx, pose in enumerate(txt_poses):
        temp = [e.strip() for e in pose.split(",")]
        assert len(temp) == 13, f"Invalid line in global poses file: {temp}"
        system_timestamps[ndx] = int(temp[0])
        poses[ndx, :3, :4] = np.array([float(e) for e in temp[1:]]).reshape(3, 4)
        poses[ndx, 3] = [0.0, 0.0, 0.0, 1.0]

    order = np.argsort(system_timestamps)
    system_timestamps = system_timestamps[order]
    poses = poses[order]

    all_lidar_timestamps = sorted(
        int(os.path.splitext(f)[0])
        for f in os.listdir(lidar_filepath)
        if os.path.splitext(f)[1] == ".bin"
    )

    lidar_timestamps, lidar_poses = [], []
    count_rejected = 0
    for lidar_ts in all_lidar_timestamps:
        if lidar_ts in FAULTY_POINTCLOUDS:
            continue
        closest = find_nearest_ndx(lidar_ts, system_timestamps)
        if abs(int(system_timestamps[closest]) - lidar_ts) > pose_time_tolerance * 1e9:
            count_rejected += 1
            continue
        lidar_timestamps.append(lidar_ts)
        lidar_poses.append(poses[closest])

    print(f"{len(lidar_timestamps)} scans with valid pose, "
          f"{count_rejected} rejected due to unknown pose")
    return np.array(lidar_timestamps, dtype=np.int64), np.array(lidar_poses, dtype=np.float64)


class MulranSequence:
    """One MulRan sequence restricted to a split, with min-displacement filtering
    (reference datasets/mulran/mulran_raw.py:28-101)."""

    def __init__(self, dataset_root: str, sequence_name: str, split: str,
                 min_displacement: float = 0.2):
        assert os.path.exists(dataset_root), f"Cannot access dataset root: {dataset_root}"
        assert split in ["train", "test", "all"]
        self.dataset_root = dataset_root
        self.sequence_name = sequence_name
        sequence_path = os.path.join(dataset_root, sequence_name)
        assert os.path.exists(sequence_path), f"Cannot access sequence: {sequence_path}"
        self.split = split
        self.min_displacement = min_displacement
        self.pose_time_tolerance = 1.0

        self.pose_file = os.path.join(sequence_path, "global_pose.csv")
        assert os.path.exists(self.pose_file), f"Cannot access global pose file: {self.pose_file}"
        self.rel_lidar_path = os.path.join(sequence_name, "Ouster")
        lidar_path = os.path.join(dataset_root, self.rel_lidar_path)
        assert os.path.exists(lidar_path), f"Cannot access lidar scans: {lidar_path}"
        self.pc_loader = MulranPointCloudLoader()

        timestamps, poses = read_lidar_poses(self.pose_file, lidar_path, self.pose_time_tolerance)
        self.timestamps, self.poses = self._filter(timestamps, poses)
        self.rel_scan_filepath = [
            os.path.join(self.rel_lidar_path, f"{e}.bin") for e in self.timestamps
        ]
        print(f"{len(self.timestamps)} scans in {sequence_name}-{split}")

    def __len__(self):
        return len(self.rel_scan_filepath)

    def __getitem__(self, ndx):
        reading_filepath = os.path.join(self.dataset_root, self.rel_scan_filepath[ndx])
        reading = self.pc_loader(reading_filepath)
        return {
            "pc": reading,
            "pose": self.poses[ndx],
            "ts": self.timestamps[ndx],
            "position": self.poses[ndx][:2, 3],
        }

    def _filter(self, ts: np.ndarray, poses: np.ndarray):
        positions = poses[:, :2, 3]
        if self.split != "all" and self.sequence_name.lower()[:6] == "sejong":
            mask = in_train_split(positions) if self.split == "train" else in_test_split(positions)
            ts, poses, positions = ts[mask], poses[mask], positions[mask]

        # min-displacement filter.  NOTE: replicates the reference quirk
        # (mulran_raw.py:88-97) where prev_position is only advanced when a scan is
        # KEPT after the first, so the first element's position is never updated —
        # we reproduce the exact same control flow.
        prev_position = None
        keep = []
        for ndx, position in enumerate(positions):
            if prev_position is None:
                keep.append(ndx)
            else:
                if np.linalg.norm(prev_position - position) > self.min_displacement:
                    keep.append(ndx)
                    prev_position = position
        return ts[keep], poses[keep]


class MulranSequences:
    """Multiple sequences as one globally-indexed dataset with an xy index
    (reference datasets/mulran/mulran_raw.py:104-159)."""

    def __init__(self, dataset_root: str, sequence_names: List[str], split: str,
                 min_displacement: float = 0.2):
        assert len(sequence_names) > 0
        self.dataset_root = dataset_root
        self.sequence_names = sequence_names
        self.split = split
        self.sequences = [
            MulranSequence(dataset_root, name, split=split, min_displacement=min_displacement)
            for name in sequence_names
        ]
        self.cumulative_sizes = np.cumsum([len(s) for s in self.sequences])
        n = int(self.cumulative_sizes[-1])
        self.poses = np.concatenate([s.poses for s in self.sequences]).reshape(n, 4, 4)
        self.timestamps = np.concatenate([s.timestamps for s in self.sequences])
        self.rel_scan_filepath = [p for s in self.sequences for p in s.rel_scan_filepath]

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def __getitem__(self, ndx):
        seq_i = int(np.searchsorted(self.cumulative_sizes, ndx, side="right"))
        base = 0 if seq_i == 0 else int(self.cumulative_sizes[seq_i - 1])
        return self.sequences[seq_i][ndx - base]

    def get_xy(self):
        return self.poses[:, :2, 3]

    def find_neighbours_ndx(self, position: np.ndarray, radius: float) -> np.ndarray:
        assert position.ndim == 1 and position.shape[0] == 2
        d = np.linalg.norm(self.get_xy() - position[None, :], axis=1)
        return np.where(d <= radius)[0].astype(np.int32)


def relative_pose(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """MulRan relative pose WITH the translation sign fix
    (reference datasets/mulran/utils.py:111-125)."""
    m = np.linalg.inv(m2) @ m1
    m[:3, 3] = -m[:3, 3]
    return m
