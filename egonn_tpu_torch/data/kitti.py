"""KITTI odometry raw dataset access (port of `egonn_tpu/data/kitti.py`, host
numpy): velodyne float32 N x 4 .bin scans (ground plane at -1.5 m), the
cam0-frame pose file and times.txt.  The velodyne-frame relative pose is
`ops/geometry.py::kitti_relative_pose`.
"""
from __future__ import annotations

import os

import numpy as np

from egonn_tpu_torch.data.base import PointCloudLoader
from egonn_tpu_torch.data.mulran import read_bin_xyz
from egonn_tpu_torch.ops.geometry import kitti_relative_pose


class KittiPointCloudLoader(PointCloudLoader):
    def set_properties(self):
        self.ground_plane_level = -1.5

    def read_pc(self, file_pathname: str) -> np.ndarray:
        return read_bin_xyz(file_pathname)


def load_pc(filepath: str) -> np.ndarray:
    """Raw Nx3 velodyne scan without any filtering."""
    pc = np.fromfile(filepath, dtype=np.float32)
    return np.reshape(pc, (-1, 4))[:, :3]


class KittiSequence:
    """One KITTI odometry sequence (reference datasets/kitti/kitti_raw.py:25-88)."""

    def __init__(self, dataset_root: str, sequence_name: str,
                 pose_time_tolerance: float = 1.0, remove_zero_points: bool = True):
        assert os.path.exists(dataset_root), f"Cannot access dataset root: {dataset_root}"
        self.dataset_root = dataset_root
        self.sequence_name = sequence_name
        self.rel_lidar_path = os.path.join("sequences", sequence_name, "velodyne")
        self.pose_file = os.path.join(dataset_root, "poses", sequence_name + ".txt")
        assert os.path.exists(self.pose_file), f"Cannot access sequence pose file: {self.pose_file}"
        self.times_file = os.path.join(dataset_root, "sequences", sequence_name, "times.txt")
        self.pose_time_tolerance = pose_time_tolerance
        self.remove_zero_points = remove_zero_points

        self.rel_lidar_timestamps, self.lidar_poses, filenames = self._read_lidar_poses()
        self.rel_scan_filepath = [
            os.path.join(self.rel_lidar_path, "%06d.bin" % e) for e in filenames
        ]

    def __len__(self):
        return len(self.rel_lidar_timestamps)

    def __getitem__(self, ndx):
        scan_filepath = os.path.join(self.dataset_root, self.rel_scan_filepath[ndx])
        pc = load_pc(scan_filepath)
        if self.remove_zero_points:
            mask = np.all(np.isclose(pc, 0), axis=1)
            pc = pc[~mask]
        return {"pc": pc, "pose": self.lidar_poses[ndx], "ts": self.rel_lidar_timestamps[ndx]}

    def _read_lidar_poses(self):
        lidar_dir = os.path.join(self.dataset_root, self.rel_lidar_path)
        fnames = [
            e for e in os.listdir(lidar_dir) if os.path.isfile(os.path.join(lidar_dir, e))
        ]
        assert len(fnames) > 0, f"No scans under {self.rel_lidar_path}"
        filenames = sorted(int(os.path.split(f)[-1][:-4]) for f in fnames)

        with open(self.pose_file, "r") as h:
            txt_poses = h.readlines()
        poses = np.zeros((len(txt_poses), 4, 4), dtype=np.float64)
        for ndx, pose in enumerate(txt_poses):
            temp = [e.strip() for e in pose.split(" ")]
            assert len(temp) == 12, f"Invalid line in global poses file: {temp}"
            poses[ndx, :3, :4] = np.array([float(e) for e in temp]).reshape(3, 4)
            poses[ndx, 3] = [0.0, 0.0, 0.0, 1.0]
        rel_ts = np.genfromtxt(self.times_file)
        return rel_ts, poses, filenames


def get_relative_pose(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """Reference datasets/kitti/utils.py:14-18 alias."""
    return kitti_relative_pose(m1, m2)
