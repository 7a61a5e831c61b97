"""KITTI odometry scans (port of `egonn_tpu/data/kitti.py`'s loader): velodyne
float32 N x 4 .bin files, ground plane at -1.5 m.  The velodyne-frame relative
pose is `ops/geometry.py::kitti_relative_pose`."""
from __future__ import annotations

import numpy as np

from egonn_tpu_torch.data.base import PointCloudLoader
from egonn_tpu_torch.data.mulran import read_bin_xyz


class KittiPointCloudLoader(PointCloudLoader):
    def set_properties(self):
        self.ground_plane_level = -1.5

    def read_pc(self, file_pathname: str) -> np.ndarray:
        return read_bin_xyz(file_pathname)
