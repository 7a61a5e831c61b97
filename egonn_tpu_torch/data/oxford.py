"""Oxford RobotCar submaps of the PointNetVLAD benchmark, as MinkLoc3D and
MinkLoc3Dv2 read them (MinkLoc3Dv2 datasets/pointnetvlad/pnv_raw.py): each
.bin holds one submap as float64 x, y, z triples, its ground already
removed, 4,096 points, zero-mean and scaled to [-1, 1]; nothing is filtered
on reading."""
from __future__ import annotations

import numpy as np

from egonn_tpu_torch.data.base import PointCloudLoader


class OxfordPointCloudLoader(PointCloudLoader):
    def set_properties(self):
        self.remove_zero_points = False
        self.remove_ground_plane = False

    def read_pc(self, file_pathname: str) -> np.ndarray:
        return np.fromfile(file_pathname, dtype=np.float64).reshape(-1, 3)
