"""Apollo-SouthBay scans (port of `egonn_tpu/data/southbay.py`'s loader): PCD
files, NaN points set to 0 (and so dropped as zero points), ground plane at
-1.6 m."""
from __future__ import annotations

import numpy as np

from egonn_tpu_torch.data.base import PointCloudLoader
from egonn_tpu_torch.data.pcd import read_pcd_xyz


class SouthbayPointCloudLoader(PointCloudLoader):
    def set_properties(self):
        self.ground_plane_level = -1.6

    def read_pc(self, file_pathname: str) -> np.ndarray:
        pc = read_pcd_xyz(file_pathname).astype(np.float64)
        pc[np.isnan(pc).any(axis=1)] = 0.0
        return pc
