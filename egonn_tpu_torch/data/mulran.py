"""MulRan scans (port of `egonn_tpu/data/mulran.py`'s loader): float32 N x 4
.bin files, xyz kept, ground plane at -0.9 m."""
from __future__ import annotations

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
