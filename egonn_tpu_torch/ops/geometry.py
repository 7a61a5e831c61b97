"""Geometry (port of `egonn_tpu/ops/geometry.py`): polar <-> cartesian
conversion, float32 with the reference's formulas, SE(3) transforms, and the pose
conventions of the datasets (host numpy, as in the JAX package)."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch


@contextlib.contextmanager
def true_f32():
    """Matmuls in true f32 (TF32 off) inside the block: geometry and
    nearest-neighbour distances lose degrees and ranks in TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def cartesian_to_polar(pc: torch.Tensor) -> torch.Tensor:
    """(..., 3) cartesian XYZ -> (..., 3) polar (theta_deg in [0, 360), range, z),
    theta = 180 + atan2(y, x) * 180/pi."""
    theta = 180.0 + torch.atan2(pc[..., 1], pc[..., 0]) * (180.0 / math.pi)
    dist = torch.sqrt(pc[..., 0] ** 2 + pc[..., 1] ** 2)
    return torch.stack([theta, dist, pc[..., 2]], dim=-1)


def polar_to_cartesian(pc: torch.Tensor) -> torch.Tensor:
    """(..., 3) polar (theta_deg, range, z) -> (..., 3) cartesian."""
    theta = math.pi * (pc[..., 0] - 180.0) / 180.0
    x = torch.cos(theta) * pc[..., 1]
    y = torch.sin(theta) * pc[..., 1]
    return torch.stack([x, y, pc[..., 2]], dim=-1)


def apply_transform(pc: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 SE(3) (or 3x3 SE(2)) transform to an (..., N, D) point set:
    pc @ R^T + t.  m may be (..., D+1, D+1), its leading dims broadcasting
    against pc's."""
    d = pc.shape[-1]
    rot = m[..., :d, :d]
    t = m[..., :d, -1]
    return pc @ rot.transpose(-1, -2) + t[..., None, :]


def rotz(theta: float) -> np.ndarray:
    """4x4 float64 rotation about +z by theta radians (host-side helper)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def relative_pose(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """Relative pose mapping frame-1 coordinates into frame 2: inv(m2) @ m1.
    Not for MulRan poses (use `mulran_relative_pose`)."""
    return np.linalg.inv(m2) @ m1


def mulran_relative_pose(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """MulRan's relative pose: inv(m2) @ m1 with the translation negated, as
    the reference dataset code does it."""
    m = np.linalg.inv(m2) @ m1
    m[:3, 3] = -m[:3, 3]
    return m


# KITTI velodyne -> camera calibration, hardcoded as in the reference
KITTI_VELO2CAM = np.array(
    [
        [7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
        [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
        [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float64,
)


def kitti_relative_pose(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """KITTI relative pose in the velodyne frame from two cam0-frame poses:
    (velo2cam @ m1.T @ inv(m2.T) @ inv(velo2cam)).T."""
    return (KITTI_VELO2CAM @ m1.T @ np.linalg.inv(m2.T) @ np.linalg.inv(KITTI_VELO2CAM)).T


def q2r(q) -> np.ndarray:
    """Rotation matrix from a Hamiltonian quaternion (w, x, y, z)."""
    w, x, y, z = tuple(q)
    n = 1.0 / np.sqrt(x * x + y * y + z * z + w * w)
    x *= n
    y *= n
    z *= n
    w *= n
    return np.array(
        [
            [1.0 - 2.0 * y * y - 2.0 * z * z, 2.0 * x * y - 2.0 * z * w, 2.0 * x * z + 2.0 * y * w],
            [2.0 * x * y + 2.0 * z * w, 1.0 - 2.0 * x * x - 2.0 * z * z, 2.0 * y * z - 2.0 * x * w],
            [2.0 * x * z - 2.0 * y * w, 2.0 * y * z + 2.0 * x * w, 1.0 - 2.0 * x * x - 2.0 * y * y],
        ]
    )


def m2ypr(m: np.ndarray):
    """4x4 transform -> (yaw, pitch, roll); gimbal lock is refused."""
    if m.shape != (4, 4):
        raise ValueError(f"4x4 transform expected, got {m.shape}")
    pitch = np.arctan2(-m[2][0], np.sqrt(m[0][0] ** 2 + m[1][0] ** 2))
    if np.isclose(np.abs(pitch), np.pi / 2):
        raise ValueError("gimbal lock not handled")
    yaw = np.arctan2(m[1][0], m[0][0])
    roll = np.arctan2(m[2][1], m[2][2])
    return yaw, pitch, roll


def m2xyz_ypr(m: np.ndarray):
    """4x4 transform -> (x, y, z, yaw, pitch, roll)."""
    yaw, pitch, roll = m2ypr(m)
    return m[0, 3], m[1, 3], m[2, 3], yaw, pitch, roll


def rotation_error_deg(r_est: torch.Tensor, r_gt: torch.Tensor) -> torch.Tensor:
    """Trace-angle error in degrees between (..., 3, 3) rotations:
    arccos((trace(R_est^T R_gt) - 1) / 2), elementwise products (no matmul,
    so no TF32 on the card)."""
    cos = ((r_est * r_gt).sum(dim=(-1, -2)) - 1.0) / 2.0
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))
