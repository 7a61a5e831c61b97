"""Geometry (port of `egonn_tpu/ops/geometry.py`): polar <-> cartesian
conversion, float32 with the reference's formulas, and SE(3) transforms."""
from __future__ import annotations

import math

import numpy as np
import torch


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
