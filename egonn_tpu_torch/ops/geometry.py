"""Polar <-> cartesian conversion (port of `egonn_tpu/ops/geometry.py:18-40`),
float32 with the reference's formulas."""
from __future__ import annotations

import math

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
