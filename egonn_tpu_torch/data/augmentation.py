"""Point cloud augmentations (port of `egonn_tpu/data/augmentation.py`),
batched over a leading cloud dimension.

* TrainTransform, per cloud: jitter (sigma 0.1, clip 0.2) -> remove random
  points (r ~ U(0, 0.1)) -> random translation (0.3 * N(0, 1)) -> (aug_mode 2
  only) random z-rotation (up to 180 deg) -> remove a random block (p 0.4).
  The jitter and translation amplitudes are those of metric LiDAR scans;
  submaps normalized to [-1, 1] (Oxford RobotCar's, as MinkLoc3D and
  MinkLoc3Dv2 train on them) take sigma 0.001, clip 0.002 and 0.01 * N(0, 1)
  (`amplitudes`, chosen by the dataset).
* TrainSetTransform, one draw for the whole batch: aug_mode 1 a z-rotation
  (up to 5 deg) then a random axis flip (p = .25, .25, 0); aug_mode 2 the
  flip only.

Removals zero the point coordinates instead of deleting the points, and a
rotation is `pc @ R`, as in the reference.

Each transform is split into a draw, which takes its random numbers from a
`torch.Generator`, and an apply, which takes the drawn numbers.  JAX's
PRNG cannot be reproduced in torch, so the tests hand the numbers JAX drew to
the apply functions.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

Draws = Dict[str, torch.Tensor]


def amplitudes(dataset: Optional[str] = None) -> tuple:
    """TrainTransform's (jitter sigma, jitter clip, translation) for the
    clouds of `dataset`: Oxford's submaps are normalized to [-1, 1], every
    other dataset's scans are metric."""
    return (0.001, 0.002, 0.01) if dataset == "oxford" else (0.1, 0.2, 0.3)


# ---------------------------------------------------------------------------
# apply: the transforms, given their random numbers (batched over clouds)
# ---------------------------------------------------------------------------

def jitter_points(pc: torch.Tensor, noise: torch.Tensor, sigma: float = 0.1,
                  clip: float = 0.2) -> torch.Tensor:
    """noise ~ N(0, 1), like pc."""
    return pc + torch.clamp(sigma * noise, -clip, clip)


def remove_random_points(pc: torch.Tensor, r: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Zero the points whose u ~ U(0, 1) (B, N) is below the cloud's drop
    fraction r ~ U(r_min, r_max) (B,)."""
    drop = u < r[:, None]
    return torch.where(drop[..., None], 0.0, pc)


def random_translation(pc: torch.Tensor, t: torch.Tensor, max_delta: float = 0.3
                       ) -> torch.Tensor:
    """t ~ N(0, 1) (B, 1, 3); the shift is max_delta * t."""
    return pc + max_delta * t


def rotz_matrix(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations about +z for theta (...,) radians."""
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([c, -s, zero, s, c, zero, zero, zero, one], -1).reshape(
        *theta.shape, 3, 3)


def random_rotation_z(pc: torch.Tensor, u: torch.Tensor, max_theta_deg: float = 180.0
                      ) -> torch.Tensor:
    """Rotation about +z by theta = max * 2 (u - 0.5), u ~ U(0, 1) (B,); the
    reference rotates by pc @ R (not R^T)."""
    theta = (math.pi * max_theta_deg / 180.0) * 2.0 * (u - 0.5)
    return pc @ rotz_matrix(theta)


def remove_random_block(pc: torch.Tensor, mask: torch.Tensor, area_frac: torch.Tensor,
                        aspect: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor,
                        u_apply: torch.Tensor, p: float = 0.4) -> torch.Tensor:
    """Zero the points inside a random (x, y) rectangle of the valid points'
    bounding box, with probability p.  Per cloud (each (B,)): area_frac ~
    U(scale) of the box's area, aspect ~ U(ratio), ux, uy, u_apply ~ U(0, 1)."""
    big = 1e9
    min_c = torch.where(mask[..., None], pc, big).amin(1)   # (B, 3)
    max_c = torch.where(mask[..., None], pc, -big).amax(1)
    span = max_c - min_c
    area = span[:, 0] * span[:, 1]
    erase_area = area_frac * area
    h = torch.sqrt(erase_area * aspect)
    w = torch.sqrt(erase_area / aspect)
    x = (min_c[:, 0] + ux * (span[:, 0] - w))[:, None]
    y = (min_c[:, 1] + uy * (span[:, 1] - h))[:, None]
    inside = ((x < pc[..., 0]) & (pc[..., 0] < x + w[:, None])
              & (y < pc[..., 1]) & (pc[..., 1] < y + h[:, None]))
    apply = (u_apply < p)[:, None]
    return torch.where((inside & apply)[..., None], 0.0, pc)


def random_flip(pc: torch.Tensor, r: torch.Tensor, p=(0.25, 0.25, 0.0)) -> torch.Tensor:
    """Flip at most one axis, chosen by r ~ U(0, 1) (0-d) against the
    cumulative probabilities."""
    csum = [float(c) for c in np.cumsum(p)]  # compared in f32, as JAX's weak floats
    sign_x = torch.where(r <= csum[0], -1.0, 1.0)
    sign_y = torch.where((r > csum[0]) & (r <= csum[1]), -1.0, 1.0)
    sign_z = torch.where((r > csum[1]) & (r <= csum[2]), -1.0, 1.0)
    return pc * torch.stack([sign_x, sign_y, sign_z])


def train_transform(pc: torch.Tensor, mask: torch.Tensor, draws: Draws, aug_mode: int = 2,
                    dataset: Optional[str] = None) -> torch.Tensor:
    """TrainTransform of each cloud of pc (B, N, 3) with its draws
    (`draw_train_transform`), at the amplitudes of `dataset`'s clouds."""
    if aug_mode not in (1, 2):
        raise NotImplementedError(f"Unknown aug_mode: {aug_mode}")
    sigma, clip, delta = amplitudes(dataset)
    pc = jitter_points(pc, draws["noise"], sigma, clip)
    pc = remove_random_points(pc, draws["remove_r"], draws["remove_u"])
    pc = random_translation(pc, draws["translation"], delta)
    if aug_mode == 2:
        pc = random_rotation_z(pc, draws["rotation_u"], 180.0)
    return remove_random_block(pc, mask, draws["block_area"], draws["block_aspect"],
                               draws["block_ux"], draws["block_uy"], draws["block_apply"])


def train_set_transform(pc: torch.Tensor, draws: Draws, aug_mode: int = 2) -> torch.Tensor:
    """TrainSetTransform: one transform for the whole batch (B, N, 3)."""
    if aug_mode == 1:
        pc = random_rotation_z(pc, draws["rotation_u"].reshape(1), 5.0)
    elif aug_mode != 2:
        raise NotImplementedError(f"Unknown aug_mode: {aug_mode}")
    return random_flip(pc, draws["flip_u"])


# ---------------------------------------------------------------------------
# draw: the random numbers, from a torch.Generator
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    return torch.empty(shape, device=gen.device).uniform_(lo, hi, generator=gen)


def _normal(gen: torch.Generator, shape):
    return torch.empty(shape, device=gen.device).normal_(generator=gen)


def draw_train_transform(gen: torch.Generator, b: int, n: int, aug_mode: int = 2,
                         scale=(0.02, 0.33), ratio=(0.3, 3.3)) -> Draws:
    """The random numbers of `train_transform` for b clouds of n points, on
    the generator's device."""
    draws = {
        "noise": _normal(gen, (b, n, 3)),
        "remove_r": _uniform(gen, (b,), 0.0, 0.1),
        "remove_u": _uniform(gen, (b, n)),
        "translation": _normal(gen, (b, 1, 3)),
        "block_area": _uniform(gen, (b,), *scale),
        "block_aspect": _uniform(gen, (b,), *ratio),
        "block_ux": _uniform(gen, (b,)),
        "block_uy": _uniform(gen, (b,)),
        "block_apply": _uniform(gen, (b,)),
    }
    if aug_mode == 2:
        draws["rotation_u"] = _uniform(gen, (b,))
    return draws


def draw_train_set_transform(gen: torch.Generator, aug_mode: int = 2) -> Draws:
    """The random numbers of `train_set_transform`."""
    draws = {"flip_u": _uniform(gen, ())}
    if aug_mode == 1:
        draws["rotation_u"] = _uniform(gen, ())
    return draws
