"""Normalized submaps standing in for Oxford RobotCar's (PointNetVLAD's
benchmark, on which MinkLoc3D and MinkLoc3Dv2 train), made on the device
from the frozen `lidar_sim` scans (`core/scans.py`).

A place is one scan of `RAW_POINTS` points; its other scans are that scan
under a z-rotation of at most 10 deg, an xy shift of at most 1 m and 1 cm
jitter.  Each scan is then cut as an Oxford submap is made: the points
within `CROP_RADIUS` m (xy) of its own sensor origin, downsampled on a voxel
grid of `CROP_RADIUS` / 100 m (one point of each cell, drawn at random: about
the grid of 0.01 once the submap is scaled into [-1, 1]), the ground thinned
(a structure point weighs 1, a ground point `GROUND_WEIGHT`, the 4,096
points drawn among the kept ones without replacement in proportion),
zero-mean, and scaled by its largest absolute coordinate into [-1, 1].  The
scan's last 9% of points are its vertical structures (`scans.lidar_scans`
makes them last).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.core.scans import POLE_FRACTION, lidar_scans

RAW_POINTS = 32768
CROP_RADIUS = 25.0
GROUND_WEIGHT = 0.25
SCANS_PER_CALL = 256  # scans made at once (device memory)


def _rotz(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([c, -s, zero, s, c, zero, zero, zero, one], -1).reshape(-1, 3, 3)


def _submaps(scans: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """(b, RAW_POINTS, 3) metric scans -> (b, n, 3) normalized submaps."""
    b, raw, _ = scans.shape
    # one point of each grid cell: the first of its cell in a random order
    cells = torch.floor(scans / (CROP_RADIUS / 100.0)).to(torch.int64) + (1 << 20)
    keys = (cells[..., 0] << 42) | (cells[..., 1] << 21) | cells[..., 2]
    shuffle = torch.argsort(torch.rand((b, raw), generator=gen, device=scans.device), dim=1)
    sk, order = torch.sort(torch.gather(keys, 1, shuffle), dim=1, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    kept = torch.zeros_like(first).scatter_(1, torch.gather(shuffle, 1, order), first)
    weight = torch.full((b, raw), GROUND_WEIGHT, device=scans.device)
    weight[:, raw - int(POLE_FRACTION * raw):] = 1.0
    weight = torch.where(kept & (scans[..., :2].norm(dim=-1) <= CROP_RADIUS), weight, 0.0)
    rows = torch.multinomial(weight, n, replacement=False, generator=gen)
    pc = torch.gather(scans, 1, rows[..., None].expand(-1, -1, 3))
    pc = pc - pc.mean(1, keepdim=True)
    return pc / pc.abs().amax((1, 2), keepdim=True)


def make_places(gen: torch.Generator, places: int, scans_per_place: int,
                points: int) -> torch.Tensor:
    """(places, scans_per_place, points, 3) submaps, scan 0 of a place its
    base scan, the others moved as the module says."""
    dev = gen.device

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    per_call = max(1, SCANS_PER_CALL // scans_per_place)
    out = []
    for at in range(0, places, per_call):
        p = min(per_call, places - at)
        base = lidar_scans(p, RAW_POINTS, gen)
        moved = [base]
        for _ in range(scans_per_place - 1):
            rot = _rotz(math.radians(10.0) * (2.0 * rand(p) - 1.0))
            heading = 2 * math.pi * rand(p)
            shift = rand(p)[:, None] * torch.stack(
                [torch.cos(heading), torch.sin(heading), torch.zeros_like(heading)], -1)
            jitter = 0.01 * torch.randn((p, RAW_POINTS, 3), generator=gen, device=dev)
            moved.append(base @ rot.transpose(1, 2) + shift[:, None, :] + jitter)
        raw = torch.stack(moved, 1).reshape(p * scans_per_place, RAW_POINTS, 3)
        out.append(_submaps(raw, points, gen).reshape(p, scans_per_place, points, 3))
    return torch.cat(out)


def make_batch(gen: torch.Generator, places: int, scans_per_place: int,
               points: int) -> Dict[str, torch.Tensor]:
    """A global batch of the staged step: every scan of `places` places,
    dealt in an order drawn from gen, with its positive (same place, not
    itself) and negative (another place) masks."""
    dev = gen.device
    clouds = make_places(gen, places, scans_per_place, points).reshape(-1, points, 3)
    order = torch.randperm(clouds.shape[0], generator=gen, device=dev)
    labels = order // scans_per_place
    eye = torch.eye(clouds.shape[0], dtype=torch.bool, device=dev)
    return dict(clouds=clouds[order].contiguous(),
                point_mask=torch.ones(clouds.shape[:2], dtype=torch.bool, device=dev),
                positives_mask=(labels[:, None] == labels[None]) & ~eye,
                negatives_mask=labels[:, None] != labels[None])
