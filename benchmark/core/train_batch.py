"""A full-width EgoNN training batch made on the device (the benchmark's frozen
copy of the port's `data/train_batch.py`): the global half as places with
two scans each, the second the first under a z-rotation of at most 10 deg,
an xy shift of at most 1 m and 1 cm jitter, with positive / negative masks;
the local half as pairs, the positive the anchor under a rigid transform
(z-rotation up to `rot_max`, xy translation up to `trans_max`), each cloud
reduced to one point per polar voxel (the first, in source order) by the
reference's quantizer and padded back to n points, as the local training
dataset prepares it.
"""
from __future__ import annotations

import math

import torch

from benchmark.core.scans import lidar_scans
from benchmark.reference import sparse


def _rotz(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([c, -s, zero, s, c, zero, zero, zero, one], -1).reshape(-1, 3, 3)


def _first_point_per_voxel(quantizer, pc: torch.Tensor):
    """(B, n, 3) clouds -> each cloud's first point of every voxel, in source
    order, zero padded to n, and the (B, n) mask of the kept rows."""
    b, n, _ = pc.shape
    mask = torch.ones((b, n), dtype=torch.bool, device=pc.device)
    keys = sparse.pack_keys(quantizer.voxels(pc), mask, sparse.PackSpec())
    kept_keys, rows, _, _ = sparse.dedup(keys, n)
    kept = kept_keys != sparse.MAXKEY
    rows = torch.sort(torch.where(kept, rows, n), dim=1).values  # kept rows first, ascending
    keep = torch.arange(n, device=pc.device)[None] < kept.sum(1, keepdim=True)
    out = torch.gather(pc, 1, torch.where(keep, rows, 0)[..., None].expand(-1, -1, 3))
    return torch.where(keep[..., None], out, 0.0), keep


def make_train_batch(quantizer, gen: torch.Generator, n_places: int, n_pairs: int,
                     n_points: int, rot_max: float, trans_max: float):
    """(g, l) dicts of the train step, on the generator's device."""
    dev = gen.device

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    base = lidar_scans(n_places, n_points, gen)
    rot = _rotz(math.radians(10.0) * (2.0 * rand(n_places) - 1.0))
    heading = 2 * math.pi * rand(n_places)
    shift = rand(n_places)[:, None] * torch.stack(
        [torch.cos(heading), torch.sin(heading), torch.zeros_like(heading)], -1)
    jitter = 0.01 * torch.randn((n_places, n_points, 3), generator=gen, device=dev)
    second = base @ rot.transpose(1, 2) + shift[:, None, :] + jitter
    clouds = torch.stack([base, second], 1).reshape(2 * n_places, n_points, 3)
    labels = torch.arange(2 * n_places, device=dev) // 2
    eye = torch.eye(2 * n_places, dtype=torch.bool, device=dev)
    g = dict(clouds=clouds.contiguous(),
             point_mask=torch.ones(clouds.shape[:2], dtype=torch.bool, device=dev),
             positives_mask=(labels[:, None] == labels[None]) & ~eye,
             negatives_mask=labels[:, None] != labels[None])

    anchors = lidar_scans(n_pairs, n_points, gen)
    t_gt = torch.eye(4, device=dev).repeat(n_pairs, 1, 1)
    t_gt[:, :3, :3] = _rotz(rot_max * (2.0 * rand(n_pairs) - 1.0)).transpose(1, 2)
    t_gt[:, :2, 3] = rand(n_pairs, 2) * (2.0 * trans_max) - trans_max
    positives = anchors @ t_gt[:, :3, :3].transpose(1, 2) + t_gt[:, None, :3, 3]
    anc, anc_mask = _first_point_per_voxel(quantizer, anchors)
    pos, pos_mask = _first_point_per_voxel(quantizer, positives)
    l = dict(anc_clouds=anc, anc_mask=anc_mask, pos_clouds=pos, pos_mask=pos_mask, t_gt=t_gt)
    return g, l
