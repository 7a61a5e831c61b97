"""Input pipeline pieces (port of `egonn_tpu/data/pipeline.py`): the point
budget per dataset, host-side padding of raw clouds, and the on-device
preprocess (augment -> quantize -> dedup -> coordinate pyramid)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from egonn_tpu_torch.data.augmentation import (
    draw_train_set_transform,
    draw_train_transform,
    train_set_transform,
    train_transform,
)
from egonn_tpu_torch.sparse.pyramid import PyramidSpec, build_pyramid
from egonn_tpu_torch.sparse.types import Pyramid

# Truncations of overlong clouds since process start (read with
# pad_cloud_drop_stats); the first one also prints a warning.
_DROP_STATS = {"clouds_truncated": 0, "points_dropped": 0, "warned": False}


def pad_cloud_drop_stats() -> dict:
    return dict(_DROP_STATS)


def default_num_points(dataset_type: str) -> int:
    """Points per cloud: KITTI's velodyne scans hold ~120-130k points before
    ground and zero removal; MulRan and SouthBay fit in 65,536."""
    return 131072 if dataset_type.lower() == "kitti" else 65536


def resolve_num_points(model_params, dataset_type: str) -> int:
    """A num_points set in the config wins; otherwise the dataset's default."""
    if getattr(model_params, "num_points_explicit", True):
        return model_params.num_points
    return default_num_points(dataset_type)


def pad_cloud(pc: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad or trim an (M, 3) cloud to (n, 3) float32 + (n,) mask.  An
    overlong cloud is subsampled at random, with the generator seeded from
    the cloud's content, so the choice is deterministic per scan."""
    m = len(pc)
    out = np.zeros((n, 3), dtype=np.float32)
    mask = np.zeros((n,), dtype=bool)
    if m > n:
        seed = [m, int(abs(float(pc[0, 0])) * 1e6) % (1 << 31),
                int(abs(float(pc[m // 2, 1])) * 1e6) % (1 << 31)]
        sel = np.random.default_rng(seed).choice(m, n, replace=False)
        out[:] = pc[sel]
        mask[:] = True
        _DROP_STATS["clouds_truncated"] += 1
        _DROP_STATS["points_dropped"] += m - n
        if not _DROP_STATS["warned"]:
            _DROP_STATS["warned"] = True
            print(f"WARNING: cloud with {m} points subsampled to the {n}-point budget")
    else:
        out[:m] = pc
        mask[:m] = True
    return out, mask


def device_preprocess_global(clouds: torch.Tensor, point_mask: torch.Tensor, quantizer,
                             spec: PyramidSpec, gen: Optional[torch.Generator] = None,
                             aug_mode: int = 2, with_kmap_down: bool = False) -> Pyramid:
    """(augment ->) quantize -> dedup -> pyramid, on the clouds' device.

    clouds (B, N, 3), point_mask (B, N).  With a generator the clouds are
    augmented first: each cloud's TrainTransform, then one TrainSetTransform
    for the batch.  with_kmap_down builds the maps a training forward needs."""
    if gen is not None:
        b, n, _ = clouds.shape
        clouds = train_transform(clouds, point_mask,
                                 draw_train_transform(gen, b, n, aug_mode), aug_mode)
        clouds = train_set_transform(clouds, draw_train_set_transform(gen, aug_mode), aug_mode)
    res = quantizer.quantize(clouds, point_mask, spec.capacities[0], need_index=False)
    return build_pyramid(res.coords_t, res.mask, spec, n_unique0=res.n_unique, keys0=res.keys,
                         with_kmap_down=with_kmap_down)
