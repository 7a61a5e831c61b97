"""Capacity calibration (port of the capacity part of
`egonn_tpu/sparse/calibrate.py`): fit the pyramid's per-level voxel
capacities to the occupancy measured on sample clouds, and save or load a
table as JSON.

The JAX module's band-width measures and `auto_calibrate_cached` are not
ported: they size the windows of the TPU's banded kernels, and no port
kernel keeps windows (each indexes its table directly and is exact on all
data, `sparse/kernels.py`), so there is nothing for them to calibrate.
"""
from __future__ import annotations

import json
from dataclasses import replace
from typing import Dict

import numpy as np
import torch

from egonn_tpu_torch.sparse.pyramid import PyramidSpec, build_pyramid


def _level_occupancy(clouds: torch.Tensor, masks: torch.Tensor, quantizer,
                     spec: PyramidSpec) -> list:
    """Max over the batch of each level's true unique-voxel count (voxels
    beyond a level's capacity included)."""
    res = quantizer.quantize(clouds, masks, spec.capacities[0], need_index=False, pack=spec.pack)
    pyr = build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys, n_unique0=res.n_unique)
    counts = torch.stack([pyr[l].n_unique.max() for l in range(spec.num_levels + 1)])
    return [int(v) for v in counts.cpu()]


@torch.no_grad()
def calibrate_capacities(clouds, masks, quantizer, spec: PyramidSpec, margin: float = 1.15,
                         batch: int = 8, quantum: int = 128, floor: int = 256,
                         max_rounds: int = 4, device=torch.device("cuda")) -> tuple:
    """The smallest capacities, padded by `margin` and rounded up to
    `quantum` (at least `floor`, at most level 0's), that hold every level's
    true unique-voxel count on the sample clouds (N_s, N, 3) with masks
    (N_s, N), numpy or tensors.  Level 0 keeps spec.capacities[0]: it is the
    memory budget, not a fit.  A level below a truncating one sees only the
    truncated set, so the fit measures again under the fitted table until it
    is stable (at most `max_rounds` rounds).  The sample is measured in
    batches of `batch` clouds (the last one padded by repeating its last
    cloud) on `device`."""
    clouds = torch.as_tensor(clouds, dtype=torch.float32, device=device)
    masks = torch.as_tensor(masks, dtype=torch.bool, device=device)
    n = clouds.shape[0]
    idx = [torch.as_tensor(np.minimum(np.arange(i, i + batch), n - 1), device=device)
           for i in range(0, n, batch)]
    cur = spec
    for _ in range(max_rounds):
        worst = [0] * (cur.num_levels + 1)
        for ii in idx:
            for l, v in enumerate(_level_occupancy(clouds[ii], masks[ii], quantizer, cur)):
                worst[l] = max(worst[l], v)
        caps = [spec.capacities[0]]
        for l in range(1, cur.num_levels + 1):
            c = max(floor, -(-int(worst[l] * margin) // quantum) * quantum)
            caps.append(min(c, spec.capacities[0]))
        caps = tuple(caps)
        if caps == cur.capacities:
            break
        cur = replace(cur, capacities=caps)
    return cur.capacities


def save_calibration(table: Dict[str, int], path: str) -> None:
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)


def load_calibration(path: str) -> Dict[str, int]:
    with open(path) as f:
        return {str(k): int(v) for k, v in json.load(f).items()}
