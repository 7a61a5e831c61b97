"""Polar / cartesian voxel quantizers (port of `egonn_tpu/ops/quantization.py`).

* `PolarQuantizer([step_theta_deg, step_r_m, step_z_m])`: theta = 180 +
  atan2(y, x) * 180/pi; voxel coords = floor(polar / step); dedup keeps the
  first point per voxel.
* `dequantize(coords) = to_cartesian((coords + 0.5) * step)`.
* `keypoint_position(coords, stride, offset)`: centre = (coords + 0.5) * step;
  kp = centre + offset * (stride * step) / 2, then polar -> cartesian.
  `coords` are absolute level-0 voxel units (multiples of the stride).
* `CartesianQuantizer(step)`: the same without the polar transform.

`quantize(pc, mask, capacity)` takes clouds `(..., N, 3)` with masks
`(..., N)` and returns a fixed-capacity, key-sorted `SortedUnique`, its
keys packed by `pack` (the pyramid spec's; `DEFAULT_PACK` unless a model
asks for another); with `need_inverse` a `Voxelized`, which adds each
point's voxel row.
Float32 throughout; floor semantics for negative coordinates.
`quantize_np` is the host numpy dedup of the local training dataset.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from egonn_tpu_torch.ops.geometry import polar_to_cartesian
from egonn_tpu_torch.sparse.packing import (
    DEFAULT_PACK,
    PackSpec,
    SortedUnique,
    Voxelized,
    sorted_unique,
)
from egonn_tpu_torch.utils.tracing import span


class PolarQuantizer:
    def __init__(self, quant_step: Sequence[float]):
        if len(quant_step) != 3:
            raise ValueError("3 quantization steps expected: sector (degrees), "
                             "ring and z (meters)")
        self.quant_step = np.asarray(quant_step, dtype=np.float32)
        self._step_tensors = {}

    def _steps(self, device: torch.device) -> torch.Tensor:
        """quant_step on `device`, copied there once: a host-to-device copy
        synchronizes the stream."""
        if device not in self._step_tensors:
            self._step_tensors[device] = torch.as_tensor(self.quant_step, device=device)
        return self._step_tensors[device]

    def __getstate__(self):
        """Pickled without the device copies (a data-parallel rank makes its
        own, on its own device)."""
        return {**self.__dict__, "_step_tensors": {}}

    def to_polar_voxels(self, pc: torch.Tensor) -> torch.Tensor:
        """(..., N, 3) cartesian -> (..., 3, N) int32 polar voxel coordinates."""
        s0, s1, s2 = (float(s) for s in self.quant_step)
        theta = 180.0 + torch.atan2(pc[..., 1], pc[..., 0]) * (180.0 / math.pi)
        dist = torch.sqrt(pc[..., 0] ** 2 + pc[..., 1] ** 2)
        return torch.stack([
            torch.floor(theta / s0).to(torch.int32),
            torch.floor(dist / s1).to(torch.int32),
            torch.floor(pc[..., 2] / s2).to(torch.int32),
        ], dim=-2)

    def quantize(self, pc: torch.Tensor, mask: torch.Tensor, capacity: int,
                 need_index: bool = True, pack: PackSpec = DEFAULT_PACK,
                 need_inverse: bool = False) -> Union[SortedUnique, Voxelized]:
        with span("egonn.quantize"):
            return sorted_unique(self.to_polar_voxels(pc), mask, capacity, pack,
                                 need_index=need_index, need_inverse=need_inverse)

    __call__ = quantize

    def dequantize(self, coords: torch.Tensor) -> torch.Tensor:
        """coords: (..., 3) voxel coords (row layout)."""
        polar = (coords.to(torch.float32) + 0.5) * self._steps(coords.device)
        return polar_to_cartesian(polar)

    def keypoint_position(self, coords: torch.Tensor, stride, kp_offset: torch.Tensor
                          ) -> torch.Tensor:
        """coords (..., 3) int voxel coords in absolute level-0 units; stride a
        (3,) tensor on coords' device (or a number, copied to it) giving the
        supervoxel stride; kp_offset (..., 3) in (-1, 1)."""
        step = self._steps(coords.device)
        centres = (coords.to(torch.float32) + 0.5) * step
        supervoxel = torch.as_tensor(stride, dtype=torch.float32,
                                     device=coords.device) * step
        kp = centres + kp_offset * supervoxel / 2.0
        return polar_to_cartesian(kp)


class CartesianQuantizer:
    def __init__(self, quant_step: float):
        self.quant_step = float(quant_step)

    def to_voxels(self, pc: torch.Tensor) -> torch.Tensor:
        """(..., N, 3) -> (..., 3, N) int32 voxel coordinates."""
        return torch.floor(pc.transpose(-1, -2) / self.quant_step).to(torch.int32)

    def quantize(self, pc: torch.Tensor, mask: torch.Tensor, capacity: int,
                 need_index: bool = True, pack: PackSpec = DEFAULT_PACK,
                 need_inverse: bool = False) -> Union[SortedUnique, Voxelized]:
        with span("egonn.quantize"):
            return sorted_unique(self.to_voxels(pc), mask, capacity, pack,
                                 need_index=need_index, need_inverse=need_inverse)

    __call__ = quantize

    def dequantize(self, coords: torch.Tensor) -> torch.Tensor:
        return (coords.to(torch.float32) + 0.5) * self.quant_step

    def keypoint_position(self, coords: torch.Tensor, stride, kp_offset):
        centres = (coords.to(torch.float32) + 0.5) * self.quant_step
        supervoxel = torch.as_tensor(stride, dtype=torch.float32,
                                     device=coords.device) * self.quant_step
        if kp_offset is None:
            return centres
        return centres + kp_offset * supervoxel / 2.0


AnyQuantizer = Union[PolarQuantizer, CartesianQuantizer]


def quantize_np(quantizer: AnyQuantizer, pc: np.ndarray):
    """Host numpy dedup, one point per voxel (the first, in source order), as
    the local training dataset prepares each cloud.  Returns (voxel coords
    int32 (M, 3), indices of the kept source points (M,), ascending): the
    JAX package's result, from a 1-D unique over one int64 key per voxel
    where the coordinates' spans fit one (its row-wise unique sorts 12-byte
    records, ~20x slower)."""
    if isinstance(quantizer, PolarQuantizer):
        theta = 180.0 + np.arctan2(pc[:, 1], pc[:, 0]) * 180.0 / np.pi
        dist = np.sqrt(pc[:, 0] ** 2 + pc[:, 1] ** 2)
        scaled = np.stack([theta, dist, pc[:, 2]], axis=1) / quantizer.quant_step
    else:
        scaled = pc / quantizer.quant_step
    coords = np.floor(scaled).astype(np.int32)
    keys = _voxel_keys(coords)
    _, index = np.unique(keys, axis=0 if keys.ndim == 2 else None, return_index=True)
    index = np.sort(index)
    return coords[index], index


def _voxel_keys(coords: np.ndarray) -> np.ndarray:
    """(M,) int64 keys, equal exactly where the (M, 3) coords' rows are, or
    the coords themselves when there are none or their spans do not fit 63
    bits."""
    if len(coords) == 0:
        return coords
    lo = coords.min(axis=0).astype(np.int64)
    span = coords.max(axis=0).astype(np.int64) - lo + 1
    if int(span[0]) * int(span[1]) * int(span[2]) >= 2**63:
        return coords
    c = coords.astype(np.int64) - lo
    return (c[:, 0] * span[1] + c[:, 1]) * span[2] + c[:, 2]
