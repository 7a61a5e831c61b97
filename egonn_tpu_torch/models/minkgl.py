"""MinkGL, the unified global + local EgoNN network (port of
`egonn_tpu/models/minkgl.py`); train or eval mode from `module.train()`.

* MinkTrunk: stem conv k=5 s=1 over constant-ones features -> per level i in
  1..L a k=2 s=2 down conv + BN + ReLU (`layers.down_conv`) and residual
  blocks; returns {level: feats} for levels >= min_out_level.
* MinkHead: 1x1 conv on the top input level, then per level downwards a
  transposed k=2 s=2 conv onto the trunk's coordinates plus a 1x1 lateral.
* MinkGL: global head -> DescriptorDecoder -> GeM = `global` (B, 256);
  local head -> L2-normalised `descriptors`, tanh keypoint offsets decoded
  by the quantizer into `keypoints`, softplus `sigma`, and `kp_mask`.
  Either head can be switched off per call (its keys are then absent);
  `ignore_keypoint_regressor` puts the keypoints at the supervoxel centres
  (the reference's ablation).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from egonn_tpu_torch.models.layers import (
    BasicBlock,
    DescriptorDecoder,
    MLPRegressor,
    PoolingWrapper,
    SparseConv,
    SparseConv1x1,
    SparseConvTranspose2x2,
    down_conv,
    l2_normalize,
)
from egonn_tpu_torch.sparse.norm import SparseBatchNorm
from egonn_tpu_torch.sparse.types import Pyramid, masked


class MinkTrunk(nn.Module):
    """Bottom-up trunk; planes[i-1] is the block output width at level i."""

    def __init__(self, in_channels: int, planes: Tuple[int, ...], layers: Tuple[int, ...],
                 gen: torch.Generator, conv0_kernel_size: int = 5,
                 block: str = "ECABasicBlock", min_out_level: int = 1):
        """The stem consumes constant-ones features (the pyramid's level-0 map
        records neighbour presence only)."""
        super().__init__()
        if block not in ("BasicBlock", "ECABasicBlock"):
            raise NotImplementedError(block)
        self.planes, self.layers = tuple(planes), tuple(layers)
        self.min_out_level = min_out_level
        inplanes = planes[0]
        self.conv0 = SparseConv(in_channels, inplanes, conv0_kernel_size ** 3, gen,
                                kaiming=True)
        self.bn0 = SparseBatchNorm(inplanes)
        for i, (plane, n_blocks) in enumerate(zip(planes, layers), start=1):
            setattr(self, f"conv{i}", SparseConv(inplanes, inplanes, 8, gen, kaiming=True))
            setattr(self, f"bn{i}", SparseBatchNorm(inplanes))
            for j in range(n_blocks):
                setattr(self, f"block{i}_{j}",
                        BasicBlock(inplanes if j == 0 else plane, plane, gen,
                                   use_eca=block == "ECABasicBlock"))
            inplanes = plane

    def forward(self, pyramid: Pyramid) -> Dict[int, torch.Tensor]:
        lvl0 = pyramid[0]
        x = self.conv0(None, lvl0.kmap_self)
        x = masked(torch.relu(self.bn0(x, lvl0.mask)), lvl0.mask)
        out: Dict[int, torch.Tensor] = {}
        for i, n_blocks in enumerate(self.layers, start=1):
            lvl = pyramid[i]
            x = down_conv(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), x, lvl,
                          pyramid[i - 1], self.training)
            for j in range(n_blocks):
                x = getattr(self, f"block{i}_{j}")(x, lvl)
            if i >= self.min_out_level:
                out[i] = x
        return out


class MinkHead(nn.Module):
    """Top-down FPN head over the shared pyramid."""

    def __init__(self, in_levels: Tuple[int, ...], in_channels: Tuple[int, ...],
                 out_channels: int, gen: torch.Generator):
        super().__init__()
        self.in_d = dict(zip(in_levels, in_channels))
        self.min_level, self.max_level = min(in_levels), max(in_levels)
        setattr(self, f"conv1x1_{self.max_level}",
                SparseConv1x1(self.in_d[self.max_level], out_channels, gen))
        for level in range(self.max_level - 1, self.min_level - 1, -1):
            setattr(self, f"tconv_{level + 1}",
                    SparseConvTranspose2x2(out_channels, out_channels, gen))
            if level in self.in_d:
                setattr(self, f"conv1x1_{level}",
                        SparseConv1x1(self.in_d[level], out_channels, gen))

    def forward(self, pyramid: Pyramid, trunk_out: Dict[int, torch.Tensor]) -> torch.Tensor:
        y = getattr(self, f"conv1x1_{self.max_level}")(trunk_out[self.max_level])
        for level in range(self.max_level - 1, self.min_level - 1, -1):
            y = getattr(self, f"tconv_{level + 1}")(y, pyramid[level], pyramid[level + 1])
            if level in self.in_d:
                y = y + getattr(self, f"conv1x1_{level}")(trunk_out[level])
        return masked(y, pyramid[self.min_level].mask)


class MinkGL(nn.Module):
    """Unified global + local descriptor network."""

    def __init__(self, trunk_planes: Tuple[int, ...], trunk_layers: Tuple[int, ...],
                 gen: torch.Generator, conv0_kernel_size: int = 5,
                 block: str = "ECABasicBlock", in_channels: int = 1,
                 global_in_levels: Tuple[int, ...] = (5, 6, 7),
                 global_map_channels: int = 128, global_descriptor_size: int = 256,
                 global_pool_method: str = "GeM", global_normalize: bool = False,
                 local_in_levels: Tuple[int, ...] = (3, 4), local_map_channels: int = 64,
                 local_descriptor_size: int = 128, local_normalize: bool = True,
                 ignore_keypoint_regressor: bool = False):
        super().__init__()
        self.ignore_keypoint_regressor = ignore_keypoint_regressor
        self.global_in_levels = tuple(global_in_levels)
        self.local_in_levels = tuple(local_in_levels)
        self.global_normalize = global_normalize
        min_out = min([len(trunk_planes), *self.global_in_levels, *self.local_in_levels])
        self.trunk = MinkTrunk(in_channels, trunk_planes, trunk_layers, gen,
                               conv0_kernel_size=conv0_kernel_size, block=block,
                               min_out_level=min_out)
        if self.global_in_levels:
            g_ch = tuple(trunk_planes[i - 1] for i in self.global_in_levels)
            self.global_head = MinkHead(self.global_in_levels, g_ch, global_map_channels, gen)
            self.global_descriptor_decoder = DescriptorDecoder(
                global_map_channels, global_descriptor_size, gen, normalize=False)
            self.global_pooling = PoolingWrapper(global_pool_method, global_descriptor_size,
                                                 global_descriptor_size, gen)
        if self.local_in_levels:
            l_ch = tuple(trunk_planes[i - 1] for i in self.local_in_levels)
            self.local_head = MinkHead(self.local_in_levels, l_ch, local_map_channels, gen)
            self.local_descriptor_decoder = DescriptorDecoder(
                local_map_channels, local_descriptor_size, gen, normalize=local_normalize)
            self.local_keypoint_regressor = MLPRegressor(local_map_channels, 3, "tanh", gen)
            self.local_sigma_regressor = MLPRegressor(local_map_channels, 1, "softplus", gen)

    def forward(self, pyramid: Pyramid, quantizer, disable_global_head: bool = False,
                disable_local_head: bool = False) -> Dict[str, torch.Tensor]:
        trunk_out = self.trunk(pyramid)
        y: Dict[str, torch.Tensor] = {}
        if self.global_in_levels and not disable_global_head:
            xg = self.global_descriptor_decoder(self.global_head(pyramid, trunk_out))
            if self.global_normalize:
                xg = l2_normalize(xg)
            g_mask = pyramid[min(self.global_in_levels)].mask
            y["global"] = self.global_pooling(masked(xg, g_mask), g_mask)
        if self.local_in_levels and not disable_local_head:
            xl = self.local_head(pyramid, trunk_out)
            l_level = min(self.local_in_levels)
            lvl = pyramid[l_level]
            y["descriptors"] = masked(self.local_descriptor_decoder(xl), lvl.mask)
            kp_offset = self.local_keypoint_regressor(xl)
            if self.ignore_keypoint_regressor:
                kp_offset = torch.zeros_like(kp_offset)
            # absolute level-0 voxel units (multiples of the stride), as ME's .C
            stride = 2 ** l_level
            kp_pos = quantizer.keypoint_position(
                lvl.coords_rows * stride,
                torch.full((3,), float(stride), device=kp_offset.device), kp_offset)
            y["keypoints"] = masked(kp_pos, lvl.mask)
            y["kp_mask"] = lvl.mask
            y["sigma"] = masked(self.local_sigma_regressor(xl), lvl.mask)
        return y
