"""MinkUNet, the sparse U-Net segmentation backbone of MinkowskiEngine's
`examples/minkunet.py` (Choy, Gwak, Savarese, "4D Spatio-Temporal ConvNets",
CVPR 2019), for inference: per-point class logits of a batch of scans.

`MinkUNetBase` on a pyramid of five levels (tensor strides 1-16):

* stem `conv0p1s1`: a 5^3 conv over the voxels' input features (each
  voxel's first point's, `Level.kmap_self` of level 0) to INIT_DIM, BN, ReLU;
* encoder stages i = 1..4: a k=2 s=2 down conv onto level i (`conv{i}p{2^(i-1)}s2`,
  inplanes -> inplanes), BN, ReLU, then LAYERS[i-1] BasicBlocks to PLANES[i-1];
* decoder stages i = 4..7: a transposed k=2 s=2 conv onto the finer level's
  own coordinates (`convtr{i}p{2^(8-i)}s2`) to PLANES[i], BN, ReLU, the
  concatenation with the encoder's output on that level (the transposed
  conv's features first, `skip_concat`), then LAYERS[i] BasicBlocks (the
  first with a 1x1 + BN downsample, its input being wider); the last stage's
  blocks run at level 0 over the 3^3 map `Level.kmap_block`;
* `final`: a 1x1 conv with bias to the class count, then each point takes
  its voxel's logits (`devoxelize`, over the quantizer's inverse).

BasicBlock is `layers.BasicBlock` without ECA (conv3, BN, ReLU, conv3, BN,
+ residual, ReLU).  Every conv but the transposed ones starts kaiming
fan_out, as the published `weight_initialization`; `final`'s bias as
torch's Linear.
Module names are the published ones (`block5.0.conv1.kernel`, ...), and the
benchmark's plain reference (`benchmark/reference/minkunet.py`) has the
same, so one state dict loads into both.

Spans: `egonn.trunk` (the voxels' features, the stem, the encoder),
`egonn.decoder` (the four transposed convs with their BN, the
concatenations, blocks 5-8), `egonn.devoxelize` (`final` and the per-point
gather).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from egonn_tpu_torch.models.layers import (
    BasicBlock,
    Linear,
    SparseConv,
    SparseConvTranspose2x2,
    down_conv,
    kaiming_me,
)
from egonn_tpu_torch.sparse import conv as sconv
from egonn_tpu_torch.sparse.norm import SparseBatchNorm
from egonn_tpu_torch.sparse.packing import Voxelized
from egonn_tpu_torch.sparse.types import Pyramid, masked
from egonn_tpu_torch.utils.tracing import span


def voxel_features(feats: torch.Tensor, index: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
    """(B, C, F): each voxel's first point's features (`index`, the
    quantizer's source rows), zero on padding rows."""
    rows = index.long()[..., None].expand(-1, -1, feats.shape[-1])
    return masked(torch.gather(feats, 1, rows), mask)


def skip_concat(up: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """`ME.cat(out, skip)`: the transposed conv's features, then the
    encoder's."""
    return torch.cat([up, skip], dim=-1)


def devoxelize(logits: torch.Tensor, inverse: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point logits (B, N, F) and the mask of points with a voxel (B, N):
    each point takes its voxel's row (`inverse`, the sentinel C for none);
    a point without one gets zeros."""
    valid = inverse < logits.shape[1]
    rows = torch.where(valid, inverse, 0).long()[..., None].expand(-1, -1, logits.shape[-1])
    return torch.gather(logits, 1, rows) * valid[..., None], valid


class MinkUNetBase(nn.Module):
    INIT_DIM = 32
    PLANES: Tuple[int, ...] = ()
    LAYERS: Tuple[int, ...] = ()

    def __init__(self, in_channels: int, out_channels: int, gen: torch.Generator):
        """The widths and depths are the class's: INIT_DIM, PLANES (8),
        LAYERS (8)."""
        super().__init__()
        planes, layers, init_dim = self.PLANES, self.LAYERS, self.INIT_DIM
        if len(planes) != 8 or len(layers) != 8:
            raise ValueError("MinkUNet takes 8 planes and 8 layer counts")
        self.conv0p1s1 = SparseConv(in_channels, init_dim, 125, gen, kaiming=True)
        self.bn0 = SparseBatchNorm(init_dim)
        inplanes = init_dim
        skips = [init_dim]  # the encoder's width on levels 0..3
        for i in range(1, 5):
            setattr(self, f"conv{i}p{2 ** (i - 1)}s2",
                    SparseConv(inplanes, inplanes, 8, gen, kaiming=True))
            setattr(self, f"bn{i}", SparseBatchNorm(inplanes))
            setattr(self, f"block{i}", self._blocks(inplanes, planes[i - 1], layers[i - 1], gen))
            inplanes = planes[i - 1]
            skips.append(inplanes)
        for i in range(4, 8):
            setattr(self, f"convtr{i}p{2 ** (8 - i)}s2",
                    SparseConvTranspose2x2(inplanes, planes[i], gen))
            setattr(self, f"bntr{i}", SparseBatchNorm(planes[i]))
            setattr(self, f"block{i + 1}",
                    self._blocks(planes[i] + skips[7 - i], planes[i], layers[i], gen))
            inplanes = planes[i]
        self.final = Linear(planes[7], out_channels, gen)
        self.final.weight = kaiming_me((planes[7], out_channels), 1, out_channels, gen)

    @staticmethod
    def _blocks(inplanes: int, planes: int, n: int, gen: torch.Generator) -> nn.ModuleList:
        return nn.ModuleList([BasicBlock(inplanes if j == 0 else planes, planes, gen)
                              for j in range(n)])

    def forward(self, pyramid: Pyramid, voxels: Voxelized, feats: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """`voxels` the quantizer's result for the pyramid's level 0 (its
        source rows and inverse), feats (B, N, in_channels) per point.
        Returns `logits` (B, N, out_channels) and `point_mask` (B, N)."""
        l0 = pyramid[0]
        with span("egonn.trunk"):
            x = voxel_features(feats, voxels.index, l0.mask)
            if self.training or not sconv.FUSE_BN_EVAL:
                x = torch.relu(self.bn0(self.conv0p1s1(x, l0.kmap_self), l0.mask))
            else:
                s, b = self.bn0.affine()
                x = self.conv0p1s1(x, l0.kmap_self, epi=(s, b, True, l0.mask))
            skips = [x]
            for i in range(1, 5):
                x = down_conv(getattr(self, f"conv{i}p{2 ** (i - 1)}s2"),
                              getattr(self, f"bn{i}"), x, pyramid[i], pyramid[i - 1],
                              self.training)
                for block in getattr(self, f"block{i}"):
                    x = block(x, pyramid[i])
                skips.append(x)
        with span("egonn.decoder"):
            for i in range(4, 8):
                level = 7 - i
                lvl = pyramid[level]
                x = getattr(self, f"convtr{i}p{2 ** (8 - i)}s2")(x, lvl, pyramid[level + 1])
                x = skip_concat(torch.relu(getattr(self, f"bntr{i}")(x, lvl.mask)),
                                skips[level])
                if level == 0:
                    lvl = dataclasses.replace(lvl, kmap_self=lvl.kmap_block)
                for block in getattr(self, f"block{i + 1}"):
                    x = block(x, lvl)
        with span("egonn.devoxelize"):
            logits, point_mask = devoxelize(self.final(x), voxels.inverse)
        return {"logits": logits, "point_mask": point_mask}


class MinkUNet34C(MinkUNetBase):
    """MinkUNet34C of `examples/minkunet.py`: BasicBlock, layers
    (2, 3, 4, 6, 2, 2, 2, 2), planes (32, 64, 128, 256, 256, 128, 96, 96)."""

    PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
