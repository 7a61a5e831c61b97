"""Generic sparse ResNet (port of `egonn_tpu/models/resnet.py`): a stem conv,
then per stage a k=2 s=2 down conv + BN + ReLU and residual blocks, with the
ResNet14 ... ResNet101 table.

The pyramid needs self maps at levels 1..len(layers) and, for the stem over
real features, `conv0_ones=False`.  Its specs record no up maps, so every
down conv runs over the lookup-built `kmap_down` (one lookup launch builds
them all).  Every width runs on the card: the kernel wrappers pad and split
widths the kernels do not take (`sparse/kernels.py::width_plan`), such as
the stem's `in_channels` 1-3 or ResNet50's 1024-wide stage-4 down conv.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from egonn_tpu_torch.models.layers import BasicBlock, SparseConv, SparseConv1x1, down_conv
from egonn_tpu_torch.sparse import conv as sconv
from egonn_tpu_torch.sparse.norm import SparseBatchNorm
from egonn_tpu_torch.sparse.types import Level, Pyramid, masked


class Bottleneck(nn.Module):
    """1x1 -> 3^3 -> 1x1 residual block, expansion 4 (ME Bottleneck); the
    3^3 conv fuses BN + ReLU in eval mode (unless `sconv.FUSE_BN_EVAL` is
    off)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, gen: torch.Generator):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = SparseConv1x1(inplanes, planes, gen)
        self.norm1 = SparseBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, 27, gen)
        self.norm2 = SparseBatchNorm(planes)
        self.conv3 = SparseConv1x1(planes, out_ch, gen)
        self.norm3 = SparseBatchNorm(out_ch)
        if inplanes != out_ch:
            self.downsample_conv = SparseConv1x1(inplanes, out_ch, gen)
            self.downsample_norm = SparseBatchNorm(out_ch)
        else:
            self.downsample_conv = self.downsample_norm = None

    def attend(self, out: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Channel attention after the third conv: none here (SE in
        `senet.SEBottleneck`)."""
        return out

    def forward(self, feats: torch.Tensor, level: Level) -> torch.Tensor:
        out = torch.relu(self.norm1(self.conv1(feats), level.mask))
        if self.training or not sconv.FUSE_BN_EVAL:
            out = torch.relu(self.norm2(self.conv2(out, level.kmap_self), level.mask))
        else:
            s, b = self.norm2.affine()
            out = self.conv2(out, level.kmap_self, epi=(s, b, True, level.mask))
        out = self.attend(self.norm3(self.conv3(out), level.mask), level.mask)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(feats), level.mask)
        else:
            residual = feats
        return masked(torch.relu(out + residual), level.mask)


class ResNetBase(nn.Module):
    """Stem + stages over pyramid levels 1..len(layers); returns
    {level: feats}.  block: 'BasicBlock', 'Bottleneck' or 'SEBottleneck'."""

    def __init__(self, in_channels: int, gen: torch.Generator,
                 planes: Sequence[int] = (64, 128, 256, 512),
                 layers: Sequence[int] = (1, 1, 1, 1), block: str = "BasicBlock",
                 conv0_kernel_size: int = 5, init_dim: int = 64):
        super().__init__()
        from egonn_tpu_torch.models.senet import SEBottleneck

        blocks = {"BasicBlock": (BasicBlock, 1), "Bottleneck": (Bottleneck, 4),
                  "SEBottleneck": (SEBottleneck, 4)}
        if block not in blocks:
            raise NotImplementedError(f"Unknown block: {block}")
        block_cls, expansion = blocks[block]
        self.layers = tuple(layers)
        self.conv0 = SparseConv(in_channels, init_dim, conv0_kernel_size ** 3, gen)
        self.bn0 = SparseBatchNorm(init_dim)
        inplanes = init_dim
        for i, (plane, n_blocks) in enumerate(zip(planes, layers), start=1):
            setattr(self, f"conv{i}", SparseConv(inplanes, inplanes, 8, gen))
            setattr(self, f"bn{i}", SparseBatchNorm(inplanes))
            for j in range(n_blocks):
                setattr(self, f"block{i}_{j}",
                        block_cls(inplanes if j == 0 else plane * expansion, plane, gen))
            inplanes = plane * expansion

    def forward(self, pyramid: Pyramid, feats0: torch.Tensor) -> Dict[int, torch.Tensor]:
        lvl0 = pyramid[0]
        x = self.conv0(feats0, lvl0.kmap_self)
        x = masked(torch.relu(self.bn0(x, lvl0.mask)), lvl0.mask)
        out: Dict[int, torch.Tensor] = {}
        for i, n_blocks in enumerate(self.layers, start=1):
            lvl = pyramid[i]
            x = down_conv(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), x, lvl,
                          pyramid[i - 1], self.training)
            for j in range(n_blocks):
                x = getattr(self, f"block{i}_{j}")(x, lvl)
            out[i] = x
        return out


def ResNet14(in_channels: int, gen: torch.Generator) -> ResNetBase:  # noqa: N802
    return ResNetBase(in_channels, gen, block="BasicBlock", layers=(1, 1, 1, 1))


def ResNet18(in_channels: int, gen: torch.Generator) -> ResNetBase:  # noqa: N802
    return ResNetBase(in_channels, gen, block="BasicBlock", layers=(2, 2, 2, 2))


def ResNet34(in_channels: int, gen: torch.Generator) -> ResNetBase:  # noqa: N802
    return ResNetBase(in_channels, gen, block="BasicBlock", layers=(3, 4, 6, 3))


def ResNet50(in_channels: int, gen: torch.Generator) -> ResNetBase:  # noqa: N802
    return ResNetBase(in_channels, gen, block="Bottleneck", layers=(3, 4, 6, 3))


def ResNet101(in_channels: int, gen: torch.Generator) -> ResNetBase:  # noqa: N802
    return ResNetBase(in_channels, gen, block="Bottleneck", layers=(3, 4, 23, 3))
