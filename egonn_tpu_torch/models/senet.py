"""Squeeze-excitation blocks (port of `egonn_tpu/models/senet.py`), masked.

SELayer: masked global average pool -> Linear(C, C / r) -> ReLU ->
Linear(C / r, C) -> sigmoid -> per-cloud channel scale.  SEBasicBlock is the
BasicBlock with SE after its second conv (a MinkFPN block); SEBottleneck the
Bottleneck with SE after its third conv (a ResNetBase block).  In eval mode
their 3^3 convs take the fused BN (+ReLU) epilogues as the blocks they
extend do.
"""
from __future__ import annotations

import torch
from torch import nn

from egonn_tpu_torch.models.layers import BasicBlock, Linear
from egonn_tpu_torch.models.resnet import Bottleneck
from egonn_tpu_torch.sparse.norm import broadcast_mul, global_avg_pool


class SELayer(nn.Module):
    def __init__(self, channels: int, gen: torch.Generator, reduction: int = 16):
        super().__init__()
        self.fc1 = Linear(channels, channels // reduction, gen)
        self.fc2 = Linear(channels // reduction, channels, gen)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.fc1(global_avg_pool(feats, mask)))
        return broadcast_mul(feats, torch.sigmoid(self.fc2(y)))


class SEBasicBlock(BasicBlock):
    def __init__(self, inplanes: int, planes: int, gen: torch.Generator):
        super().__init__(inplanes, planes, gen, kaiming=False)
        self.se = SELayer(planes, gen)

    def attend(self, out: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.se(out, mask)


class SEBottleneck(Bottleneck):
    def __init__(self, inplanes: int, planes: int, gen: torch.Generator):
        super().__init__(inplanes, planes, gen)
        self.se = SELayer(planes * self.expansion, gen)

    def attend(self, out: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.se(out, mask)
