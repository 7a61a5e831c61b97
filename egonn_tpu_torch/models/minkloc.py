"""MinkLoc, the global-descriptor network, and its MinkFPN backbone (port of
`egonn_tpu/models/minkloc.py`); train or eval mode from `module.train()`.

MinkFPN: stem conv (k = conv0_kernel_size, s=1) -> per level 1..nb a k=2 s=2
down conv + BN + ReLU (`layers.down_conv`) and residual blocks -> 1x1 conv to
`out_channels` on the top level -> num_top_down steps of a transposed k=2
s=2 conv onto the next finer level plus a 1x1 lateral of that level's
features (level 0, the stem's output, when num_top_down == nb).  MinkLoc
pools the result into `global`.

Module and tensor names are the flax names (`backbone.conv0`,
`backbone.block1_0`, `backbone.tconv0`, `backbone.conv1x1_1`, `pooling.gem`,
...), so `utils/weights.py::load_flax_variables` fills them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from egonn_tpu_torch.models.layers import (
    BasicBlock,
    PoolingWrapper,
    SparseConv,
    SparseConv1x1,
    SparseConvTranspose2x2,
    down_conv,
)
from egonn_tpu_torch.models.senet import SEBasicBlock
from egonn_tpu_torch.sparse.norm import SparseBatchNorm
from egonn_tpu_torch.sparse.types import Pyramid, masked
from egonn_tpu_torch.utils.tracing import span


class MinkFPN(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, gen: torch.Generator,
                 num_top_down: int = 1, conv0_kernel_size: int = 5, block: str = "BasicBlock",
                 layers: Sequence[int] = (1, 1, 1), planes: Sequence[int] = (32, 64, 64)):
        super().__init__()
        nb = len(layers)
        if not 0 <= num_top_down <= nb:
            raise ValueError(f"num_top_down={num_top_down} outside [0, {nb}]")
        if block not in ("BasicBlock", "ECABasicBlock", "SEBasicBlock"):
            raise NotImplementedError(f"Unknown block: {block}")
        self.layers, self.num_top_down = tuple(layers), num_top_down
        inplanes = planes[0]
        self.conv0 = SparseConv(in_channels, inplanes, conv0_kernel_size ** 3, gen)
        self.bn0 = SparseBatchNorm(inplanes)
        widths = [inplanes]  # feature width at each level
        for level, (plane, n_blocks) in enumerate(zip(planes, layers), start=1):
            setattr(self, f"conv{level}", SparseConv(inplanes, inplanes, 8, gen))
            setattr(self, f"bn{level}", SparseBatchNorm(inplanes))
            for j in range(n_blocks):
                cin = inplanes if j == 0 else plane
                setattr(self, f"block{level}_{j}",
                        SEBasicBlock(cin, plane, gen) if block == "SEBasicBlock" else
                        BasicBlock(cin, plane, gen, use_eca=block == "ECABasicBlock",
                                   kaiming=False))
            inplanes = plane
            widths.append(plane)
        self.conv1x1_0 = SparseConv1x1(planes[-1], out_channels, gen)
        for ndx in range(num_top_down):
            setattr(self, f"tconv{ndx}", SparseConvTranspose2x2(out_channels, out_channels, gen))
            setattr(self, f"conv1x1_{ndx + 1}",
                    SparseConv1x1(widths[nb - 1 - ndx], out_channels, gen))

    def forward(self, pyramid: Pyramid, feats0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, int]:
        """feats0 None: the stem over constant-ones features (conv0_ones
        pyramid).  Returns (features, the level they lie on)."""
        nb, ntd = len(self.layers), self.num_top_down
        lvl0 = pyramid[0]
        x = self.conv0(feats0, lvl0.kmap_self)
        x = masked(torch.relu(self.bn0(x, lvl0.mask)), lvl0.mask)
        laterals: Dict[int, torch.Tensor] = {0: x} if ntd == nb else {}
        for level, n_blocks in enumerate(self.layers, start=1):
            lvl = pyramid[level]
            x = down_conv(getattr(self, f"conv{level}"), getattr(self, f"bn{level}"), x, lvl,
                          pyramid[level - 1], self.training)
            for j in range(n_blocks):
                x = getattr(self, f"block{level}_{j}")(x, lvl)
            if nb - ntd <= level < nb:
                laterals[level] = x
        x = self.conv1x1_0(x)
        level = nb
        for ndx in range(ntd):
            level -= 1
            x = getattr(self, f"tconv{ndx}")(x, pyramid[level], pyramid[level + 1])
            x = x + getattr(self, f"conv1x1_{ndx + 1}")(laterals[level])
        return masked(x, pyramid[level].mask), level


class MinkLoc(nn.Module):
    def __init__(self, in_channels: int, feature_size: int, output_dim: int,
                 planes: Sequence[int], layers: Sequence[int], num_top_down: int,
                 conv0_kernel_size: int, gen: torch.Generator, block: str = "BasicBlock",
                 pooling_method: str = "GeM"):
        super().__init__()
        self.backbone = MinkFPN(in_channels, feature_size, gen, num_top_down=num_top_down,
                                conv0_kernel_size=conv0_kernel_size, block=block,
                                layers=layers, planes=planes)
        self.pooling = PoolingWrapper(pooling_method, feature_size, output_dim, gen)

    def forward(self, pyramid: Pyramid, quantizer=None,
                feats0: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """`quantizer` is unused (the entry point passes it to every model).
        Returns {"global": (B, output_dim)}."""
        with span("egonn.trunk"):
            x, level = self.backbone(pyramid, feats0)
        with span("egonn.global_head"):
            return {"global": self.pooling(x, pyramid[level].mask)}
