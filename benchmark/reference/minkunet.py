"""MinkUNet34C (MinkowskiEngine `examples/minkunet.py`; Choy, Gwak, Savarese,
CVPR 2019) segmenting scans, plain PyTorch in f32 (the caller turns TF32
off), with the module and parameter names of the port's
`egonn_tpu_torch/models/minkunet.py`, so that one state dict loads into
both.  It uses no kernel of the program: the building blocks of
`reference/models.py` (gather convs per offset, the all-slot transposed
conv, masked BatchNorm, BasicBlock without ECA) and the sorted searches of
`reference/sparse.py`, and records its work as `models.py` does (roles
`self`, `down`, `tconv`, `dense`).

    stem      conv0p1s1 (5^3, in -> 32), BN, ReLU: out_p1 on level 0
    encoder   i = 1..4: conv{i}p{2^(i-1)}s2 (k=2 s=2), BN, ReLU onto level
              i, block{i} (LAYERS[i-1] BasicBlocks to PLANES[i-1])
    decoder   i = 4..7: convtr{i}p{2^(8-i)}s2 (transposed k=2 s=2 onto the
              finer level's coordinates) to PLANES[i], BN, ReLU, cat(out,
              skip), block{i+1}
    head      final: 1x1 + bias to the classes; each point its voxel's logits

Departures from `examples/minkunet.py`, each the port's too:

* a voxel's input features are its first point's (the lowest input row),
  where MinkowskiEngine's `SparseTensor` keeps a point of its own choosing
  (or averages, by its quantization mode);
* coordinates pack into an int32 key of 11 / 11 / 8 bits (the
  configuration's `pack`): a point outside x, y in [-51.2, 51.2) m or z in
  [-6.4, 6.4) m at 5 cm has no voxel, zero logits and a False mask;
* every level has a fixed capacity (the configuration's table); voxels
  past it are dropped (the cell's `dropped_voxels` holds that to 0);
* BatchNorm in eval mode with running statistics, as the published
  network at inference.

The pyramid is `sparse.build_pyramid`'s, plus level 0's 3^3 map (block8's)
by its own sorted search; the point -> voxel inverse is a sorted search of
each point's key in level 0's keys.
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from benchmark.reference import sparse
from benchmark.reference.models import (
    BasicBlock,
    Linear,
    SparseBatchNorm,
    SparseConv,
    SparseConvTranspose2x2,
    down,
    gather_conv,
    masked,
    tconv2x2,
)
from benchmark.reference.sparse import Level


class MinkUNet34C(nn.Module):
    """Widths and depths from the configuration's `model`: `init_dim`,
    `planes` (8), `layers` (8), `in_channels`, `num_classes`."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        planes, layers, init_dim = tuple(m["planes"]), tuple(m["layers"]), m["init_dim"]
        self.conv0p1s1 = SparseConv(m["in_channels"], init_dim, 125)
        self.bn0 = SparseBatchNorm(init_dim)
        inplanes, skips = init_dim, [init_dim]
        for i in range(1, 5):
            setattr(self, f"conv{i}p{2 ** (i - 1)}s2", SparseConv(inplanes, inplanes, 8))
            setattr(self, f"bn{i}", SparseBatchNorm(inplanes))
            setattr(self, f"block{i}", nn.ModuleList(
                [BasicBlock(inplanes if j == 0 else planes[i - 1], planes[i - 1], False)
                 for j in range(layers[i - 1])]))
            inplanes = planes[i - 1]
            skips.append(inplanes)
        for i in range(4, 8):
            setattr(self, f"convtr{i}p{2 ** (8 - i)}s2",
                    SparseConvTranspose2x2(inplanes, planes[i]))
            setattr(self, f"bntr{i}", SparseBatchNorm(planes[i]))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                [BasicBlock(planes[i] + skips[7 - i] if j == 0 else planes[i], planes[i], False)
                 for j in range(layers[i])]))
            inplanes = planes[i]
        self.final = Linear(planes[7], m["num_classes"])

    def forward(self, pyr: List[Level], kmap3: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Per-voxel logits (B, C0, classes) of level 0; x the voxels' input
        features, kmap3 level 0's 3^3 map."""
        l0 = pyr[0]
        x = masked(torch.relu(self.bn0(gather_conv(x, l0.kmap_self, self.conv0p1s1.kernel,
                                                   "self"), l0.mask)), l0.mask)
        skips = [x]
        for i in range(1, 5):
            x = down(getattr(self, f"conv{i}p{2 ** (i - 1)}s2"), getattr(self, f"bn{i}"), x,
                     pyr[i])
            for block in getattr(self, f"block{i}"):
                x = block(x, pyr[i])
            skips.append(x)
        for i in range(4, 8):
            level = 7 - i
            lvl = pyr[level]
            x = tconv2x2(x, lvl, getattr(self, f"convtr{i}p{2 ** (8 - i)}s2").kernel)
            # ME.cat(out, skip): the transposed conv's features first
            x = torch.cat([torch.relu(getattr(self, f"bntr{i}")(x, lvl.mask)), skips[level]], -1)
            if level == 0:
                lvl = Level(lvl.coords, lvl.mask, kmap_self=kmap3)
            for block in getattr(self, f"block{i + 1}"):
                x = block(x, lvl)
        return self.final(x, l0.mask)


def pyramid(quantizer, spec: sparse.PyramidSpec, clouds: torch.Tensor, mask: torch.Tensor,
            feats: torch.Tensor) -> tuple:
    """(levels, level 0's 3^3 map, the voxels' input features, each point's
    voxel row or the sentinel C0)."""
    pack = spec.pack
    point_keys = sparse.pack_keys(quantizer.voxels(clouds), mask, pack)
    keys, rows, _, _ = sparse.dedup(point_keys, spec.capacities[0])
    levels = sparse.build_pyramid(keys, spec)
    l0 = levels[0]
    kmap3 = sparse.lookup(keys, sparse.neighbour_queries(l0.coords, l0.mask, 3, 1, pack))
    x = masked(torch.gather(feats, 1, rows[..., None].expand(-1, -1, feats.shape[-1])),
               l0.mask)
    return levels, kmap3, x, sparse.lookup(keys, point_keys)


def forward(model: MinkUNet34C, quantizer, spec: sparse.PyramidSpec, clouds: torch.Tensor,
            mask: torch.Tensor, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{`logits` (B, N, classes), `point_mask` (B, N)}: each point its
    voxel's logits, zero and False without a voxel."""
    levels, kmap3, x, inverse = pyramid(quantizer, spec, clouds, mask, feats)
    logits = model(levels, kmap3, x)
    valid = inverse < logits.shape[1]
    rows = torch.where(valid, inverse, 0).long()[..., None].expand(-1, -1, logits.shape[-1])
    return {"logits": torch.gather(logits, 1, rows) * valid[..., None], "point_mask": valid}
