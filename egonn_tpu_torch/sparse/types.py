"""Batched fixed-capacity sparse voxel containers (port of
`egonn_tpu/sparse/types.py`).

Voxels are stored per cloud as padded, masked buffers: coords `(B, 3, C)`
int32 in level units, mask `(B, C)` bool, features `(B, C, F)`.  Index maps
use the convention: a value in [0, C_src) is a source row, C_src (the
sentinel) gathers a zero row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional, Tuple

import torch

if TYPE_CHECKING:
    from egonn_tpu_torch.sparse.kernels import SlotOrder


@dataclass
class Level:
    """One pyramid level: voxel coordinates plus the gather maps for its convs."""

    coords: torch.Tensor                        # (B, 3, C) int32, level units
    mask: torch.Tensor                          # (B, C) bool
    n_unique: torch.Tensor                      # (B,) int32 pre-truncation count
    kmap_self: Optional[torch.Tensor] = None    # (B, K, C) gather into THIS level
    kmap_down: Optional[torch.Tensor] = None    # (B, 8, C) gather into level l-1
    up_parent: Optional[torch.Tensor] = None    # (B, C) gather into level l+1
    up_koffset: Optional[torch.Tensor] = None   # (B, C) int32 in [0, 8) kernel slot
    source_index: Optional[torch.Tensor] = None  # (B, C) level 0 only: input row
    # level 0 only, where the spec asks for it: the blocks' self map beside
    # the stem's (B, k_block^3, C)
    kmap_block: Optional[torch.Tensor] = None
    # the up map's slot order, built at first use (sparse/conv.py::level_slots)
    up_slots: Optional[SlotOrder] = None

    @property
    def capacity(self) -> int:
        return self.coords.shape[2]

    @property
    def coords_rows(self) -> torch.Tensor:
        """(B, C, 3) row-layout coordinates."""
        return self.coords.transpose(1, 2)


@dataclass
class Pyramid:
    """Coordinate pyramid for one batch: levels[l] has tensor stride 2^l."""

    levels: Tuple[Level, ...]

    def __getitem__(self, i: int) -> Level:
        return self.levels[i]


def masked(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero out padding rows: feats (B, C, F), mask (B, C)."""
    return feats * mask[..., None].to(feats.dtype)
