"""Voxelization and the coordinate pyramid, plain PyTorch.

Coordinates pack into one int32 key, `(x+ox) << (by+bz) | (y+oy) << bz |
(z+oz)`; MAXKEY marks padding and sorts last.  Dedup keeps the first point
of each voxel and compacts the sorted keys to the front.  Level l of the
pyramid holds the voxels of level l-1 halved and deduplicated; each level
carries its k^3 self map (`kmap_self`, (B, K, C): source row or the sentinel
C), its up map to level l+1 (`up_parent`, `up_koffset`) and the k=2 s=2 down
map from level l-1 (`kmap_down`, (B, 8, C)).  Kernel offsets run in C order
over (dx, dy, dz), dz fastest.  Every map is found by a sorted search
(`torch.searchsorted`), with no band window and no z-run trick.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

MAXKEY = 2**31 - 1


@dataclass(frozen=True)
class PackSpec:
    bits: Tuple[int, int, int] = (10, 10, 11)
    offsets: Tuple[int, int, int] = (512, 512, 1024)

    def halved(self) -> "PackSpec":
        return PackSpec(self.bits, tuple(o // 2 for o in self.offsets))


def offset_range(k: int) -> range:
    return range(-(k // 2), k // 2 + 1) if k % 2 else range(0, k)


def kernel_offsets(k: int) -> torch.Tensor:
    return torch.tensor(list(itertools.product(offset_range(k), repeat=3)), dtype=torch.int32)


def pack_keys(coords_t: torch.Tensor, mask: torch.Tensor, spec: PackSpec) -> torch.Tensor:
    """(B, 3, N) coords + (B, N) mask -> (B, N) int32 keys, MAXKEY where
    masked or out of range."""
    bx, by, bz = spec.bits
    x, y, z = (c + o for c, o in zip(coords_t.unbind(-2), spec.offsets))
    ok = (x >= 0) & (x < (1 << bx)) & (y >= 0) & (y < (1 << by)) & (z >= 0) & (z < (1 << bz))
    return torch.where(mask & ok, (x << (by + bz)) | (y << bz) | z, MAXKEY).to(torch.int32)


def unpack_keys(keys: torch.Tensor, spec: PackSpec) -> torch.Tensor:
    bx, by, bz = spec.bits
    ox, oy, oz = spec.offsets
    z = (keys & ((1 << bz) - 1)) - oz
    y = ((keys >> bz) & ((1 << by) - 1)) - oy
    x = ((keys >> (by + bz)) & ((1 << bx) - 1)) - ox
    return torch.stack([x, y, z], dim=-2)


def dedup(keys: torch.Tensor, capacity: int):
    """Sorted unique keys of each row, the lowest `capacity` kept.  Returns
    (keys (B, capacity) MAXKEY padded, first source row of each kept key
    (B, capacity), unique count (B,) before the cut, and for every input
    entry the position of its key among the kept ones, or `capacity`)."""
    sk, rows = torch.sort(keys, dim=-1, stable=True)
    prev = torch.cat([torch.full_like(sk[:, :1], -1), sk[:, :-1]], dim=1)
    first = (sk != prev) & (sk != MAXKEY)
    rank = torch.cumsum(first, dim=1) - 1
    dest = torch.where(first & (rank < capacity), rank, capacity)
    b = keys.shape[0]
    out = torch.full((b, capacity + 1), MAXKEY, dtype=torch.int32, device=keys.device)
    out.scatter_(1, dest, sk.to(torch.int32))
    src = torch.zeros((b, capacity + 1), dtype=torch.int64, device=keys.device)
    src.scatter_(1, dest, rows)
    kept = (sk != MAXKEY) & (rank < capacity)
    pos_sorted = torch.where(kept, rank, capacity)
    pos = torch.empty_like(pos_sorted)
    pos.scatter_(1, rows, pos_sorted)
    return out[:, :capacity], src[:, :capacity], first.sum(1), pos


def lookup(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Position of each query key in its row's sorted table, or the
    sentinel table.shape[1].  table (B, C), queries (B, ...)."""
    c = table.shape[1]
    q = queries.reshape(table.shape[0], -1).contiguous()
    pos = torch.searchsorted(table.contiguous(), q)
    hit = (torch.gather(table, 1, pos.clamp(max=c - 1)) == q) & (pos < c) & (q != MAXKEY)
    return torch.where(hit, pos, c).reshape(queries.shape).to(torch.int32)


def neighbour_queries(coords_t: torch.Tensor, mask: torch.Tensor, k: int, scale: int,
                      spec: PackSpec) -> torch.Tensor:
    """(B, k^3, C) keys of scale * coord + d for every offset d; MAXKEY where
    the voxel is padding or the neighbour falls outside the key space."""
    offs = kernel_offsets(k).to(coords_t.device)           # (K, 3)
    c = scale * coords_t[:, None, :, :] + offs[None, :, :, None]   # (B, K, 3, C)
    return pack_keys(c, mask[:, None, :].expand(-1, offs.shape[0], -1), spec)


@dataclass
class Level:
    coords: torch.Tensor            # (B, 3, C) int32
    mask: torch.Tensor              # (B, C) bool
    kmap_self: Optional[torch.Tensor] = None
    kmap_down: Optional[torch.Tensor] = None
    up_parent: Optional[torch.Tensor] = None
    up_koffset: Optional[torch.Tensor] = None

    @property
    def coords_rows(self) -> torch.Tensor:
        return self.coords.transpose(1, 2)


@dataclass(frozen=True)
class PyramidSpec:
    capacities: Tuple[int, ...]
    conv0_kernel_size: int = 5
    block_kernel_size: int = 3
    pack: PackSpec = PackSpec()

    @property
    def num_levels(self) -> int:
        return len(self.capacities) - 1


def egonn_spec(cap0: int, decay: Tuple[float, ...], num_levels: int) -> PyramidSpec:
    """Capacities cap0 * decay[l], rounded up to a multiple of 128, floor 256."""
    caps = tuple(max(256, math.ceil(cap0 * decay[min(l, len(decay) - 1)] / 128) * 128)
                 for l in range(num_levels + 1))
    return PyramidSpec(caps)


def minkloc_spec(cap0: int, num_levels: int, conv0_kernel_size: int) -> PyramidSpec:
    """Capacities max(256, cap0 >> min(l, 4))."""
    return PyramidSpec(tuple(max(256, cap0 >> min(l, 4)) for l in range(num_levels + 1)),
                       conv0_kernel_size=conv0_kernel_size)


def build_pyramid(keys0: torch.Tensor, spec: PyramidSpec) -> List[Level]:
    """Every level's voxels and maps from level 0's sorted unique keys."""
    keys, packs = [keys0], [spec.pack]
    up = []
    for l in range(1, spec.num_levels + 1):
        fine, fp = keys[-1], packs[-1]
        half = torch.where(fine == MAXKEY, MAXKEY,
                           pack_keys(torch.div(unpack_keys(fine, fp), 2, rounding_mode="floor"),
                                     fine != MAXKEY, fp.halved()))
        coarse, _, _, parent = dedup(half, spec.capacities[l])
        keys.append(coarse)
        packs.append(fp.halved())
        up.append(parent.to(torch.int32))
    levels = []
    for l, (k, p) in enumerate(zip(keys, packs)):
        mask = k != MAXKEY
        coords = torch.where(mask[:, None, :], unpack_keys(k, p), 0).to(torch.int32)
        ks = spec.conv0_kernel_size if l == 0 else spec.block_kernel_size
        lvl = Level(coords, mask, kmap_self=lookup(k, neighbour_queries(coords, mask, ks, 1, p)))
        if l < spec.num_levels:
            bits = coords - 2 * torch.div(coords, 2, rounding_mode="floor")
            lvl.up_koffset = (4 * bits[:, 0] + 2 * bits[:, 1] + bits[:, 2]).to(torch.int32)
            lvl.up_parent = up[l]
        if l >= 1:
            # children 2 * coord + d, d in {0, 1}^3, looked up in the finer level
            lvl.kmap_down = lookup(keys[l - 1],
                                   neighbour_queries(coords, mask, 2, 2, packs[l - 1]))
        levels.append(lvl)
    return levels


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def polar_to_cartesian(p: torch.Tensor) -> torch.Tensor:
    theta = math.pi * (p[..., 0] - 180.0) / 180.0
    return torch.stack([torch.cos(theta) * p[..., 1], torch.sin(theta) * p[..., 1], p[..., 2]],
                       dim=-1)


class PolarQuantizer:
    """theta = 180 + atan2(y, x) in degrees, r = |xy|, z; voxel = floor(/ step)."""

    def __init__(self, steps):
        self.steps = [float(s) for s in steps]

    def voxels(self, pc: torch.Tensor) -> torch.Tensor:
        s0, s1, s2 = self.steps
        theta = 180.0 + torch.atan2(pc[..., 1], pc[..., 0]) * (180.0 / math.pi)
        dist = torch.sqrt(pc[..., 0] ** 2 + pc[..., 1] ** 2)
        return torch.stack([torch.floor(theta / s0), torch.floor(dist / s1),
                            torch.floor(pc[..., 2] / s2)], dim=-2).to(torch.int32)

    def keypoint_position(self, coords: torch.Tensor, stride: int, offset: torch.Tensor):
        step = torch.tensor(self.steps, dtype=torch.float32, device=coords.device)
        centres = (coords.to(torch.float32) + 0.5) * step
        return polar_to_cartesian(centres + offset * (float(stride) * step) / 2.0)


class CartesianQuantizer:
    def __init__(self, step):
        self.step = float(step)

    def voxels(self, pc: torch.Tensor) -> torch.Tensor:
        return torch.floor(pc.transpose(-1, -2) / self.step).to(torch.int32)


def quantize(quantizer, clouds: torch.Tensor, mask: torch.Tensor, capacity: int,
             pack: PackSpec = PackSpec()):
    """(B, N, 3) clouds -> (sorted unique keys (B, capacity), first source
    row of each voxel (B, capacity), unique count (B,))."""
    keys, rows, n_unique, _ = dedup(pack_keys(quantizer.voxels(clouds), mask, pack), capacity)
    return keys, rows, n_unique
