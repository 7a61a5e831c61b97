"""Coordinate pyramid construction (port of `egonn_tpu/sparse/pyramid.py`).

For each level l (tensor stride 2^l) `build_pyramid` computes:

* the voxel set: floor-division by 2 of the finer level's keys
  (`halve_keys`) + sort + dedup, i.e. MinkowskiEngine's stride-2 coordinate
  map;
* `up_parent`/`up_koffset`: each fine voxel's parent position in the coarser
  level and its kernel slot (f0&1, f1&1, f2&1).  The parent position is the
  unique ordinal of the halved key, so it falls out of the dedup sort;
* `kmap_self`: the stride-1 k^3 gather map, from the z-run kernels
  (`sparse/kernels.py`): one query per (dx, dy) column yields all kz
  z-slots.  Level 0 (the stem over constant-ones features) needs presence
  only and stores 0 where the neighbour exists, the sentinel where not;
  levels >= 1 store positions rank + popcount(bits below the slot).

* `kmap_block` (level 0, `PyramidSpec.l0_block_map`): the blocks'
  block_kernel_size^3 self map beside the stem's larger one, for a model
  whose blocks run at level 0 (MinkUNet's last stage).  Both kernels are
  centred and odd, so the smaller kernel's offsets are the centre cube of
  the larger's, in the same C order: the map is a slice of the stem's map,
  equal to a direct search.

* `kmap_down`: the k=2 s=2 down conv's (B, 8, C_l) gather map into level
  l-1, for l >= 1.  Where level l-1 records no up map it is always built, by
  the lookup kernel in down mode (`sparse/kernels.py::lookup_down`: the 8
  child keys 2 * coord + d of every voxel, looked up in level l-1's sorted
  keys), one launch for all such levels: the only way to run their down
  convs.  Where the up map exists it is built only with
  `with_kmap_down=True` (the training forward), as the up map inverted
  (`sparse/kernels.py::invert_up`); the eval down convs run in transposed
  form from the up map instead (`sparse/kernels.py::tdown`).  Both give the
  same map: a child key is in the fine table or not, and a fine voxel
  dropped by capacity is absent from both.

Kernel offsets are enumerated in C order over (dx, dy, dz), dz fastest; this
fixes the kernel-weight layout (K, F_in, F_out).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from egonn_tpu_torch.parallel.mesh import all_reduce_max
from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse.packing import (
    DEFAULT_PACK,
    MAXKEY,
    PackSpec,
    compact_first,
    halve_keys,
    halved_spec,
    offset_range,
    run_starts,
    sorted_unique,
    unpack_keys,
)
from egonn_tpu_torch.sparse.types import Level, Pyramid
from egonn_tpu_torch.utils.tracing import span


def _offsets(kernel_size: int, dims: int) -> np.ndarray:
    return np.array(list(itertools.product(offset_range(kernel_size), repeat=dims)),
                    dtype=np.int32)


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """(K, 3) int32 offsets. Odd kernels are centred (-k//2..k//2), even
    kernels use [0, k)."""
    return _offsets(kernel_size, 3)


def _xy_offsets(kernel_size: int) -> np.ndarray:
    """(K^2, 2) (dx, dy) offsets in C order; z is handled as contiguous runs."""
    return _offsets(kernel_size, 2)


@dataclass(frozen=True)
class PyramidSpec:
    """Static configuration of the pyramid.

    capacities: per-level voxel capacity, len == num_levels + 1.
    conv0_kernel_size / block_kernel_size: the stem's and the blocks' kernels.
    self_levels: levels >= 1 that get a k^3 self map (level 0 always does).
    up_levels: levels that record their up map to level l+1.
    pack: packed-key bit budget.
    need_source_index: level 0 records the input row of each voxel when it
      re-canonicalizes its input.
    conv0_ones: the stem consumes constant-ones features, so its map records
      presence only (0 / sentinel).
    l0_block_map: level 0 also gets the blocks' self map (`Level.kmap_block`),
      sliced from the stem's (which must record positions: not conv0_ones).
    """

    capacities: Tuple[int, ...]
    conv0_kernel_size: int = 5
    block_kernel_size: int = 3
    self_levels: Tuple[int, ...] = ()
    up_levels: Tuple[int, ...] = ()
    pack: PackSpec = DEFAULT_PACK
    need_source_index: bool = True
    conv0_ones: bool = False
    l0_block_map: bool = False

    def __post_init__(self):
        if self.l0_block_map and (
                self.conv0_ones or self.block_kernel_size % 2 == 0
                or self.conv0_kernel_size % 2 == 0
                or self.block_kernel_size > self.conv0_kernel_size):
            raise ValueError("l0_block_map slices the stem's map: it needs odd kernels, the "
                             "blocks' no larger than the stem's, and positions (conv0_ones "
                             "False)")

    @property
    def num_levels(self) -> int:
        return len(self.capacities) - 1

    def pack_at(self, level: int) -> PackSpec:
        sp = self.pack
        for _ in range(level):
            sp = halved_spec(sp)
        return sp


def _zrun_queries(coords_t: torch.Tensor, mask: torch.Tensor, k: int, pack: PackSpec):
    """Base queries for the z-run kernels of a k^3 self map: for each of the
    k^2 (dx, dy) offsets (C order) the packed key at the column's lowest z
    slot dz = -(k // 2), clamped into the z field, plus the per-voxel
    realignment shift and valid-bit mask.

    coords_t (B, 3, C), mask (B, C).  Returns (q_lo (B, k^2, C) int32,
    jshift (B, C) int32, top_mask (B, C) int32): presence of slot s
    (dz = -(k // 2) + s) is bit s of `(bits & top_mask) << jshift`."""
    bx, by, bz = pack.bits
    ox, oy, oz = pack.offsets
    z_start = offset_range(k)[0]
    # built on the device: a host-to-device copy would synchronize the stream
    rng = torch.arange(z_start, z_start + k, dtype=torch.int32, device=coords_t.device)
    dxs = rng.repeat_interleave(k)[None, :, None]
    dys = rng.repeat(k)[None, :, None]
    x = coords_t[:, None, 0] + dxs + ox                  # (B, Kxy, C)
    y = coords_t[:, None, 1] + dys + oy
    z_base = coords_t[:, 2] + z_start + oz                # (B, C)
    z_clamp = z_base.clamp(0, (1 << bz) - 1)
    jshift = z_clamp - z_base                             # >= 0 for valid voxels
    n_ok = ((1 << bz) - z_clamp).clamp(0, k)
    top_mask = (1 << n_ok) - 1
    xyok = (x >= 0) & (x < (1 << bx)) & (y >= 0) & (y < (1 << by))
    key = (x << (by + bz)) | (y << bz) | z_clamp[:, None, :]
    q_lo = torch.where(xyok & mask[:, None, :], key, MAXKEY)
    return (q_lo.to(torch.int32).contiguous(), jshift.to(torch.int32),
            top_mask.to(torch.int32))


def _self_kmap(keys: torch.Tensor, coords_t: torch.Tensor, mask: torch.Tensor, k: int,
               pack: PackSpec, presence_only: bool) -> torch.Tensor:
    """(B, k^3, C) self kernel map from the z-run kernels' bits (and rank)."""
    b, c = mask.shape
    q_lo, jshift, top = _zrun_queries(coords_t, mask, k, pack)
    if presence_only:
        bits = kernels.zrun_presence(keys, q_lo, kz=k)
        rank = None
    else:
        bits, rank = kernels.zrun_rank(keys, q_lo, kz=k)
    aligned = (bits & top[:, None, :]) << jshift[:, None, :]
    rows = []
    below = torch.zeros_like(aligned)  # popcount(aligned & ((1 << s) - 1))
    for s in range(k):
        pres = (aligned >> s) & 1
        pos = torch.zeros_like(pres) if presence_only else rank + below
        rows.append(torch.where(pres > 0, pos, c))
        below = below + pres
    return torch.stack(rows, dim=2).reshape(b, k ** 3, c).to(torch.int32)


def _block_map(kmap_self: torch.Tensor, k_stem: int, k_block: int) -> torch.Tensor:
    """(B, k_block^3, C) the centre cube of a (B, k_stem^3, C) self map: the
    offsets with every |d| <= k_block // 2, in C order (one copy, no index
    tensor)."""
    b, _, c = kmap_self.shape
    lo = (k_stem - k_block) // 2
    cube = kmap_self.reshape(b, k_stem, k_stem, k_stem, c)[
        :, lo:lo + k_block, lo:lo + k_block, lo:lo + k_block]
    return cube.reshape(b, k_block ** 3, c)


def _dedup_chain(keys0: torch.Tensor, spec: PyramidSpec):
    """Sorted voxel sets of levels 1..L from level 0's keys, plus the up-map
    parents.  Returns lists (coords, masks, keys, n_uniques) for levels
    1..L and up_parents for levels 0..L-1: up_parents[l] holds, per voxel
    of level l, its parent's position in level l+1."""
    coords, masks, keys, n_uniques, up_parents = [], [], [keys0], [], []
    for l in range(1, spec.num_levels + 1):
        down_keys = halve_keys(keys[-1], spec.pack_at(l - 1))
        cap_l = spec.capacities[l]
        # halving breaks sortedness: re-sort, carrying the fine position
        sk, sp = torch.sort(down_keys, dim=1)
        is_first = run_starts(sk)
        out_keys, rank, _ = compact_first(sk, is_first, cap_l)
        # the unique ordinal of the halved key is the parent's position
        pr = torch.where((sk != MAXKEY) & (rank < cap_l), rank, cap_l).to(torch.int32)
        up_par = torch.empty_like(pr)
        up_par.scatter_(1, sp, pr)  # back to fine order (sp is a permutation)
        up_parents.append(up_par)
        out_mask = out_keys != MAXKEY
        coords.append(torch.where(out_mask[:, None, :],
                                  unpack_keys(out_keys, spec.pack_at(l)), 0).to(torch.int32))
        masks.append(out_mask)
        keys.append(out_keys)
        n_uniques.append(is_first.sum(1).to(torch.int32))
    return coords, masks, keys[1:], n_uniques, up_parents


def build_pyramid(coords0_t: torch.Tensor, mask0: torch.Tensor, spec: PyramidSpec,
                  n_unique0: Optional[torch.Tensor] = None,
                  keys0: Optional[torch.Tensor] = None,
                  with_kmap_down: bool = False) -> Pyramid:
    """Build the batched coordinate pyramid.

    coords0_t (B, 3, C0) int32 level-0 voxel coords, mask0 (B, C0).  Inputs
    need not be sorted or unique unless keys0 (B, C0) is given (a
    Quantizer.quantize output), in which case level 0 is taken as canonical.
    with_kmap_down: also build `kmap_down` where the finer level records an
    up map (training); where it records none, `kmap_down` is always built.
    """
    with span("egonn.pyramid"):
        if n_unique0 is None:
            n_unique0 = mask0.sum(1).to(torch.int32)
        source_index = None
        if keys0 is None:
            u0 = sorted_unique(coords0_t, mask0, spec.capacities[0], spec.pack,
                               need_index=spec.need_source_index)
            coords0_t, mask0, keys0 = u0.coords_t, u0.mask, u0.keys
            if spec.need_source_index:
                source_index = u0.index
        coords, masks, keys, n_uniques, up_parents = _dedup_chain(keys0, spec)
        coords, masks, keys = [coords0_t] + coords, [mask0] + masks, [keys0] + keys
        n_uniques = [n_unique0.to(torch.int32)] + n_uniques

        # the down maps of levels whose finer level records no up map: one
        # launch (they need only the dedup chain's keys)
        down_levels = [l for l in range(1, spec.num_levels + 1) if l - 1 not in spec.up_levels]
        looked_up = {}
        if down_levels:
            looked_up = dict(zip(down_levels, kernels.lookup_down(
                keys, [spec.pack_at(l) for l in range(spec.num_levels + 1)], down_levels)))

        levels = []
        for l in range(spec.num_levels + 1):
            kmap_self = None
            if l == 0 or l in spec.self_levels:
                k = spec.conv0_kernel_size if l == 0 else spec.block_kernel_size
                kmap_self = _self_kmap(keys[l], coords[l], masks[l], k, spec.pack_at(l),
                                       presence_only=(l == 0 and spec.conv0_ones))
            up_parent = up_koffset = None
            if l in spec.up_levels:
                if l + 1 > spec.num_levels:
                    raise ValueError(f"up level {l} has no parent level")
                kbits = coords[l] - 2 * (coords[l] // 2)  # (B, 3, C) in {0, 1}
                up_koffset = (4 * kbits[:, 0] + 2 * kbits[:, 1] + kbits[:, 2]).to(torch.int32)
                up_parent = up_parents[l]
            kmap_down = looked_up.get(l)
            if kmap_down is None and l >= 1 and with_kmap_down:
                kmap_down = kernels.invert_up(levels[l - 1].up_parent, levels[l - 1].up_koffset,
                                              spec.capacities[l])
            kmap_block = None
            if l == 0 and spec.l0_block_map:
                kmap_block = _block_map(kmap_self, spec.conv0_kernel_size,
                                        spec.block_kernel_size)
            levels.append(Level(
                coords=coords[l], mask=masks[l], n_unique=n_uniques[l],
                kmap_self=kmap_self, kmap_down=kmap_down, up_parent=up_parent,
                up_koffset=up_koffset,
                source_index=source_index if l == 0 else None, kmap_block=kmap_block,
            ))
        return Pyramid(levels=tuple(levels))


def capacity_report(pyramid: Pyramid, spec: PyramidSpec, group=None) -> dict:
    """Per-level true unique-voxel count (max over the batch) against capacity:
    {"cap_L{l}": (n_unique_max, capacity, ok)}.  n_unique counts keys beyond
    capacity too, so n_unique > capacity means the level dropped voxels.
    With a data-parallel group the max is over every rank's clouds."""
    levels = range(spec.num_levels + 1)
    n_max = all_reduce_max(torch.stack([pyramid[l].n_unique.max().long() for l in levels]),
                           group)
    out = {}
    for l, n in zip(levels, n_max.tolist()):
        out[f"cap_L{l}"] = (n, spec.capacities[l], n <= spec.capacities[l])
    return out


def egonn_pyramid_spec(cap0: int = 16384, num_levels: int = 7, min_out_level: int = 3,
                       decay: Sequence[float] = (1.0, 0.6, 0.4, 0.25, 0.15, 0.1, 0.08, 0.06),
                       ) -> PyramidSpec:
    """The published EgoNN pyramid: 7 stride-2 levels with ResNet blocks at
    1..7; capacities decay geometrically from cap0, rounded up to multiples
    of 128 with a floor of 256.  `min_out_level` is accepted and ignored, as
    the JAX package's signature has it (every level is built)."""
    del min_out_level
    caps = []
    for l in range(num_levels + 1):
        caps.append(max(256, int(np.ceil(cap0 * decay[min(l, len(decay) - 1)] / 128)) * 128))
    return PyramidSpec(
        capacities=tuple(caps),
        conv0_kernel_size=5,
        block_kernel_size=3,
        self_levels=tuple(range(1, num_levels + 1)),
        up_levels=tuple(range(0, num_levels)),
        need_source_index=False,
        conv0_ones=True,
    )
