"""Packed-key sorted voxel sets (port of `egonn_tpu/sparse/packing.py`).

Coordinates pack into one int32 key, `(x+ox) << (by+bz) | (y+oy) << bz |
(z+oz)`, with a bit budget summing to <= 31; out-of-range or masked voxels get
MAXKEY, which sorts last.  Dedup (`sorted_unique`) is sort -> run-start
detection -> cumsum rank -> one unique-index scatter that compacts the first
key of every run to the front, so every voxel set is sorted by key.

All functions take any number of leading batch dimensions: coords are
`(..., 3, N)`, keys and masks `(..., N)`.  Integer outputs are bit-equal to
the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

MAXKEY = 2**31 - 1  # sorts to the end; also the "invalid" marker


@dataclass(frozen=True)
class PackSpec:
    """Bit budget and offsets mapping signed voxel coords to a positive int32 key."""

    bits: Tuple[int, int, int] = (10, 10, 11)
    offsets: Tuple[int, int, int] = (512, 512, 1024)

    def __post_init__(self):
        if sum(self.bits) > 31:
            raise ValueError("packed key must fit in a positive int32")


DEFAULT_PACK = PackSpec()


def pack_keys(coords_t: torch.Tensor, mask: torch.Tensor,
              spec: PackSpec = DEFAULT_PACK) -> torch.Tensor:
    """(..., 3, N) int32 coords + (..., N) mask -> (..., N) int32 keys;
    invalid/out-of-range entries get MAXKEY."""
    bx, by, bz = spec.bits
    ox, oy, oz = spec.offsets
    x, y, z = coords_t.unbind(-2)
    x, y, z = x + ox, y + oy, z + oz
    in_range = ((x >= 0) & (x < (1 << bx)) & (y >= 0) & (y < (1 << by))
                & (z >= 0) & (z < (1 << bz)))
    key = (x << (by + bz)) | (y << bz) | z
    return torch.where(mask & in_range, key, MAXKEY).to(torch.int32)


def unpack_keys(keys: torch.Tensor, spec: PackSpec = DEFAULT_PACK) -> torch.Tensor:
    """(..., N) keys -> (..., 3, N) coords (MAXKEY entries are garbage)."""
    bx, by, bz = spec.bits
    ox, oy, oz = spec.offsets
    z = (keys & ((1 << bz) - 1)) - oz
    y = ((keys >> bz) & ((1 << by) - 1)) - oy
    x = ((keys >> (by + bz)) & ((1 << bx) - 1)) - ox
    return torch.stack([x, y, z], dim=-2)


def halve_keys(keys: torch.Tensor, spec: PackSpec = DEFAULT_PACK) -> torch.Tensor:
    """Packed key of floor(coord / 2), computed on the key (offsets must be
    even).  MAXKEY maps to MAXKEY.  Halving does not preserve sorted order."""
    bx, by, bz = spec.bits
    z = (keys & ((1 << bz) - 1)) >> 1
    y = ((keys >> bz) & ((1 << by) - 1)) >> 1
    x = ((keys >> (by + bz)) & ((1 << bx) - 1)) >> 1
    halved = (x << (by + bz)) | (y << bz) | z
    return torch.where(keys == MAXKEY, MAXKEY, halved).to(torch.int32)


def halved_spec(spec: PackSpec) -> PackSpec:
    """PackSpec whose offsets correspond to once-halved coordinates."""
    return PackSpec(spec.bits, tuple(o // 2 for o in spec.offsets))


def offset_range(kernel_size: int) -> range:
    """Per-axis kernel offsets: centred for odd kernels, [0, k) for even ones."""
    if kernel_size % 2 == 1:
        return range(-(kernel_size // 2), kernel_size // 2 + 1)
    return range(0, kernel_size)


def kmap_queries(coords_t: torch.Tensor, mask: torch.Tensor, kernel_size: int, scale: int,
                 pack: PackSpec) -> torch.Tensor:
    """Query keys of a kernel map: for every output voxel o and offset d of
    `pyramid.kernel_offsets(kernel_size)` (C order over (dx, dy, dz), dz
    fastest), the packed key of scale * o + d under `pack`; MAXKEY where it
    is out of range or o is padding.

    coords_t (B, 3, C), mask (B, C).  Returns (B, k^3, C) int32."""
    bx, by, bz = pack.bits
    ox, oy, oz = pack.offsets
    k = kernel_size
    lo = offset_range(k)[0]
    rng = torch.arange(lo, lo + k, dtype=torch.int32, device=coords_t.device)
    dxs = rng.repeat_interleave(k * k)[None, :, None]
    dys = rng.repeat_interleave(k).repeat(k)[None, :, None]
    dzs = rng.repeat(k * k)[None, :, None]
    x = scale * coords_t[:, None, 0] + dxs + ox             # (B, k^3, C)
    y = scale * coords_t[:, None, 1] + dys + oy
    z = scale * coords_t[:, None, 2] + dzs + oz
    ok = ((x >= 0) & (x < (1 << bx)) & (y >= 0) & (y < (1 << by)) & (z >= 0)
          & (z < (1 << bz)) & mask[:, None, :])
    key = (x << (by + bz)) | (y << bz) | z
    return torch.where(ok, key, MAXKEY).to(torch.int32).contiguous()


def run_starts(sorted_keys: torch.Tensor) -> torch.Tensor:
    """(..., n) sorted keys -> bool mask of the first entry of every run of
    equal non-MAXKEY keys."""
    prev = torch.cat([torch.full_like(sorted_keys[..., :1], -1),
                      sorted_keys[..., :-1]], dim=-1)
    return (sorted_keys != prev) & (sorted_keys != MAXKEY)


def compact_first(sorted_keys: torch.Tensor, is_first: torch.Tensor,
                  capacity: int, payload: Optional[torch.Tensor] = None):
    """Order-preserving compaction of the run starts to the front: kept entry
    j lands at its rank cumsum(is_first)[j] - 1; ranks >= capacity are
    dropped (the lowest keys are kept).  A unique-index scatter: rows that are
    not kept all go to one dump column past the end, which is cut off.

    Returns (keys (..., capacity) MAXKEY padded, rank (..., n) int64 unique
    ordinal of every entry's run, payload (..., capacity) zero padded or None).
    """
    rank = torch.cumsum(is_first, dim=-1) - 1
    dest = torch.where(is_first & (rank < capacity), rank, capacity)
    lead = sorted_keys.shape[:-1]
    out = torch.full((*lead, capacity + 1), MAXKEY, dtype=torch.int32,
                     device=sorted_keys.device)
    out.scatter_(-1, dest, sorted_keys.to(torch.int32))
    # the dump column got arbitrary keys; pads past the kept count are MAXKEY
    out_keys = out[..., :capacity].contiguous()
    out_payload = None
    if payload is not None:
        p = torch.zeros((*lead, capacity + 1), dtype=payload.dtype,
                        device=payload.device)
        p.scatter_(-1, dest, payload)
        out_payload = p[..., :capacity].contiguous()
    return out_keys, rank, out_payload


def lookup_sorted(sorted_keys: torch.Tensor, query_keys: torch.Tensor,
                  sentinel: int) -> torch.Tensor:
    """Positions of query keys in MAXKEY-padded sorted tables of unique keys;
    `sentinel` where a query is absent or MAXKEY.

    sorted_keys (..., C); query_keys (..., *q) with the same leading
    dimensions (any shape for a 1-D table).  Returns int32 like query_keys.
    A lower-bound search (`torch.searchsorted`) and one equality test: the
    JAX package's bucketed compare-all is a TPU device and is not carried
    over."""
    lead = sorted_keys.shape[:-1]
    c = sorted_keys.shape[-1]
    q = query_keys.reshape(*lead, -1)
    pos = torch.searchsorted(sorted_keys, q)
    hit = torch.gather(sorted_keys, -1, pos.clamp(max=c - 1)) == q
    found = hit & (pos < c) & (q != MAXKEY)
    return torch.where(found, pos, sentinel).to(torch.int32).reshape(query_keys.shape)


class SortedUnique(NamedTuple):
    keys: torch.Tensor      # (..., capacity) int32 sorted unique keys, MAXKEY padded
    coords_t: torch.Tensor  # (..., 3, capacity) int32 coords of unique voxels
    mask: torch.Tensor      # (..., capacity) bool
    index: torch.Tensor     # (..., capacity) int32 FIRST source row per voxel
                            # (0 on pads); all-zero when need_index=False
    n_unique: torch.Tensor  # (...) int32 unique count incl. beyond-capacity overflow


def sorted_unique(coords_t: torch.Tensor, mask: torch.Tensor, capacity: int,
                  spec: PackSpec = DEFAULT_PACK, need_index: bool = True) -> SortedUnique:
    """Fixed-capacity voxel dedup keeping the first (lowest source row) point
    per voxel; output sorted by packed key.

    need_index=False skips the source-row payload (the model never needs it);
    coords are then reconstructed from the keys."""
    keys = pack_keys(coords_t, mask, spec)
    # stable: equal keys keep source order, so the run start is the first row
    sorted_keys, sorted_rows = torch.sort(keys, dim=-1, stable=True)
    is_first = run_starts(sorted_keys)
    out_keys, _, out_rows = compact_first(
        sorted_keys, is_first, capacity,
        payload=sorted_rows if need_index else None)
    out_mask = out_keys != MAXKEY
    if need_index:
        out_rows = out_rows.to(torch.int32)
        # pads point at row 0, as the JAX compaction leaves them
        out_coords = torch.gather(
            coords_t, -1,
            out_rows.long().unsqueeze(-2).expand(*out_rows.shape[:-1], 3, capacity))
    else:
        out_rows = torch.zeros_like(out_keys)
        out_coords = torch.where(out_mask.unsqueeze(-2),
                                 unpack_keys(out_keys, spec), 0).to(torch.int32)
    n_unique = is_first.sum(-1).to(torch.int32)
    return SortedUnique(out_keys, out_coords, out_mask, out_rows, n_unique)
