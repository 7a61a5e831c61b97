"""The port's six hand-written CUDA kernels, each with its plain PyTorch
version and a launch counter.

| here            | CUDA source             | replaces (egonn_tpu/sparse/banded.py)          |
|-----------------|-------------------------|------------------------------------------------|
| `zrun_presence` | `csrc/zrun.cu`          | `_pallas_zrun_presence` / `zrun_presence`      |
| `zrun_rank`     | `csrc/zrun.cu`          | `_pallas_zrun_rank` / `zrun_rank`              |
| `gather_conv`   | `csrc/gather_conv.cu`   | `_pallas_banded_conv` / `banded_conv_pallas`   |
| `tdown`         | `csrc/tdown.cu`         | `_pallas_banded_tdown` / `banded_tdown_pallas` |
| `gather_dw`     | `csrc/gather_dw.cu`     | `_pallas_banded_dw` / `banded_conv_dw`         |
| `lookup`        | `csrc/lookup.cu`        | `_pallas_banded_lookup` / `banded_lookup`      |

`gather_conv` runs every sparse conv: the eval forward, and in training the
self and down convs' forwards and the dX backwards (`sparse/conv.py`);
`gather_dw` is the weight gradient of the self and down convs; `lookup`
builds the down maps of levels whose finer level records no up map
(`sparse/pyramid.py`).

The TPU kernels work on band windows of the key-sorted tables and drop what
falls outside a window; these kernels index directly, so they are exact on
all data and equal the JAX package's exact gather engine.

`gather_conv`, `tdown` and `gather_dw` multiply on the tensor cores in
split TF32 (`csrc/tf32x3.cuh`: each f32 operand split into two TF32 halves,
three `mma.sync` products, f32 accuracy), with their rows copied by
`cp.async` through a ring of shared-memory buffers, so later stages' rows
fly while one multiplies.  All three follow the valid map entries, not
dense tiles.  A `gather_conv` block (`csrc/gather_mm.cuh`) owns (32- or
64-column slice of F_out, 128-row tile, cloud) and walks the offsets with
any valid index and the 32-column F_in chunks, each offset's valid rows
gathered, compacted into dense 16-row MMA tiles and scatter-added into a
shared accumulator; where the grid is small a tile's offsets are split over
up to 4 blocks (`offset_groups`) and a second launch sums them in order.
`tdown` needs no inverted map: a first launch computes each coarse tile's
hull of fine rows from the up map (`tdown_hulls_plain`), and a block per
(column slice, tile, cloud) either builds the tile's child table from the
hull in shared memory and gathers each slot's children stage by stage, or,
on small deep levels, streams the hull's rows contiguously with all 8
slots' W resident (`tdown_tiling` picks the body and its tiling).  A `gather_dw`
block owns a (<= 64) x (<= 64) slice of one dW[k] over a strided chunk of
the tiles, each tile's valid rows compacted along the MMA depth, and a
second launch sums the chunks in order.  `zrun_presence` / `zrun_rank`
copy the slice of the key table that a chunk of a row's (sorted) queries
needs into shared memory and search there (`zrun_chunk` picks the chunk).
Widths: gather_conv / tdown take F_out a multiple of 32 up to 512 and F_in a
multiple of 4 up to 128 or of 32 up to 512 (`conv_widths_ok`); gather_dw
takes multiples of 32 up to 512 (`dw_widths_ok`).  No float atomics
anywhere: equal inputs give bit-equal outputs.

Dispatch: a wrapper given CUDA tensors launches its kernel (building the
kernels on first use) or raises; given CPU tensors it runs the plain version.
There is no fallback from one to the other.  Each wrapper adds one to its
entry of `LAUNCHES` where it launches its kernel (`reset_launches` zeroes
them, `launch_counts` reads them).

`epi = (scale (F_out,), bias (F_out,), relu: bool, mask (B, C_out) bool)` is
the eval-mode BatchNorm affine + ReLU + row mask fused into the conv's store:
`out = mask ? relu?(acc * scale + bias) : 0`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from egonn_tpu_torch.sparse import cuda_lib
from egonn_tpu_torch.sparse.packing import MAXKEY, lookup_sorted

_DW_BLOCKS = 8 * 132  # gather_dw's partial-pass blocks: eight per SM of an H100
# gather_conv splits a tile's offsets over blocks (summed by a second launch)
# where its grid has at most _SPLIT_BLOCKS blocks: one block per
# _SPLIT_STAGES (offset, 32-column F_in chunk) stages, at most 4 blocks (3
# with 64-column slices).  Fewer, longer blocks leave a tail of a few busy
# SMs; larger grids fill the card without it.  Chosen from the sweep of
# `probe_kernels.py` over the EgoNN forward's and train step's call shapes.
_SPLIT_BLOCKS, _SPLIT_STAGES = 1280, 24
# kernel launches per wrapper (CUDA tensors only; the plain versions do not count)
LAUNCHES = {"zrun_presence": 0, "zrun_rank": 0, "gather_conv": 0, "tdown": 0, "gather_dw": 0,
            "lookup": 0}
# per CUDA device: zrun blocks whose table slice did not fit (`zrun_overflow_blocks`)
_ZRUN_OVERFLOW: dict = {}


# ---------------------------------------------------------------------------
# shared checks
# ---------------------------------------------------------------------------

def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on {sorted(kinds)}: expected all on CUDA or all on the CPU")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Sequence[int],
           align16: bool = False) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _apply_epi(out: torch.Tensor, epi: Optional[tuple]) -> torch.Tensor:
    if epi is None:
        return out
    scale, bias, relu, mask = epi
    out = out * scale + bias
    if relu:
        out = torch.clamp_min(out, 0.0)
    return torch.where(mask[..., None], out, 0.0)


# ---------------------------------------------------------------------------
# zrun presence / rank
# ---------------------------------------------------------------------------

def zrun_plain(sorted_keys: torch.Tensor, q_lo: torch.Tensor, kz: int):
    """Plain version of both zrun kernels: (bits, rank), each like q_lo.

    rank = #keys < q (torch.searchsorted); the present keys of [q, q + kz)
    are the next kz table rows from rank.  MAXKEY queries get bits 0, rank 0."""
    b, c_in = sorted_keys.shape
    q = q_lo.reshape(b, -1)
    rank = torch.searchsorted(sorted_keys, q)
    q64 = q.long()
    bits = torch.zeros_like(q64)
    for j in range(kz):
        pos = rank + j
        d = torch.gather(sorted_keys, 1, pos.clamp(max=c_in - 1)).long() - q64
        hit = (pos < c_in) & (d >= 0) & (d < kz)
        bits |= torch.where(hit, torch.ones_like(d) << d.clamp(0, kz - 1), 0)
    valid = q != MAXKEY
    bits = torch.where(valid, bits, 0).to(torch.int32).reshape(q_lo.shape)
    rank = torch.where(valid, rank, 0).to(torch.int32).reshape(q_lo.shape)
    return bits, rank


def zrun_chunk(n_row: int) -> int:
    """Queries per zrun block: 1024 for rows of 8,192 queries or more, else
    512.  On an H100 this is the fastest of 256, 512 and 1024 for every
    zrun call of the forward, the train step and MinkLoc, or within 5% of it
    (`probe_kernels.py`): a block's time is a few round trips to L2 whatever
    its size, so long rows want few big chunks, and mid-size rows lose to
    1024's ragged last chunk."""
    return 1024 if n_row >= 8192 else 512


def _zrun_overflow(device: torch.device) -> torch.Tensor:
    device = _index_device(device)
    if device not in _ZRUN_OVERFLOW:
        _ZRUN_OVERFLOW[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _ZRUN_OVERFLOW[device]


def zrun_overflow_blocks(device) -> int:
    """zrun blocks on `device` whose table slice did not fit in shared memory
    (they searched the global table instead), since the first zrun launch
    there."""
    device = _index_device(device)
    return int(_ZRUN_OVERFLOW[device].item()) if device in _ZRUN_OVERFLOW else 0


def _index_device(device) -> torch.device:
    """`cuda` as `cuda:<current device>`, so both name one counter."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _zrun_cuda(sorted_keys, q_lo, kz, with_rank: bool, q_chunk: Optional[int] = None):
    if not 1 <= kz <= 8:
        raise ValueError(f"kz={kz}: the zrun kernels take 1 <= kz <= 8")
    b, c_in = sorted_keys.shape
    _check(sorted_keys, "sorted_keys", torch.int32, (b, c_in))
    if q_lo.dim() != 3 or q_lo.shape[0] != b:
        raise ValueError(f"q_lo: shape {tuple(q_lo.shape)}, expected (B={b}, Kxy, C_out)")
    _check(q_lo, "q_lo", torch.int32, q_lo.shape)
    n_xy, n_row = q_lo.shape[1], q_lo.shape[2]
    q_chunk = q_chunk or zrun_chunk(n_row)
    overflow = _zrun_overflow(q_lo.device)
    bits = torch.empty_like(q_lo)
    if with_rank:
        rank = torch.empty_like(q_lo)
        fn = cuda_lib.function("zrun.cu", "egonn_zrun_rank")
        err = fn(sorted_keys.data_ptr(), q_lo.data_ptr(), bits.data_ptr(), rank.data_ptr(),
                 overflow.data_ptr(), b, c_in, n_xy, n_row, q_chunk, kz, _stream(q_lo))
        _raise_on(err, "zrun_rank")
        return bits, rank
    fn = cuda_lib.function("zrun.cu", "egonn_zrun_presence")
    err = fn(sorted_keys.data_ptr(), q_lo.data_ptr(), bits.data_ptr(), overflow.data_ptr(), b,
             c_in, n_xy, n_row, q_chunk, kz, _stream(q_lo))
    _raise_on(err, "zrun_presence")
    return bits


def zrun_presence(sorted_keys: torch.Tensor, q_lo: torch.Tensor, kz: int) -> torch.Tensor:
    """Presence bits of [q, q + kz) for each base query in per-cloud sorted keys.

    sorted_keys (B, C_in) int32 (MAXKEY padded); q_lo (B, Kxy, C_out) int32
    (MAXKEY invalid).  Returns bits (B, Kxy, C_out) int32."""
    if not _on_cuda(sorted_keys, q_lo):
        return zrun_plain(sorted_keys, q_lo, kz)[0]
    bits = _zrun_cuda(sorted_keys, q_lo, kz, with_rank=False)
    LAUNCHES["zrun_presence"] += 1
    return bits


def zrun_rank(sorted_keys: torch.Tensor, q_lo: torch.Tensor, kz: int):
    """(bits, rank) for z-run base queries: the presence bits of
    zrun_presence plus rank(q) = #keys < q (0 for MAXKEY queries)."""
    if not _on_cuda(sorted_keys, q_lo):
        return zrun_plain(sorted_keys, q_lo, kz)
    out = _zrun_cuda(sorted_keys, q_lo, kz, with_rank=True)
    LAUNCHES["zrun_rank"] += 1
    return out


# ---------------------------------------------------------------------------
# gather conv
# ---------------------------------------------------------------------------

def gather_conv_plain(feats: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor,
                      epi: Optional[tuple] = None) -> torch.Tensor:
    """out[b, c] = sum_k feats[b, kmap[b, k, c]] @ kernel[k] (+ epi); an index
    outside [0, C_in) gathers a zero row."""
    b, c_in, f_in = feats.shape
    feats_p = torch.cat([feats, feats.new_zeros(b, 1, f_in)], dim=1)
    idx = torch.where((kmap >= 0) & (kmap < c_in), kmap, c_in).long()
    acc = feats.new_zeros(b, kmap.shape[2], kernel.shape[2], dtype=torch.float32)
    for k in range(kmap.shape[1]):
        g = torch.gather(feats_p, 1, idx[:, k, :, None].expand(-1, -1, f_in))
        acc = acc + torch.matmul(g, kernel[k])
    return _apply_epi(acc, epi)


def _check_epi(epi, b: int, c_out: int, f_out: int):
    if epi is None:
        return None, None, 0, None
    scale, bias, relu, mask = epi
    _check(scale, "epi scale", torch.float32, (f_out,))
    _check(bias, "epi bias", torch.float32, (f_out,))
    _check(mask, "epi mask", torch.bool, (b, c_out))
    return scale, bias, int(bool(relu)), mask


def conv_widths_ok(f_in: int, f_out: int) -> bool:
    """The widths gather_conv and tdown take: F_out a multiple of 32 up to
    512; F_in a multiple of 4 up to 128, or a multiple of 32 up to 512."""
    return (f_out % 32 == 0 and 32 <= f_out <= 512
            and ((f_in % 4 == 0 and 4 <= f_in <= 128) or (f_in % 32 == 0 and 32 <= f_in <= 512)))


def dw_widths_ok(f_in: int, f_out: int) -> bool:
    """The widths gather_dw takes: F_in and F_out multiples of 32 up to 512."""
    return all(f % 32 == 0 and 32 <= f <= 512 for f in (f_in, f_out))


def _check_widths(f_in: int, f_out: int, name: str, c_in: int) -> None:
    if not conv_widths_ok(f_in, f_out):
        raise ValueError(f"{name}: F_in={f_in}, F_out={f_out}; the kernel takes F_out a "
                         "multiple of 32 up to 512 and F_in a multiple of 4 up to 128 or of "
                         "32 up to 512")
    if c_in >= 1 << 24:  # the kernel packs (row, source) into one int
        raise ValueError(f"{name}: {c_in} input rows; the kernel takes fewer than 2^24")


def conv_cols(b: int, c_out: int, f_out: int, k_vol: int) -> int:
    """The output columns of a gather_conv block, 32 or 64.  64 halve the
    blocks that gather each row and stage W[k]; on an H100 they win for the
    self convs (K >= 27) where the 64-column grid keeps >= 256 blocks, and
    on the ResNet-width calls (256 and 512 columns, K 27 and 8), and lose on
    the EgoNN down convs (K = 8) and the deep levels' small grids
    (`probe_kernels.py`)."""
    if f_out % 64:
        return 32
    blocks = b * -(-c_out // 128) * (f_out // 64)
    return 64 if f_out >= 256 or (k_vol >= 27 and blocks >= 256) else 32


def offset_groups(b: int, c_out: int, f_in: int, f_out: int, k_vol: int) -> int:
    """How many blocks share one output tile of gather_conv, each summing a
    contiguous range of the offsets."""
    cols = conv_cols(b, c_out, f_out, k_vol)
    if b * -(-c_out // 128) * (f_out // cols) > _SPLIT_BLOCKS:
        return 1
    stages = k_vol * -(-f_in // 32)
    return max(1, min(3 if cols == 64 else 4, k_vol, stages // _SPLIT_STAGES))


def gather_conv(feats: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor,
                epi: Optional[tuple] = None) -> torch.Tensor:
    """Sparse conv over a gather map with the optional fused epilogue.

    feats (B, C_in, F_in) f32; kmap (B, K, C_out) int32 (sentinel C_in);
    kernel (K, F_in, F_out) f32.  Returns (B, C_out, F_out) f32."""
    tensors = [feats, kmap, kernel] + ([epi[0], epi[1], epi[3]] if epi else [])
    if not _on_cuda(*tensors):
        return gather_conv_plain(feats, kmap, kernel, epi)
    b, c_in, f_in = feats.shape
    k_vol, _, f_out = kernel.shape
    c_out = kmap.shape[2]
    _check_widths(f_in, f_out, "gather_conv", c_in)
    _check(feats, "feats", torch.float32, (b, c_in, f_in), align16=True)
    _check(kmap, "kmap", torch.int32, (b, k_vol, c_out))
    _check(kernel, "kernel", torch.float32, (k_vol, f_in, f_out), align16=True)
    scale, bias, relu, mask = _check_epi(epi, b, c_out, f_out)
    out = torch.empty((b, c_out, f_out), dtype=torch.float32, device=feats.device)
    cols = conv_cols(b, c_out, f_out, k_vol)
    n_groups = offset_groups(b, c_out, f_in, f_out, k_vol)
    partial = (torch.empty((n_groups, b, c_out, f_out), dtype=torch.float32, device=feats.device)
               if n_groups > 1 else None)
    fn = cuda_lib.function("gather_conv.cu", "egonn_gather_conv")
    err = fn(feats.data_ptr(), kmap.data_ptr(), kernel.data_ptr(), _ptr(scale), _ptr(bias),
             _ptr(mask), out.data_ptr(), _ptr(partial), n_groups, b, c_in, f_in, k_vol, c_out,
             f_out, cols, relu, _stream(feats))
    _raise_on(err, "gather_conv")
    LAUNCHES["gather_conv"] += 1
    return out


# ---------------------------------------------------------------------------
# transposed down conv
# ---------------------------------------------------------------------------

def invert_up(up_parent: torch.Tensor, up_koffset: torch.Tensor, c_coarse: int
              ) -> torch.Tensor:
    """(B, C_fine) parent/slot -> (B, 8, C_coarse) child index (sentinel
    C_fine): the k=2 s=2 down conv's gather map.  A unique-index scatter;
    fine voxels without a parent go to a dump column that is cut off."""
    b, c_fine = up_parent.shape
    valid = (up_parent >= 0) & (up_parent < c_coarse) & (up_koffset >= 0) & (up_koffset < 8)
    tgt = torch.where(valid, up_koffset.long() * c_coarse + up_parent.long(), 8 * c_coarse)
    child = torch.full((b, 8 * c_coarse + 1), c_fine, dtype=torch.int32,
                       device=up_parent.device)
    fine_idx = torch.arange(c_fine, dtype=torch.int32, device=up_parent.device)
    child.scatter_(1, tgt, fine_idx.expand(b, c_fine))
    return child[:, :8 * c_coarse].reshape(b, 8, c_coarse).contiguous()


def tdown_plain(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
                kernel: torch.Tensor, c_coarse: int, epi: Optional[tuple] = None
                ) -> torch.Tensor:
    """out[p] = sum over fine children i of p of feats[i] @ kernel[koffset(i)]
    (+ epi): the up map inverted, then the gather conv over it."""
    return gather_conv_plain(feats, invert_up(up_parent, up_koffset, c_coarse), kernel, epi)


def tdown_hulls_plain(up_parent: torch.Tensor, c_coarse: int, rows: int) -> torch.Tensor:
    """(B, ceil(c_coarse / rows), 2) int32 [first, end) per tile of `rows`
    coarse rows: the fine rows between the first whose running max of
    parents reaches the tile and the last whose running min from the end
    lies below the tile's end (rows without a parent in [0, c_coarse) count
    as -1 and +inf).  Every child of the tile lies inside; the tdown
    kernel's first launch computes the same (tdown_layout's formula in
    egonn_tpu/sparse/banded.py without its alignment)."""
    valid = (up_parent >= 0) & (up_parent < c_coarse)
    m = torch.cummax(torch.where(valid, up_parent, -1), dim=1).values
    hi = torch.where(valid, up_parent, 1 << 30)
    rm = torch.flip(torch.cummin(torch.flip(hi, [1]), dim=1).values, [1])
    bounds = torch.arange(0, c_coarse, rows, dtype=up_parent.dtype, device=up_parent.device)
    bounds = bounds.expand(up_parent.shape[0], -1).contiguous()
    first = torch.searchsorted(m.contiguous(), bounds)  # entries below the bound
    end = torch.searchsorted(rm.contiguous(), bounds + rows)
    return torch.stack([first, end], dim=2).to(torch.int32)


def tdown_tiling(b: int, c_fine: int, f_in: int):
    """(rows, rc, gather) of a tdown call: the gathering body (128-row
    tiles) at F_in <= 64 and on calls of 49,152 fine rows or more (B x
    C_fine), else the streaming body with 32-row tiles and 128-row stages.
    On an H100 the rule's body is the fastest, or within 1 us of it, at
    every forward, validation step and MinkLoc call, and the streaming
    tiling within 11 us of its best (`probe_kernels.py`): the gathering
    body walks 8 x F_in / 64 stages of a slot's children each, which the
    deep levels' few children do not fill, while the streaming body loads
    all of w and its hull's rows at once."""
    if f_in <= 64 or b * c_fine >= 49152:
        return 128, 0, True
    return 32, 128, False


def tdown_tiling_ok(f_in: int, f_out: int, rows: int, rc: int, gather: bool = False) -> bool:
    """Whether the tdown kernel takes this tiling: the gathering body with
    128-row tiles, or the streaming body with 32, 64 or 128 rows and row
    chunks, all of which fit a block's shared memory but chunks of 128 rows
    beside more than 32 rows above 64 F_in columns; F_out a multiple of the
    32-column slice."""
    if f_out % 32:
        return False
    if gather:
        return rows == 128
    return (rows in (32, 64, 128) and rc in (32, 64, 128)
            and not (f_in > 64 and rc == 128 and rows > 32))


def _tdown_hulls_cuda(up_parent: torch.Tensor, c_coarse: int, rows: int) -> torch.Tensor:
    """The tdown kernel's first launch alone (tests and launch sweeps): the
    hulls of `tdown_hulls_plain` from the card."""
    b, c_fine = up_parent.shape
    _check(up_parent, "up_parent", torch.int32, (b, c_fine))
    hull = torch.empty((b, -(-c_coarse // rows), 2), dtype=torch.int32, device=up_parent.device)
    fn = cuda_lib.function("tdown.cu", "egonn_tdown_hulls")
    _raise_on(fn(up_parent.data_ptr(), hull.data_ptr(), b, c_fine, c_coarse, rows,
                 _stream(up_parent)), "tdown hulls")
    return hull


def _tdown_cuda(feats, up_parent, up_koffset, kernel, c_coarse, epi, rows, rc, gather=False):
    b, c_fine, f_in = feats.shape
    f_out = kernel.shape[2]
    _check_widths(f_in, f_out, "tdown", c_fine)
    if not tdown_tiling_ok(f_in, f_out, rows, rc, gather):
        raise ValueError(f"tdown: {rows}-row tiles, {rc}-row stages at F_in={f_in}; "
                         "see tdown_tiling_ok")
    _check(feats, "feats", torch.float32, (b, c_fine, f_in), align16=True)
    _check(up_parent, "up_parent", torch.int32, (b, c_fine))
    _check(up_koffset, "up_koffset", torch.int32, (b, c_fine))
    _check(kernel, "kernel", torch.float32, (8, f_in, f_out), align16=True)
    scale, bias, relu, mask = _check_epi(epi, b, c_coarse, f_out)
    hull = torch.empty((b, -(-c_coarse // rows), 2), dtype=torch.int32, device=feats.device)
    out = torch.empty((b, c_coarse, f_out), dtype=torch.float32, device=feats.device)
    fn = cuda_lib.function("tdown.cu", "egonn_tdown")
    err = fn(feats.data_ptr(), up_parent.data_ptr(), up_koffset.data_ptr(), kernel.data_ptr(),
             _ptr(scale), _ptr(bias), _ptr(mask), hull.data_ptr(), out.data_ptr(),
             b, c_fine, f_in, c_coarse, f_out, rows, rc, int(gather), relu, _stream(feats))
    _raise_on(err, "tdown")
    return out


def tdown(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
          kernel: torch.Tensor, c_coarse: int, epi: Optional[tuple] = None) -> torch.Tensor:
    """k=2 s=2 down conv driven by the fine level's up map.

    feats (B, C_fine, F_in) f32; up_parent/up_koffset (B, C_fine) int32;
    kernel (8, F_in, F_out) f32.  Returns (B, c_coarse, F_out) f32."""
    tensors = [feats, up_parent, up_koffset, kernel] + ([epi[0], epi[1], epi[3]] if epi else [])
    if not _on_cuda(*tensors):
        return tdown_plain(feats, up_parent, up_koffset, kernel, c_coarse, epi)
    tiling = tdown_tiling(*feats.shape)
    out = _tdown_cuda(feats, up_parent, up_koffset, kernel, c_coarse, epi, *tiling)
    LAUNCHES["tdown"] += 1
    return out


# ---------------------------------------------------------------------------
# conv weight gradient
# ---------------------------------------------------------------------------

def gather_dw_plain(feats: torch.Tensor, kmap: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW[k] = sum_b sum_o feats[b, kmap[b, k, o]]^T g[b, o]: a gather per
    offset, then one contraction over the batch and the rows (the JAX
    package's `_conv_dkernel_gather`); an index outside [0, C_in) gathers a
    zero row."""
    b, c_in, f_in = feats.shape
    feats_p = torch.cat([feats, feats.new_zeros(b, 1, f_in)], dim=1)
    idx = torch.where((kmap >= 0) & (kmap < c_in), kmap, c_in).long()
    out = feats.new_empty(kmap.shape[1], f_in, g.shape[2])
    for k in range(kmap.shape[1]):
        gth = torch.gather(feats_p, 1, idx[:, k, :, None].expand(-1, -1, f_in))
        out[k] = torch.einsum("bcf,bco->fo", gth, g)
    return out


def dw_tiling(b: int, c_out: int, f_in: int, f_out: int, k_vol: int):
    """(mb, nb, n_chunks) of gather_dw's partial pass: a block owns an
    mb x nb slice of one dW[k] (64 where the width allows, else 32) over one
    of n_chunks strided chunks of the 64-row tiles, ~_DW_BLOCKS blocks in
    all."""
    mb, nb = (64 if f % 64 == 0 else 32 for f in (f_in, f_out))
    blocks = k_vol * (f_in // mb) * (f_out // nb)
    n_chunks = max(1, min(b * -(-c_out // 64), -(-_DW_BLOCKS // blocks)))
    return mb, nb, n_chunks


def gather_dw(feats: torch.Tensor, kmap: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of `gather_conv(feats, kmap, W)` for the cotangent g.

    feats (B, C_in, F_in) f32; kmap (B, K, C_out) int32 (sentinel C_in);
    g (B, C_out, F_out) f32.  Returns (K, F_in, F_out) f32."""
    if not _on_cuda(feats, kmap, g):
        return gather_dw_plain(feats, kmap, g)
    b, c_in, f_in = feats.shape
    k_vol, c_out = kmap.shape[1], kmap.shape[2]
    f_out = g.shape[2]
    if not dw_widths_ok(f_in, f_out):
        raise ValueError(f"gather_dw: F_in={f_in}, F_out={f_out}; the kernel takes widths "
                         "that are multiples of 32 up to 512")
    _check(feats, "feats", torch.float32, (b, c_in, f_in), align16=True)
    _check(kmap, "kmap", torch.int32, (b, k_vol, c_out))
    _check(g, "g", torch.float32, (b, c_out, f_out), align16=True)
    mb, nb, n_chunks = dw_tiling(b, c_out, f_in, f_out, k_vol)
    partial = torch.empty((n_chunks, k_vol, f_in, f_out), dtype=torch.float32,
                          device=feats.device)
    out = torch.empty((k_vol, f_in, f_out), dtype=torch.float32, device=feats.device)
    fn = cuda_lib.function("gather_dw.cu", "egonn_gather_dw")
    err = fn(feats.data_ptr(), kmap.data_ptr(), g.data_ptr(), partial.data_ptr(),
             out.data_ptr(), b, c_in, f_in, k_vol, c_out, f_out, mb, nb, n_chunks,
             _stream(feats))
    _raise_on(err, "gather_dw")
    LAUNCHES["gather_dw"] += 1
    return out


# ---------------------------------------------------------------------------
# sorted-key lookup
# ---------------------------------------------------------------------------

def lookup_plain(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the lookup kernel: `packing.lookup_sorted` per cloud
    with the sentinel C_in."""
    return lookup_sorted(sorted_keys, queries, sentinel=sorted_keys.shape[1])


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Position of each query key in its cloud's sorted key table.

    sorted_keys (B, C_in) int32 (unique keys, MAXKEY padded); queries
    (B, K, C_out) int32 (MAXKEY invalid).  Returns (B, K, C_out) int32
    positions, C_in where the key is absent or the query invalid."""
    if not _on_cuda(sorted_keys, queries):
        return lookup_plain(sorted_keys, queries)
    b, c_in = sorted_keys.shape
    _check(sorted_keys, "sorted_keys", torch.int32, (b, c_in))
    if queries.dim() != 3 or queries.shape[0] != b:
        raise ValueError(f"queries: shape {tuple(queries.shape)}, expected (B={b}, K, C_out)")
    _check(queries, "queries", torch.int32, queries.shape)
    pos = torch.empty_like(queries)
    fn = cuda_lib.function("lookup.cu", "egonn_lookup")
    err = fn(sorted_keys.data_ptr(), queries.data_ptr(), pos.data_ptr(), b, c_in,
             queries.shape[1] * queries.shape[2], _stream(queries))
    _raise_on(err, "lookup")
    LAUNCHES["lookup"] += 1
    return pos


KERNELS = (zrun_presence, zrun_rank, gather_conv, tdown, gather_dw, lookup)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
