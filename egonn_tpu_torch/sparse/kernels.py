"""The port's hand-written CUDA kernels, each with its plain PyTorch version
and a launch counter.

| here            | CUDA source             | replaces (egonn_tpu/sparse/banded.py)          |
|-----------------|-------------------------|------------------------------------------------|
| `zrun_presence` | `csrc/zrun.cu`          | `_pallas_zrun_presence` / `zrun_presence`      |
| `zrun_rank`     | `csrc/zrun.cu`          | `_pallas_zrun_rank` / `zrun_rank`              |
| `gather_conv`   | `csrc/gather_conv.cu`   | `_pallas_banded_conv` / `banded_conv_pallas`   |
| `tdown`         | `csrc/tdown.cu`         | `_pallas_banded_tdown` / `banded_tdown_pallas` |
| `gather_dw`     | `csrc/gather_dw.cu`     | `_pallas_banded_dw` / `banded_conv_dw`         |
| `lookup`        | `csrc/lookup.cu`        | `_pallas_banded_lookup` / `banded_lookup`      |
| `stem_ones`     | `csrc/stem.cu`          | none: jnp in `egonn_tpu/sparse/conv.py`        |
| `tconv`         | `csrc/tconv.cu`         | none: XLA's product in `egonn_tpu/sparse/conv.py` |
| `slot_order`    | `csrc/tconv.cu`         | none: `tconv`'s row order                      |
| `tconv_dw`      | `csrc/tconv_dw.cu`      | none: XLA's product in `egonn_tpu/sparse/conv.py` |

`gather_conv` runs every sparse conv: the eval forward, and in training the
self and down convs' forwards and the dX backwards (`sparse/conv.py`);
`gather_dw` is the weight gradient of the self and down convs; `lookup`
builds the down maps of levels whose finer level records no up map
(`sparse/pyramid.py`).  `stem_ones` is the stem conv over constant-ones
features (each output row the sum of the kernel rows of the offsets whose
neighbour exists): one pass over the level-0 map, where the plain version
builds a 0/1 f32 matrix of the map and multiplies it.  `tconv` is the
transposed k=2 s=2 conv (the heads' and MinkFPN's top-down step, and the
down conv's dX in training): each fine row times its own slot's kernel,
over the rows in slot order (`slot_order`, a counting sort per cloud),
where its plain version (the JAX package's form) multiplies every row by
all 8 slots' kernels and keeps one.  `tconv_dw` is its weight gradient in
training: each slot's rows of the slot order alone, where its plain
version multiplies a slot-masked copy of every row's parent by g, 8 times.

The TPU kernels work on band windows of the key-sorted tables and drop what
falls outside a window; these kernels index directly, so they are exact on
all data and equal the JAX package's exact gather engine.

`gather_conv`, `tdown`, `gather_dw`, `tconv` and `tconv_dw` multiply on the tensor
cores in split TF32 (`csrc/tf32x3.cuh`: each f32 operand split into two TF32 halves,
three `mma.sync` products, f32 accuracy), with their rows copied by
`cp.async` through a ring of shared-memory buffers, so later stages' rows
fly while one multiplies.  The first three follow the valid map entries,
not dense tiles.  A `gather_conv` block (`csrc/gather_mm.cuh`) owns (32- or
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
A `tconv` block owns
(32- or 64-column slice, 128-row tile of one slot's rows, cloud): a dense
product whose gathered parent rows all take w[slot], in 32-column stages.
A `tconv_dw` block owns a (<= 64) x (<= 64) slice of one dW[k] over a
strided chunk of the slot's 64-row tiles, the segments of all clouds
walked as one list, and a second launch sums the chunks in order.
`lookup` does the same per tile of a level's output rows, and in down mode
(`lookup_down`) forms the child queries itself, for every lookup-built level
of a pyramid in one launch.

bf16 features (the activations under `EGONN_BF16_ACTS=1`, `sparse/conv.py`)
take the bf16 kernels of `gather_conv`, `tdown` and `gather_dw`
(`csrc/bf16.cuh`): the TPU kernels' numerics, bf16 x bf16 products on the
tensor cores summed in f32.  gather_conv and gather_dw have two bf16 bodies
each: SM90 (`wgmma` on shared-memory tiles fed through an `mbarrier` ring
by producer warps, W^T by TMA; `csrc/gather_mm_sm90.cuh`, `gather_dw.cu`)
and SM80 (Ampere-style: `mma.sync` m16n8k16 behind a block barrier per stage);
`conv_body` and `dw_body` pick one per call shape, from the probe's sweep
(`BODY_LAUNCHES` counts each).  The convs' weights are
rounded to bf16 (to nearest even) and transposed by the wrapper, the
epilogue is applied in f32 and the output rounded once to bf16; the dW
kernel takes g in bf16 (rounded by the wrapper if it comes in f32) and
returns dW in f32.  Their plain versions compute the same from the
bf16-rounded operands.  They count under `gather_conv_bf16`, `tdown_bf16`
and `gather_dw_bf16`.  f32 features take the split-TF32 kernels; any other
type raises.

Widths: the kernels take F_out a multiple of 32 up to 512 and F_in a
multiple of 4 (bf16: 8) up to 128 or of 32 up to 512 (gather_conv, tdown:
`conv_widths_ok`), or multiples of 32 up to 512 (gather_dw, tconv_dw:
`dw_widths_ok`).
The wrappers take any width: `width_plan` zero-pads each width up to the
next one the kernel takes and splits widths above 512 into launches of at
most 512 (exact: a split F_in's partial sums are added before the
epilogue; bf16 features, whose output is rounded once, take F_in up to
512).  No float atomics anywhere: equal inputs give bit-equal outputs.

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

import ctypes
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from egonn_tpu_torch.sparse import cuda_lib
from egonn_tpu_torch.sparse.packing import (
    MAXKEY,
    PackSpec,
    kmap_queries,
    lookup_sorted,
    unpack_keys,
)

_DW_BLOCKS = 8 * 132  # gather_dw's partial-pass blocks: eight per SM of an H100
# the Hopper bf16 dW body's partial-pass blocks: three fit an SM
_DW_SM90_BLOCKS = 3 * 132
# The bf16 bodies of gather_conv and gather_dw: SM90 (wgmma on shared-memory
# tiles fed by an mbarrier ring; csrc/gather_mm_sm90.cuh, gather_dw.cu's
# gather_dw_sm90_kernel) or SM80 (Ampere-style: mma.sync behind a block barrier per
# stage);
# `conv_body` and `dw_body` choose per call.
SM90, SM80 = 1, 0
# the bf16 conv and dW launches by body, [SM80, SM90] (within LAUNCHES' counts)
BODY_LAUNCHES = {"gather_conv_bf16": [0, 0], "gather_dw_bf16": [0, 0]}
# gather_conv splits a tile's offsets over blocks (summed by a second launch)
# where its grid has at most _SPLIT_BLOCKS blocks: one block per
# _SPLIT_STAGES (offset, 32-column F_in chunk) stages, at most 4 blocks (3
# with 64-column slices).  Fewer, longer blocks leave a tail of a few busy
# SMs; larger grids fill the card without it.  Chosen from the sweep of
# `probe_kernels.py` over the EgoNN forward's and train step's call shapes.
_SPLIT_BLOCKS, _SPLIT_STAGES = 1280, 24
# The bf16 bodies split smaller grids (`probe_kernels.py bf16`): SM80 at most
# 512 blocks (on 32 clouds' L3-L5 its 2-3 groups are 9-35% slower than one,
# on 8 clouds' they still win), SM90 at most two blocks an SM (its 64-column
# blocks run one an SM; on 32 clouds' deep levels a split is up to 30%
# slower).
_BF16_SPLIT_BLOCKS, _SM90_SPLIT_BLOCKS = 512, 2 * 132
# kernel launches per wrapper (CUDA tensors only; the plain versions do not count)
LAUNCHES = {"zrun_presence": 0, "zrun_rank": 0, "gather_conv": 0, "tdown": 0, "gather_dw": 0,
            "lookup": 0, "gather_conv_bf16": 0, "tdown_bf16": 0, "gather_dw_bf16": 0,
            "stem_ones": 0, "tconv": 0, "slot_order": 0, "tconv_dw": 0}
# per CUDA device: zrun and lookup blocks whose table slice did not fit
# (`zrun_overflow_blocks`, `lookup_overflow_blocks`)
_ZRUN_OVERFLOW: dict = {}
_LOOKUP_OVERFLOW: dict = {}


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


def _is_bf16(feats: torch.Tensor) -> bool:
    """Whether conv or dW features take the bf16 kernels (f32: the
    split-TF32 ones); any other type raises."""
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feats: dtype {feats.dtype}, expected torch.float32 or torch.bfloat16")
    return feats.dtype == torch.bfloat16


def _bf16_transposed(kernel: torch.Tensor) -> torch.Tensor:
    """W^T (K, F_out, F_in), rounded to bf16 (to nearest even): the weights
    as the bf16 kernels read them."""
    out = torch.empty((kernel.shape[0], kernel.shape[2], kernel.shape[1]), dtype=torch.bfloat16,
                      device=kernel.device)
    return out.copy_(kernel.transpose(1, 2))


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise distance of two bf16 tensors in bf16 units in the last
    place (+0 and -0 equal): the bf16 kernels round the same f32 sums as
    their plain versions, summed in another order, so they are held within
    one."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(got) - ordered(want)).abs()


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


def _overflow(counters: dict, device: torch.device) -> torch.Tensor:
    device = _index_device(device)
    if device not in counters:
        counters[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return counters[device]


def _overflow_count(counters: dict, device) -> int:
    device = _index_device(device)
    return int(counters[device].item()) if device in counters else 0


def zrun_overflow_blocks(device) -> int:
    """zrun blocks on `device` whose table slice did not fit in shared memory
    (they searched the global table instead), since the first zrun launch
    there."""
    return _overflow_count(_ZRUN_OVERFLOW, device)


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
    overflow = _overflow(_ZRUN_OVERFLOW, q_lo.device)
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
    outside [0, C_in) gathers a zero row.

    bf16 feats: the bf16 kernels' (and the TPU kernel's) numerics: the
    kernel rounded to bf16, the f32 sums of the exact bf16 x bf16 products,
    the epilogue in f32, one rounding of the output to bf16."""
    if feats.dtype == torch.bfloat16:
        out = _gather_sum(feats.float(), kmap, kernel.to(torch.bfloat16).float())
        return _apply_epi(out, epi).to(torch.bfloat16)
    return _apply_epi(_gather_sum(feats, kmap, kernel), epi)


def _gather_sum(feats: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    b, c_in, f_in = feats.shape
    feats_p = torch.cat([feats, feats.new_zeros(b, 1, f_in)], dim=1)
    idx = torch.where((kmap >= 0) & (kmap < c_in), kmap, c_in).long()
    acc = feats.new_zeros(b, kmap.shape[2], kernel.shape[2], dtype=torch.float32)
    for k in range(kmap.shape[1]):
        g = torch.gather(feats_p, 1, idx[:, k, :, None].expand(-1, -1, f_in))
        acc = acc + torch.matmul(g, kernel[k])
    return acc


def _check_epi(epi, b: int, c_out: int, f_out: int):
    if epi is None:
        return None, None, 0, None
    scale, bias, relu, mask = epi
    _check(scale, "epi scale", torch.float32, (f_out,))
    _check(bias, "epi bias", torch.float32, (f_out,))
    _check(mask, "epi mask", torch.bool, (b, c_out))
    return scale, bias, int(bool(relu)), mask


def conv_widths_ok(f_in: int, f_out: int, bf16: bool = False) -> bool:
    """The widths gather_conv and tdown take: F_out a multiple of 32 up to
    512; F_in a multiple of 4 (`bf16` features: 8, a 16-byte row piece) up
    to 128, or a multiple of 32 up to 512."""
    m = 8 if bf16 else 4
    return (f_out % 32 == 0 and 32 <= f_out <= 512
            and ((f_in % m == 0 and m <= f_in <= 128) or (f_in % 32 == 0 and 32 <= f_in <= 512)))


def dw_widths_ok(f_in: int, f_out: int) -> bool:
    """The widths gather_dw takes: F_in and F_out multiples of 32 up to 512."""
    return all(f % 32 == 0 and 32 <= f <= 512 for f in (f_in, f_out))


def _check_widths(f_in: int, f_out: int, name: str, c_in: int, bf16: bool = False) -> None:
    if not conv_widths_ok(f_in, f_out, bf16):
        raise ValueError(f"{name}: F_in={f_in}, F_out={f_out}; the kernel takes F_out a "
                         f"multiple of 32 up to 512 and F_in a multiple of {8 if bf16 else 4} up "
                         "to 128 or of 32 up to 512")
    if c_in >= 1 << 24:  # the kernel packs (row, source) into one int
        raise ValueError(f"{name}: {c_in} input rows; the kernel takes fewer than 2^24")


class WidthPlan(NamedTuple):
    """How a wrapper runs a call of any width on a kernel: F_in and F_out
    zero-padded to `f_in` / `f_out`, then cut into launches over the
    [start, stop) ranges `in_chunks` x `out_chunks` of the padded widths."""
    f_in: int
    f_out: int
    in_chunks: Tuple[Tuple[int, int], ...]
    out_chunks: Tuple[Tuple[int, int], ...]


_MAX_WIDTH = 512  # the widest F_in / F_out chunk of one launch


def width_plan(f_in: int, f_out: int, dw: bool = False, bf16: bool = False) -> WidthPlan:
    """The launches of a call at widths (F_in, F_out).

    F_out is padded to a multiple of 32; F_in to a multiple of 4 (`bf16`
    features: 8) up to 128, else of 32 (gather_conv, tdown), or of 32
    (`dw`: gather_dw).  Widths
    above 512 are cut into chunks of 512 and a remainder: F_out chunks are
    separate columns of the output (of dW); F_in chunks of a conv are
    partial sums, added before the epilogue is applied once, and of dW
    separate rows (whole f32 sums, for bf16 features too).  Zero feature
    columns and zero weight rows / columns add nothing, so the plan is
    exact."""
    def up(f, m):
        return max(m, -(-f // m) * m)

    def chunks(f):
        return tuple((s, min(s + _MAX_WIDTH, f)) for s in range(0, f, _MAX_WIDTH))

    fi = up(f_in, 32) if dw or f_in > 128 else up(f_in, 8 if bf16 else 4)
    fo = up(f_out, 32)
    return WidthPlan(fi, fo, chunks(fi), chunks(fo))


def _pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def planned_conv(launch: Callable, feats: torch.Tensor, kernel: torch.Tensor,
                 epi: Optional[tuple], plan: WidthPlan) -> torch.Tensor:
    """`launch(feats, kernel, epi)` of a conv (gather_conv, tdown) run over
    `plan`: feats (..., F_in) and kernel (K, F_in, F_out) zero-padded, the
    epilogue's scale and bias zero-padded, one launch per (F_in chunk, F_out
    chunk), F_in chunks' outputs added in order and the epilogue applied to
    the sum, F_out chunks concatenated, the padding cut off.  A plan of one
    chunk at the given widths is one launch on the inputs as they are."""
    f_in, f_out = kernel.shape[1], kernel.shape[2]
    feats = _pad_last(feats, plan.f_in)
    if (plan.f_in, plan.f_out) != (f_in, f_out):
        kernel = F.pad(kernel, (0, plan.f_out - f_out, 0, plan.f_in - f_in))
    if epi is not None:
        epi = (_pad_last(epi[0], plan.f_out), _pad_last(epi[1], plan.f_out), epi[2], epi[3])
    split_in = len(plan.in_chunks) > 1
    if split_in and feats.dtype == torch.bfloat16:
        # the partial sums would be rounded to bf16 before they are added
        raise ValueError(f"bf16 features: F_in={f_in}; the bf16 kernels take F_in up to "
                         f"{_MAX_WIDTH}")
    feats_in = [feats[..., i0:i1].contiguous() if split_in else feats
                for i0, i1 in plan.in_chunks]
    cols = []
    for o0, o1 in plan.out_chunks:
        w = kernel[..., o0:o1] if len(plan.out_chunks) > 1 else kernel
        e = None if epi is None else (epi[0][o0:o1], epi[1][o0:o1], epi[2], epi[3])
        if not split_in:
            cols.append(launch(feats_in[0], w.contiguous(), e))
            continue
        acc = None
        for f, (i0, i1) in zip(feats_in, plan.in_chunks):
            part = launch(f, w[:, i0:i1].contiguous(), None)
            acc = part if acc is None else acc + part
        cols.append(_apply_epi(acc, e))
    out = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return out if plan.f_out == f_out else out[..., :f_out].contiguous()


def planned_dw(launch: Callable, feats: torch.Tensor, g: torch.Tensor, k_vol: int,
               plan: WidthPlan) -> torch.Tensor:
    """`launch(feats, g)` of gather_dw run over `plan`: feats (B, C_in, F_in)
    and g (B, C_out, F_out) zero-padded, one launch per (F_in chunk, F_out
    chunk), each an independent f32 block of dW; the padding cut off."""
    f_in, f_out = feats.shape[2], g.shape[2]
    feats, g = _pad_last(feats, plan.f_in), _pad_last(g, plan.f_out)
    if len(plan.in_chunks) == 1 and len(plan.out_chunks) == 1:
        out = launch(feats, g)
    else:
        out = torch.empty((k_vol, plan.f_in, plan.f_out), dtype=torch.float32,
                          device=feats.device)
        for i0, i1 in plan.in_chunks:
            f = feats[..., i0:i1].contiguous()
            for o0, o1 in plan.out_chunks:
                out[:, i0:i1, o0:o1] = launch(f, g[..., o0:o1].contiguous())
    if (plan.f_in, plan.f_out) == (f_in, f_out):
        return out
    return out[:, :f_in, :f_out].contiguous()


def conv_cols(b: int, c_out: int, f_out: int, k_vol: int, body: int = SM80) -> int:
    """The output columns of a gather_conv block: the SM90 bf16 body takes
    64 where F_out allows (each block gathers its rows once for all its
    columns), else 32; the SM80 and f32 bodies 32 or 64.  64 halve the
    blocks that gather each row and stage W[k]; on an H100 they win for the
    self convs (K >= 27) where the 64-column grid keeps >= 256 blocks, and
    on the ResNet-width calls (256 and 512 columns, K 27 and 8), and lose on
    the EgoNN down convs (K = 8) and the deep levels' small grids
    (`probe_kernels.py`)."""
    if body == SM90:
        return 64 if f_out % 64 == 0 else 32
    if f_out % 64:
        return 32
    blocks = b * -(-c_out // 128) * (f_out // 64)
    return 64 if f_out >= 256 or (k_vol >= 27 and blocks >= 256) else 32


def offset_groups(b: int, c_out: int, f_in: int, f_out: int, k_vol: int,
                  body: int = SM80, bf16: bool = False) -> int:
    """How many blocks share one output tile of gather_conv, each summing a
    contiguous range of the offsets.  Stages are counted in 32 F_in
    columns (the f32 kernel's) for bf16 features too: on an H100 this picks
    the bf16 kernel's fastest split, or within 11% of it, at every call of
    the bf16 forward, where counting its own 64-column stages splits too
    little (up to 38% slower at the deep levels; `probe_kernels.py`).  The
    bf16 bodies split only smaller grids (_BF16_SPLIT_BLOCKS,
    _SM90_SPLIT_BLOCKS)."""
    cols = conv_cols(b, c_out, f_out, k_vol, body)
    limit = (_SM90_SPLIT_BLOCKS if body == SM90 else _BF16_SPLIT_BLOCKS if bf16
             else _SPLIT_BLOCKS)
    if b * -(-c_out // 128) * (f_out // cols) > limit:
        return 1
    stages = k_vol * -(-f_in // 32)
    return max(1, min(3 if cols == 64 else 4, k_vol, stages // _SPLIT_STAGES))


# The capacity at or below which `conv_body` takes the SM90 conv body: EgoNN's
# L5-L7 at cap0 16384 (1664, 1408, 1024 rows), where under 6% of the map
# entries are valid
_SM90_CONV_MAX_ROWS = 1664


def conv_body(b: int, c_out: int, f_in: int, f_out: int, k_vol: int) -> int:
    """The bf16 gather_conv body of a call, from `probe_kernels.py bf16` on an
    H100 (PERF.md).  SM90 (stages packed with valid rows across offsets)
    where a tile's offsets carry few valid rows each, so that SM80's barrier
    and round trip per offset stage dominate: the sparse deep levels; and
    the 32-wide self convs (K >= 27), whose two blocks an SM keep more rows
    in flight.  SM80 on the rest, where a stage is full either way and
    SM90's one block an SM (64-column slices) waits out each tile's map
    compaction and pipeline fill.  What decides is the maps' density, which
    a wrapper cannot read without a device sync: C_out stands in for it,
    fitted to EgoNN's pyramid at cap0 16384 (the forward and train step's
    calls); the probe also times MinkLoc's convs in bf16 (the 32-wide one
    wins on SM90, the 64-wide ones within 14% on SM80) and ResNet-width
    calls (within 7% either way)."""
    if c_out <= _SM90_CONV_MAX_ROWS or (f_in == 32 and f_out == 32 and k_vol >= 27):
        return SM90
    return SM80


def _gather_conv_cuda(feats, kmap, kernel, epi):
    """One gather_conv launch at widths the kernel takes: f32 features on
    the split-TF32 kernel, bf16 features on the bf16 body `conv_body` picks."""
    b, c_in, f_in = feats.shape
    k_vol, _, f_out = kernel.shape
    c_out = kmap.shape[2]
    bf16 = _is_bf16(feats)
    _check_widths(f_in, f_out, "gather_conv", c_in, bf16)
    _check(feats, "feats", feats.dtype, (b, c_in, f_in), align16=True)
    _check(kmap, "kmap", torch.int32, (b, k_vol, c_out))
    _check(kernel, "kernel", torch.float32, (k_vol, f_in, f_out), align16=True)
    scale, bias, relu, mask = _check_epi(epi, b, c_out, f_out)
    out = torch.empty((b, c_out, f_out), dtype=feats.dtype, device=feats.device)
    body = conv_body(b, c_out, f_in, f_out, k_vol) if bf16 else SM80
    cols = conv_cols(b, c_out, f_out, k_vol, body)
    n_groups = offset_groups(b, c_out, f_in, f_out, k_vol, body, bf16)
    partial = (torch.empty((n_groups, b, c_out, f_out), dtype=torch.float32, device=feats.device)
               if n_groups > 1 else None)
    name = "gather_conv_bf16" if bf16 else "gather_conv"
    w = _bf16_transposed(kernel) if bf16 else kernel
    fn = cuda_lib.function("gather_conv.cu", f"egonn_{name}")
    err = fn(feats.data_ptr(), kmap.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(bias),
             _ptr(mask), out.data_ptr(), _ptr(partial), n_groups, b, c_in, f_in, k_vol, c_out,
             f_out, cols, relu, *((body,) if bf16 else ()), _stream(feats))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    if bf16:
        BODY_LAUNCHES[name][body] += 1
    return out


def gather_conv(feats: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor,
                epi: Optional[tuple] = None) -> torch.Tensor:
    """Sparse conv over a gather map with the optional fused epilogue.

    feats (B, C_in, F_in) f32 or bf16; kmap (B, K, C_out) int32 (sentinel
    C_in); kernel (K, F_in, F_out) f32.  Returns (B, C_out, F_out) in the
    features' type.  Any widths: on the card through `width_plan`'s
    launches."""
    tensors = [feats, kmap, kernel] + ([epi[0], epi[1], epi[3]] if epi else [])
    if not _on_cuda(*tensors):
        return gather_conv_plain(feats, kmap, kernel, epi)
    if feats.dim() != 3 or kernel.dim() != 3 or feats.shape[2] != kernel.shape[1]:
        raise ValueError(f"feats {tuple(feats.shape)} and kernel {tuple(kernel.shape)}: "
                         "expected (B, C_in, F_in) and (K, F_in, F_out)")
    plan = width_plan(kernel.shape[1], kernel.shape[2], bf16=_is_bf16(feats))
    return planned_conv(lambda f, w, e: _gather_conv_cuda(f, kmap, w, e), feats, kernel, epi,
                        plan)


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
    all of w and its hull's rows at once.  The bf16 bodies take the same
    rule: within 5 us of the fastest tiling at every bf16 forward call,
    where tilings that fit only in bf16 ((64, 128), (128, 128)) win by up to
    5 us."""
    if f_in <= 64 or b * c_fine >= 49152:
        return 128, 0, True
    return 32, 128, False


def tdown_tiling_ok(f_in: int, f_out: int, rows: int, rc: int, gather: bool = False,
                    bf16: bool = False) -> bool:
    """Whether the tdown kernel takes this tiling: the gathering body with
    128-row tiles, or the streaming body with 32, 64 or 128 rows and row
    chunks, all of which fit a block's shared memory but, in f32, chunks of
    128 rows beside more than 32 rows above 64 F_in columns (the bf16 body's
    w and rows take half the bytes: every tiling fits); F_out a multiple of
    the 32-column slice."""
    if f_out % 32:
        return False
    if gather:
        return rows == 128
    return (rows in (32, 64, 128) and rc in (32, 64, 128)
            and (bf16 or not (f_in > 64 and rc == 128 and rows > 32)))


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
    """One tdown call (hull launch + body) at widths and a tiling the kernel
    takes: f32 features on the split-TF32 bodies, bf16 on the bf16 ones."""
    b, c_fine, f_in = feats.shape
    f_out = kernel.shape[2]
    bf16 = _is_bf16(feats)
    _check_widths(f_in, f_out, "tdown", c_fine, bf16)
    if not tdown_tiling_ok(f_in, f_out, rows, rc, gather, bf16):
        raise ValueError(f"tdown: {rows}-row tiles, {rc}-row stages at F_in={f_in}; "
                         "see tdown_tiling_ok")
    _check(feats, "feats", feats.dtype, (b, c_fine, f_in), align16=True)
    _check(up_parent, "up_parent", torch.int32, (b, c_fine))
    _check(up_koffset, "up_koffset", torch.int32, (b, c_fine))
    _check(kernel, "kernel", torch.float32, (8, f_in, f_out), align16=True)
    scale, bias, relu, mask = _check_epi(epi, b, c_coarse, f_out)
    hull = torch.empty((b, -(-c_coarse // rows), 2), dtype=torch.int32, device=feats.device)
    out = torch.empty((b, c_coarse, f_out), dtype=feats.dtype, device=feats.device)
    name = "tdown_bf16" if bf16 else "tdown"
    w = _bf16_transposed(kernel) if bf16 else kernel
    fn = cuda_lib.function("tdown.cu", f"egonn_{name}")
    err = fn(feats.data_ptr(), up_parent.data_ptr(), up_koffset.data_ptr(), w.data_ptr(),
             _ptr(scale), _ptr(bias), _ptr(mask), hull.data_ptr(), out.data_ptr(),
             b, c_fine, f_in, c_coarse, f_out, rows, rc, int(gather), relu, _stream(feats))
    _raise_on(err, name)
    return out


def tdown(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
          kernel: torch.Tensor, c_coarse: int, epi: Optional[tuple] = None) -> torch.Tensor:
    """k=2 s=2 down conv driven by the fine level's up map.

    feats (B, C_fine, F_in) f32 or bf16; up_parent/up_koffset (B, C_fine)
    int32; kernel (8, F_in, F_out) f32.  Returns (B, c_coarse, F_out) in the
    features' type.  Any widths: on the card through `width_plan`'s
    launches."""
    tensors = [feats, up_parent, up_koffset, kernel] + ([epi[0], epi[1], epi[3]] if epi else [])
    if not _on_cuda(*tensors):
        return tdown_plain(feats, up_parent, up_koffset, kernel, c_coarse, epi)
    if feats.dim() != 3 or kernel.dim() != 3 or feats.shape[2] != kernel.shape[1]:
        raise ValueError(f"feats {tuple(feats.shape)} and kernel {tuple(kernel.shape)}: "
                         "expected (B, C_fine, F_in) and (8, F_in, F_out)")

    bf16 = _is_bf16(feats)

    def launch(f, w, e):
        out = _tdown_cuda(f, up_parent, up_koffset, w, c_coarse, e, *tdown_tiling(*f.shape))
        LAUNCHES["tdown_bf16" if bf16 else "tdown"] += 1
        return out
    return planned_conv(launch, feats, kernel, epi,
                        width_plan(kernel.shape[1], kernel.shape[2], bf16=bf16))


# ---------------------------------------------------------------------------
# conv weight gradient
# ---------------------------------------------------------------------------

def gather_dw_plain(feats: torch.Tensor, kmap: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW[k] = sum_b sum_o feats[b, kmap[b, k, o]]^T g[b, o]: a gather per
    offset, then one contraction over the batch and the rows (the JAX
    package's `_conv_dkernel_gather`); an index outside [0, C_in) gathers a
    zero row.

    bf16 feats: the bf16 kernel's (and the TPU kernel's) numerics: g rounded
    to bf16, the exact products of the bf16 values summed in f32, dW f32
    (`_conv_dkernel_gather` on bf16 inputs)."""
    if feats.dtype == torch.bfloat16:
        return gather_dw_plain(feats.float(), kmap, g.to(torch.bfloat16).float())
    b, c_in, f_in = feats.shape
    feats_p = torch.cat([feats, feats.new_zeros(b, 1, f_in)], dim=1)
    idx = torch.where((kmap >= 0) & (kmap < c_in), kmap, c_in).long()
    out = feats.new_empty(kmap.shape[1], f_in, g.shape[2])
    for k in range(kmap.shape[1]):
        gth = torch.gather(feats_p, 1, idx[:, k, :, None].expand(-1, -1, f_in))
        out[k] = torch.einsum("bcf,bco->fo", gth, g)
    return out


def dw_tiling(b: int, c_out: int, f_in: int, f_out: int, k_vol: int, body: int = SM80):
    """(mb, nb, n_chunks) of gather_dw's partial pass: a block owns an
    mb x nb slice of one dW[k] (64 where the width allows, else 32) over one
    of n_chunks strided chunks of the 64-row tiles, ~_DW_BLOCKS blocks in
    all (the SM90 body: ~_DW_SM90_BLOCKS)."""
    mb, nb = (64 if f % 64 == 0 else 32 for f in (f_in, f_out))
    blocks = k_vol * (f_in // mb) * (f_out // nb)
    if body == SM90:  # one wave of resident blocks
        return mb, nb, max(1, min(b * -(-c_out // 64), _DW_SM90_BLOCKS // blocks))
    return mb, nb, max(1, min(b * -(-c_out // 64), -(-_DW_BLOCKS // blocks)))


def dw_body(b: int, c_out: int, f_in: int, f_out: int, k_vol: int) -> int:
    """The bf16 gather_dw body of a call, from `probe_kernels.py bf16` on an
    H100 (PERF.md): SM90 (stages of 64 queued valid rows, wgmma)
    except for 32-wide features at K >= 27 (L1-L2's self convs), where its
    64-wide tiles are half empty and SM80's 8 blocks an SM keep more rows
    in flight."""
    return SM80 if f_in <= 32 and k_vol >= 27 else SM90


def _gather_dw_cuda(feats, kmap, g):
    """One gather_dw launch at widths the kernel takes: f32 features and g on
    the split-TF32 kernel, bf16 ones on the bf16 kernel; dW f32."""
    b, c_in, f_in = feats.shape
    k_vol, c_out = kmap.shape[1], kmap.shape[2]
    f_out = g.shape[2]
    if not dw_widths_ok(f_in, f_out):
        raise ValueError(f"gather_dw: F_in={f_in}, F_out={f_out}; the kernel takes widths "
                         "that are multiples of 32 up to 512")
    bf16 = _is_bf16(feats)
    name = "gather_dw_bf16" if bf16 else "gather_dw"
    _check(feats, "feats", feats.dtype, (b, c_in, f_in), align16=True)
    _check(kmap, "kmap", torch.int32, (b, k_vol, c_out))
    _check(g, "g", feats.dtype, (b, c_out, f_out), align16=True)
    body = dw_body(b, c_out, f_in, f_out, k_vol) if bf16 else SM80
    mb, nb, n_chunks = dw_tiling(b, c_out, f_in, f_out, k_vol, body)
    partial = torch.empty((n_chunks, k_vol, f_in, f_out), dtype=torch.float32,
                          device=feats.device)
    out = torch.empty((k_vol, f_in, f_out), dtype=torch.float32, device=feats.device)
    fn = cuda_lib.function("gather_dw.cu", f"egonn_{name}")
    err = fn(feats.data_ptr(), kmap.data_ptr(), g.data_ptr(), partial.data_ptr(),
             out.data_ptr(), b, c_in, f_in, k_vol, c_out, f_out, mb, nb, n_chunks,
             *((body,) if bf16 else ()), _stream(feats))
    _raise_on(err, name)
    LAUNCHES[name] += 1
    if bf16:
        BODY_LAUNCHES[name][body] += 1
    return out


def gather_dw(feats: torch.Tensor, kmap: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of `gather_conv(feats, kmap, W)` for the cotangent g.

    feats (B, C_in, F_in) f32 or bf16; kmap (B, K, C_out) int32 (sentinel
    C_in); g (B, C_out, F_out) in the features' type (with bf16 features an
    f32 g is rounded to bf16, as the TPU kernel rounds it).  Returns
    (K, F_in, F_out) f32.  Any widths: on the card through
    `width_plan(dw=True)`'s launches."""
    if not _on_cuda(feats, kmap, g):
        return gather_dw_plain(feats, kmap, g)
    if feats.dim() != 3 or g.dim() != 3 or kmap.dim() != 3:
        raise ValueError(f"feats {tuple(feats.shape)}, kmap {tuple(kmap.shape)}, g "
                         f"{tuple(g.shape)}: expected 3-D")
    if _is_bf16(feats):
        g = g.to(torch.bfloat16)
    return planned_dw(lambda f, gg: _gather_dw_cuda(f, kmap, gg), feats, g, kmap.shape[1],
                      width_plan(feats.shape[2], g.shape[2], dw=True))


# ---------------------------------------------------------------------------
# sorted-key lookup
# ---------------------------------------------------------------------------

def lookup_plain(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the lookup kernel: `packing.lookup_sorted` per cloud
    with the sentinel C_in."""
    return lookup_sorted(sorted_keys, queries, sentinel=sorted_keys.shape[1])


def down_queries(coarse_keys: torch.Tensor, coarse_pack: PackSpec, fine_pack: PackSpec
                 ) -> torch.Tensor:
    """(B, 8, C) child keys of a sorted coarse level's voxels under the fine
    level's packing, MAXKEY for padding: `kmap_queries` with k = s = 2 on
    the level's coords, which the dedup chain makes `unpack_keys(keys)`
    where the key is valid."""
    mask = coarse_keys != MAXKEY
    coords = torch.where(mask[:, None, :], unpack_keys(coarse_keys, coarse_pack), 0)
    return kmap_queries(coords.to(torch.int32), mask, 2, 2, fine_pack)


def lookup_down_plain(keys: Sequence[torch.Tensor], packs: Sequence[PackSpec],
                      levels: Sequence[int]) -> List[torch.Tensor]:
    """Plain version of `lookup_down`: for each level l, the down queries
    of keys[l] looked up in keys[l - 1]."""
    return [lookup_plain(keys[l - 1], down_queries(keys[l], packs[l], packs[l - 1]))
            for l in levels]


# lookup: output rows of a block's tile, and the most table rows it copies
# into shared memory (larger runs search the global table).  On an H100,
# 256 x 4096 is the fastest of 32-256 rows x 1024-8192 slice rows on the
# lookup-built levels of the EgoNN, MinkLoc and ResNet pyramids, or within
# 1 us of it (`probe_kernels.py`): fewer, fuller blocks hide the probe and
# slice round trips (32 rows take 1.4-1.6x as long); 1,024-row slices
# overflow at 256 rows.
_LOOKUP_ROWS, _LOOKUP_SLICE = 256, 4096
_LOOKUP_MAX_LEVELS, _LOOKUP_TILE = 16, 2048  # levels of one launch; K x rows of a tile


def lookup_rows(k: int) -> int:
    """Output rows of a lookup block's tile for K offsets: 256, fewer where
    K x 256 exceeds the 2,048 queries a block holds in registers."""
    if not 1 <= k <= _LOOKUP_TILE:
        raise ValueError(f"lookup: K={k}; the kernel takes 1 <= K <= {_LOOKUP_TILE}")
    return min(_LOOKUP_ROWS, _LOOKUP_TILE // k)


def lookup_overflow_blocks(device) -> int:
    """lookup blocks on `device` whose table run did not fit in shared memory
    (they searched the global table instead), since the first lookup launch
    there."""
    return _overflow_count(_LOOKUP_OVERFLOW, device)


def _lookup_cuda(tables: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor],
                 ks: Sequence[int], packs: Optional[Sequence[Tuple[PackSpec, PackSpec]]],
                 rows: Optional[int] = None, slice_cap: int = _LOOKUP_SLICE
                 ) -> List[torch.Tensor]:
    """One launch of the lookup kernel over several levels: level i looks up
    the queries srcs[i] (B, K, C_out), or with `packs` the children of the
    coarse keys srcs[i] (B, C_out) under packs[i] = (coarse, fine), in the
    sorted keys tables[i] (B, C_in).  Returns each level's (B, K, C_out).
    `rows` (default `lookup_rows`) and `slice_cap` set the tiling."""
    n = len(tables)
    if not 1 <= n <= _LOOKUP_MAX_LEVELS:
        raise ValueError(f"lookup: {n} levels; one launch takes 1 to {_LOOKUP_MAX_LEVELS}")
    rows = rows or lookup_rows(max(ks))
    b = tables[0].shape[0]
    c_outs = []
    for t, q, k in zip(tables, srcs, ks):
        if t.dim() != 2 or t.shape[0] != b:
            raise ValueError(f"sorted_keys: shape {tuple(t.shape)}, expected (B={b}, C_in)")
        _check(t, "sorted_keys", torch.int32, t.shape)
        want = (b, q.shape[-1]) if packs else (b, k, q.shape[-1])
        if q.dim() != len(want) or q.shape[0] != b:
            raise ValueError(f"queries: shape {tuple(q.shape)}, expected {want}")
        _check(q, "queries", torch.int32, want)
        c_outs.append(q.shape[-1])
    sizes = [b * k * c for k, c in zip(ks, c_outs)]
    flat = torch.empty(sum(sizes), dtype=torch.int32, device=tables[0].device)
    outs = [part.view(b, k, c) for part, k, c in zip(flat.split(sizes), ks, c_outs)]
    pack_ints = [0] * (12 * n)
    for i, (coarse, fine) in enumerate(packs or ()):
        pack_ints[12 * i:12 * i + 12] = [*coarse.bits, *coarse.offsets, *fine.bits,
                                         *fine.offsets]
    ptrs, ints = ctypes.c_void_p * n, ctypes.c_int * n
    fn = cuda_lib.function("lookup.cu", "egonn_lookup")
    err = fn(ptrs(*[t.data_ptr() for t in tables]), ptrs(*[q.data_ptr() for q in srcs]),
             ptrs(*[o.data_ptr() for o in outs]), ints(*[t.shape[1] for t in tables]),
             ints(*c_outs), ints(*ks), (ctypes.c_int * (12 * n))(*pack_ints), n, b, rows,
             slice_cap, int(packs is not None),
             _overflow(_LOOKUP_OVERFLOW, tables[0].device).data_ptr(), _stream(tables[0]))
    _raise_on(err, "lookup")
    return outs


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Position of each query key in its cloud's sorted key table.

    sorted_keys (B, C_in) int32 (unique keys, MAXKEY padded); queries
    (B, K, C_out) int32 (MAXKEY invalid).  Returns (B, K, C_out) int32
    positions, C_in where the key is absent or the query invalid."""
    if not _on_cuda(sorted_keys, queries):
        return lookup_plain(sorted_keys, queries)
    if queries.dim() != 3:
        raise ValueError(f"queries: shape {tuple(queries.shape)}, expected (B, K, C_out)")
    pos = _lookup_cuda([sorted_keys], [queries], [queries.shape[1]], None)[0]
    LAUNCHES["lookup"] += 1
    return pos


def lookup_down(keys: Sequence[torch.Tensor], packs: Sequence[PackSpec],
                levels: Sequence[int]) -> List[torch.Tensor]:
    """The k=2 s=2 down maps of `levels`, in one launch of the lookup kernel.

    keys[l] (B, C_l) int32: level l's sorted keys (MAXKEY padded), packed
    under packs[l].  For each l in `levels` (>= 1) returns the (B, 8, C_l)
    positions in keys[l - 1] of the 8 children 2 * coord + d of each voxel
    (C order over (dx, dy, dz), dz fastest), C_{l-1} where the child is
    absent, out of range or the voxel padding: `lookup_down_plain`, with the
    queries formed in the kernel."""
    levels = list(levels)
    if not levels:
        return []
    if not _on_cuda(*[keys[l] for l in levels], *[keys[l - 1] for l in levels]):
        return lookup_down_plain(keys, packs, levels)
    if min(levels) < 1:
        raise ValueError(f"levels {levels}: a down map needs a finer level")
    outs = _lookup_cuda([keys[l - 1] for l in levels], [keys[l] for l in levels],
                        [8] * len(levels), [(packs[l], packs[l - 1]) for l in levels])
    LAUNCHES["lookup"] += 1
    return outs


# ---------------------------------------------------------------------------
# the stem over constant-ones features
# ---------------------------------------------------------------------------

# stem_ones: output columns of a block (one a thread)
_STEM_THREADS, _STEM_MAX_K = 256, 343


def stem_ones_plain(kmap: torch.Tensor, kernel: torch.Tensor, n_in_rows: int) -> torch.Tensor:
    """Plain version of `stem_ones`: the 0/1 map of the entries below
    n_in_rows, in the kernel's type, times kernel[:, 0, :] (the JAX
    package's form)."""
    valid = (kmap < n_in_rows).to(kernel.dtype)  # (B, K, C_out)
    return torch.matmul(valid.transpose(1, 2), kernel[:, 0, :])


def _stem_ones_cuda(kmap, kernel, n_in_rows, threads=_STEM_THREADS):
    b, k_vol, c_out = kmap.shape
    f_out = kernel.shape[2]
    if not (1 <= k_vol <= _STEM_MAX_K and f_out >= 4 and f_out % 4 == 0):
        raise ValueError(f"stem_ones: K={k_vol}, F_out={f_out}; the kernel takes "
                         f"K <= {_STEM_MAX_K} and F_out a multiple of 4")
    _check(kmap, "kmap", torch.int32, (b, k_vol, c_out))
    _check(kernel, "kernel", torch.float32, (k_vol, 1, f_out), align16=True)
    out = torch.empty((b, c_out, f_out), dtype=torch.float32, device=kmap.device)
    fn = cuda_lib.function("stem.cu", "egonn_stem_ones")
    _raise_on(fn(kmap.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, k_vol, c_out, f_out,
                 n_in_rows, threads, _stream(kmap)), "stem_ones")
    return out


def stem_ones(kmap: torch.Tensor, kernel: torch.Tensor, n_in_rows: int) -> torch.Tensor:
    """The stem conv over constant-ones features: out[b, c] = sum_k
    [kmap[b, k, c] < n_in_rows] kernel[k, 0, :], summed in f32 over the
    offsets in order.

    kmap (B, K, C_out) int32, kernel (K, 1, F_out) f32; out (B, C_out, F_out)
    f32.  On the card K <= 343 and F_out a multiple of 4."""
    if not _on_cuda(kmap, kernel):
        return stem_ones_plain(kmap, kernel, n_in_rows)
    out = _stem_ones_cuda(kmap, kernel, n_in_rows)
    LAUNCHES["stem_ones"] += 1
    return out


# ---------------------------------------------------------------------------
# the transposed k=2 s=2 conv
# ---------------------------------------------------------------------------

_TCONV_SEGMENTS = 9  # slots 0..7, then the fine rows without a parent


class SlotOrder(NamedTuple):
    """Each cloud's fine rows ordered by their slot in the up map:
    `order` (B, C_fine) int32 holds the rows of slot 0 in ascending order,
    then slot 1's, ..., slot 7's, then the rows without a parent (sentinel
    parents and padding rows); `seg` (B, 10) int32 the bounds, segment s
    being order[b, seg[b, s]:seg[b, s + 1]]."""
    order: torch.Tensor
    seg: torch.Tensor


def slot_order_plain(up_parent: torch.Tensor, up_koffset: torch.Tensor, c_coarse: int
                     ) -> SlotOrder:
    """Plain version of `slot_order`: a stable torch sort of the keys (the
    slot, 8 for no parent) and the bounds searched in the sorted keys."""
    valid = (up_parent >= 0) & (up_parent < c_coarse) & (up_koffset >= 0) & (up_koffset < 8)
    key = torch.where(valid, up_koffset, _TCONV_SEGMENTS - 1)
    sorted_key, order = torch.sort(key, dim=1, stable=True)
    bounds = torch.arange(_TCONV_SEGMENTS + 1, dtype=key.dtype, device=key.device)
    seg = torch.searchsorted(sorted_key, bounds.expand(key.shape[0], -1).contiguous(),
                             out_int32=True)
    return SlotOrder(order.to(torch.int32), seg)


def slot_order(up_parent: torch.Tensor, up_koffset: torch.Tensor, c_coarse: int) -> SlotOrder:
    """The `SlotOrder` of an up map (up_parent, up_koffset (B, C_fine) int32;
    a parent outside [0, c_coarse) or a slot outside [0, 8) counts as no
    parent): on the card one launch of a counting sort (`csrc/tconv.cu`),
    without a host sync.  The pyramid keeps it per level
    (`sparse/conv.py::level_slots`)."""
    if not _on_cuda(up_parent, up_koffset):
        return slot_order_plain(up_parent, up_koffset, c_coarse)
    b, c_fine = up_parent.shape
    _check(up_parent, "up_parent", torch.int32, (b, c_fine))
    _check(up_koffset, "up_koffset", torch.int32, (b, c_fine))
    order = torch.empty((b, c_fine), dtype=torch.int32, device=up_parent.device)
    seg = torch.empty((b, _TCONV_SEGMENTS + 1), dtype=torch.int32, device=up_parent.device)
    fn = cuda_lib.function("tconv.cu", "egonn_slot_order")
    _raise_on(fn(up_parent.data_ptr(), up_koffset.data_ptr(), order.data_ptr(), seg.data_ptr(),
                 b, c_coarse, c_fine, _stream(up_parent)), "slot_order")
    LAUNCHES["slot_order"] += 1
    return SlotOrder(order, seg)


def tconv_plain(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
                kernel: torch.Tensor) -> torch.Tensor:
    """Plain version of `tconv` (the JAX package's form): every fine row's
    parent (a zero row for the sentinel) times all 8 slots' kernels in one
    product, of which each row keeps its own slot's; in the kernel's type,
    returned in the features' (bf16 features: the f32 products of the bf16
    values, rounded once)."""
    b, c_coarse, f_in = feats.shape
    n_slots, _, f_out = kernel.shape
    feats_p = torch.cat([feats, feats.new_zeros(b, 1, f_in)], dim=1)
    g = torch.gather(feats_p, 1, up_parent.long()[..., None].expand(-1, -1, f_in))
    all_slots = torch.matmul(g.to(kernel.dtype),
                             kernel.permute(1, 0, 2).reshape(f_in, n_slots * f_out))
    all_slots = all_slots.reshape(b, -1, n_slots, f_out)
    slot = up_koffset.long()[..., None, None].expand(-1, -1, 1, f_out)
    return torch.gather(all_slots, 2, slot)[:, :, 0, :].to(feats.dtype)


def tconv_cols(f_out: int) -> int:
    """The output columns of a tconv block: 64 where F_out allows (each
    block gathers its rows once for all its columns), else 32."""
    return 64 if f_out % 64 == 0 else 32


def _tconv_cuda(feats, up_parent, kernel, slots: SlotOrder, cols: Optional[int] = None):
    """One tconv launch at widths the kernel takes (F_in a multiple of 4,
    F_out of 32); `cols` the column slice (None: `tconv_cols`'s)."""
    b, c_coarse, f_in = feats.shape
    c_fine, f_out = up_parent.shape[1], kernel.shape[2]
    cols = tconv_cols(f_out) if cols is None else cols
    if f_in % 4 or f_out % 32:
        raise ValueError(f"tconv: F_in={f_in}, F_out={f_out}; the kernel takes F_in a multiple "
                         "of 4 and F_out of 32")
    if feats.dtype != torch.float32:
        raise TypeError(f"tconv: feats {feats.dtype}; the kernel takes f32 features (bf16 "
                        "activations keep the all-slot product, sparse/conv.py)")
    _check(feats, "feats", torch.float32, (b, c_coarse, f_in), align16=True)
    _check(up_parent, "up_parent", torch.int32, (b, c_fine))
    _check(slots.order, "order", torch.int32, (b, c_fine))
    _check(slots.seg, "seg", torch.int32, (b, _TCONV_SEGMENTS + 1))
    _check(kernel, "kernel", torch.float32, (8, f_in, f_out), align16=True)
    out = torch.empty((b, c_fine, f_out), dtype=torch.float32, device=feats.device)
    fn = cuda_lib.function("tconv.cu", "egonn_tconv")
    _raise_on(fn(feats.data_ptr(), up_parent.data_ptr(), slots.order.data_ptr(),
                 slots.seg.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, c_coarse, c_fine,
                 f_in, f_out, cols, _stream(feats)), "tconv")
    return out


def tconv(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
          kernel: torch.Tensor, slots: Optional[SlotOrder] = None) -> torch.Tensor:
    """Transposed k=2 s=2 conv from level l+1 onto level l's coordinates:
    out[b, i] = feats[b, up_parent[b, i]] @ kernel[up_koffset[b, i]], zero
    where i has no parent.

    feats (B, C_coarse, F_in) f32; up_parent, up_koffset (B, C_fine) int32;
    kernel (8, F_in, F_out) f32; `slots` the up map's `slot_order` (None:
    built here).  Returns (B, C_fine, F_out) f32.  Any widths: on the card
    through `width_plan`'s launches."""
    if not _on_cuda(feats, up_parent, up_koffset, kernel):
        return tconv_plain(feats, up_parent, up_koffset, kernel)
    if feats.dim() != 3 or kernel.dim() != 3 or kernel.shape[0] != 8 or \
            feats.shape[2] != kernel.shape[1]:
        raise ValueError(f"feats {tuple(feats.shape)} and kernel {tuple(kernel.shape)}: "
                         "expected (B, C_coarse, F_in) and (8, F_in, F_out)")
    if slots is None:
        slots = slot_order(up_parent, up_koffset, feats.shape[1])

    def launch(f, w, e):
        out = _tconv_cuda(f, up_parent, w, slots)
        LAUNCHES["tconv"] += 1
        return out
    return planned_conv(launch, feats, kernel, None, width_plan(kernel.shape[1], kernel.shape[2]))


def tconv_dw_plain(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Plain version of `tconv_dw` (the JAX package's form): every fine
    row's parent gathered (a zero row for the sentinel), then per slot k one
    product over every row of the parents masked to slot k and g, in f32
    (bf16 features and g: the exact products of the bf16 values)."""
    b, _, f_in = feats.shape
    feats_p = torch.cat([feats, feats.new_zeros(b, 1, f_in)], dim=1)
    gathered = torch.gather(feats_p, 1, up_parent.long()[..., None].expand(-1, -1, f_in)).float()
    g32 = g.float()
    return torch.stack([torch.einsum("bcf,bco->fo", gathered * (up_koffset == k)[..., None], g32)
                        for k in range(8)])


def tconv_dw_tiling(b: int, c_fine: int, f_in: int, f_out: int):
    """(mb, nb, n_chunks) of tconv_dw's partial pass: a block owns an mb x nb
    slice of one dW[k] (64 where the width allows, else 32) over one of
    n_chunks strided chunks of the slot's 64-row tiles, ~_DW_BLOCKS blocks
    in all, and no more chunks than a slot's tiles if every fine row had a
    parent and the slots were even (the host reads no segment size)."""
    mb, nb = (64 if f % 64 == 0 else 32 for f in (f_in, f_out))
    blocks = 8 * (f_in // mb) * (f_out // nb)
    return mb, nb, max(1, min(-(-b * c_fine // (8 * 64)), -(-_DW_BLOCKS // blocks)))


def _tconv_dw_cuda(feats, up_parent, slots: SlotOrder, g, tiling: Optional[tuple] = None):
    """One tconv_dw launch at widths the kernel takes (multiples of 32 up to
    512); `tiling` (mb, nb, n_chunks) (None: `tconv_dw_tiling`'s)."""
    b, c_coarse, f_in = feats.shape
    c_fine, f_out = g.shape[1], g.shape[2]
    if not dw_widths_ok(f_in, f_out):
        raise ValueError(f"tconv_dw: F_in={f_in}, F_out={f_out}; the kernel takes widths that "
                         "are multiples of 32 up to 512")
    if feats.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"tconv_dw: feats {feats.dtype}, g {g.dtype}; the kernel takes f32 "
                        "(bf16 activations keep the plain form, sparse/conv.py)")
    if b * max(c_coarse, c_fine) >= 1 << 31:
        raise ValueError(f"tconv_dw: {b} x {max(c_coarse, c_fine)} rows; the kernel indexes "
                         "them with 32-bit ints")
    _check(feats, "feats", torch.float32, (b, c_coarse, f_in), align16=True)
    _check(g, "g", torch.float32, (b, c_fine, f_out), align16=True)
    _check(up_parent, "up_parent", torch.int32, (b, c_fine))
    _check(slots.order, "order", torch.int32, (b, c_fine))
    _check(slots.seg, "seg", torch.int32, (b, _TCONV_SEGMENTS + 1))
    mb, nb, n_chunks = tiling or tconv_dw_tiling(b, c_fine, f_in, f_out)
    partial = torch.empty((n_chunks, 8, f_in, f_out), dtype=torch.float32, device=feats.device)
    out = torch.empty((8, f_in, f_out), dtype=torch.float32, device=feats.device)
    fn = cuda_lib.function("tconv_dw.cu", "egonn_tconv_dw")
    _raise_on(fn(feats.data_ptr(), up_parent.data_ptr(), slots.order.data_ptr(),
                 slots.seg.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(), b,
                 c_coarse, c_fine, f_in, f_out, mb, nb, n_chunks, _stream(feats)), "tconv_dw")
    return out


def tconv_dw(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
             g: torch.Tensor, slots: Optional[SlotOrder] = None) -> torch.Tensor:
    """Weight gradient of `tconv(feats, up_parent, up_koffset, W)` for the
    cotangent g: dW[k] = sum over the fine rows i of slot k with a parent
    of feats[b, up_parent[b, i]]^T g[b, i].

    feats (B, C_coarse, F_in) f32; up_parent, up_koffset (B, C_fine) int32;
    g (B, C_fine, F_out) f32; `slots` the up map's `slot_order` (None:
    built here).  Returns (8, F_in, F_out) f32.  On the card each slot's
    rows alone, over the slot order (`csrc/tconv_dw.cu`); any widths,
    through `width_plan(dw=True)`'s launches."""
    if not _on_cuda(feats, up_parent, up_koffset, g):
        return tconv_dw_plain(feats, up_parent, up_koffset, g)
    if feats.dim() != 3 or g.dim() != 3 or g.shape[:2] != up_parent.shape:
        raise ValueError(f"feats {tuple(feats.shape)}, up_parent {tuple(up_parent.shape)}, g "
                         f"{tuple(g.shape)}: expected (B, C_coarse, F_in), (B, C_fine) and "
                         "(B, C_fine, F_out)")
    if slots is None:
        slots = slot_order(up_parent, up_koffset, feats.shape[1])

    def launch(f, gg):
        out = _tconv_dw_cuda(f, up_parent, slots, gg)
        LAUNCHES["tconv_dw"] += 1
        return out
    return planned_dw(launch, feats, g, 8, width_plan(feats.shape[2], g.shape[2], dw=True))


KERNELS = (zrun_presence, zrun_rank, gather_conv, tdown, gather_dw, lookup, stem_ones, tconv,
           slot_order, tconv_dw)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in BODY_LAUNCHES.values():
        counts[:] = [0, 0]


def launch_counts() -> dict:
    return dict(LAUNCHES)


def body_launch_counts() -> dict:
    """The bf16 conv and dW launches by body: {name: {"sm80": n, "sm90": m}}."""
    return {name: {"sm80": c[SM80], "sm90": c[SM90]} for name, c in BODY_LAUNCHES.items()}
