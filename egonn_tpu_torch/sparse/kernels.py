"""The port's four hand-written CUDA kernels, each with its plain PyTorch
version and a launch counter.

| here            | CUDA source             | replaces (egonn_tpu/sparse/banded.py)          |
|-----------------|-------------------------|------------------------------------------------|
| `zrun_presence` | `csrc/zrun.cu`          | `_pallas_zrun_presence` / `zrun_presence`      |
| `zrun_rank`     | `csrc/zrun.cu`          | `_pallas_zrun_rank` / `zrun_rank`              |
| `gather_conv`   | `csrc/gather_conv.cu`   | `_pallas_banded_conv` / `banded_conv_pallas`   |
| `tdown`         | `csrc/tdown.cu`         | `_pallas_banded_tdown` / `banded_tdown_pallas` |

The TPU kernels work on band windows of the key-sorted tables and drop what
falls outside a window; these kernels index directly, so they are exact on
all data and equal the JAX package's exact gather engine.

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
from egonn_tpu_torch.sparse.packing import MAXKEY

_SMEM_LIMIT = 232448 - 256  # opt-in dynamic shared memory minus the static index tile
_CONV_F_OUT = (32, 64, 128)
# kernel launches per wrapper (CUDA tensors only; the plain versions do not count)
LAUNCHES = {"zrun_presence": 0, "zrun_rank": 0, "gather_conv": 0, "tdown": 0}


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


def _zrun_cuda(sorted_keys, q_lo, kz, with_rank: bool):
    if not 1 <= kz <= 8:
        raise ValueError(f"kz={kz}: the zrun kernels take 1 <= kz <= 8")
    b, c_in = sorted_keys.shape
    _check(sorted_keys, "sorted_keys", torch.int32, (b, c_in))
    if q_lo.dim() != 3 or q_lo.shape[0] != b:
        raise ValueError(f"q_lo: shape {tuple(q_lo.shape)}, expected (B={b}, Kxy, C_out)")
    _check(q_lo, "q_lo", torch.int32, q_lo.shape)
    n_q = q_lo.shape[1] * q_lo.shape[2]
    bits = torch.empty_like(q_lo)
    if with_rank:
        rank = torch.empty_like(q_lo)
        fn = cuda_lib.function("zrun.cu", "egonn_zrun_rank")
        err = fn(sorted_keys.data_ptr(), q_lo.data_ptr(), bits.data_ptr(), rank.data_ptr(),
                 b, c_in, n_q, kz, _stream(q_lo))
        _raise_on(err, "zrun_rank")
        return bits, rank
    fn = cuda_lib.function("zrun.cu", "egonn_zrun_presence")
    err = fn(sorted_keys.data_ptr(), q_lo.data_ptr(), bits.data_ptr(), b, c_in, n_q, kz,
             _stream(q_lo))
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


def _check_widths(f_in: int, f_out: int, name: str) -> None:
    if f_out not in _CONV_F_OUT or f_in % 4 or f_in < 4:
        raise ValueError(f"{name}: F_in={f_in}, F_out={f_out}; the kernel takes "
                         f"F_out in {_CONV_F_OUT} and F_in a multiple of 4")
    if 4 * (f_in * f_out + 64 * f_in) > _SMEM_LIMIT:
        raise ValueError(f"{name}: F_in={f_in} x F_out={f_out} exceeds shared memory")


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
    _check_widths(f_in, f_out, "gather_conv")
    _check(feats, "feats", torch.float32, (b, c_in, f_in), align16=True)
    _check(kmap, "kmap", torch.int32, (b, k_vol, c_out))
    _check(kernel, "kernel", torch.float32, (k_vol, f_in, f_out), align16=True)
    scale, bias, relu, mask = _check_epi(epi, b, c_out, f_out)
    out = torch.empty((b, c_out, f_out), dtype=torch.float32, device=feats.device)
    fn = cuda_lib.function("gather_conv.cu", "egonn_gather_conv")
    err = fn(feats.data_ptr(), kmap.data_ptr(), kernel.data_ptr(), _ptr(scale), _ptr(bias),
             _ptr(mask), out.data_ptr(), b, c_in, f_in, k_vol, c_out, f_out, relu,
             _stream(feats))
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
    return child[:, :8 * c_coarse].reshape(b, 8, c_coarse)


def tdown_plain(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
                kernel: torch.Tensor, c_coarse: int, epi: Optional[tuple] = None
                ) -> torch.Tensor:
    """out[p] = sum over fine children i of p of feats[i] @ kernel[koffset(i)]
    (+ epi): the up map inverted, then the gather conv over it."""
    return gather_conv_plain(feats, invert_up(up_parent, up_koffset, c_coarse), kernel, epi)


def tdown(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
          kernel: torch.Tensor, c_coarse: int, epi: Optional[tuple] = None) -> torch.Tensor:
    """k=2 s=2 down conv driven by the fine level's up map.

    feats (B, C_fine, F_in) f32; up_parent/up_koffset (B, C_fine) int32;
    kernel (8, F_in, F_out) f32.  Returns (B, c_coarse, F_out) f32."""
    tensors = [feats, up_parent, up_koffset, kernel] + ([epi[0], epi[1], epi[3]] if epi else [])
    if not _on_cuda(*tensors):
        return tdown_plain(feats, up_parent, up_koffset, kernel, c_coarse, epi)
    b, c_fine, f_in = feats.shape
    f_out = kernel.shape[2]
    _check_widths(f_in, f_out, "tdown")
    _check(feats, "feats", torch.float32, (b, c_fine, f_in), align16=True)
    _check(up_parent, "up_parent", torch.int32, (b, c_fine))
    _check(up_koffset, "up_koffset", torch.int32, (b, c_fine))
    _check(kernel, "kernel", torch.float32, (8, f_in, f_out), align16=True)
    scale, bias, relu, mask = _check_epi(epi, b, c_coarse, f_out)
    child = torch.empty((b, 8, c_coarse), dtype=torch.int32, device=feats.device)
    out = torch.empty((b, c_coarse, f_out), dtype=torch.float32, device=feats.device)
    fn = cuda_lib.function("tdown.cu", "egonn_tdown")
    err = fn(feats.data_ptr(), up_parent.data_ptr(), up_koffset.data_ptr(), kernel.data_ptr(),
             _ptr(scale), _ptr(bias), _ptr(mask), child.data_ptr(), out.data_ptr(),
             b, c_fine, f_in, c_coarse, f_out, relu, _stream(feats))
    _raise_on(err, "tdown")
    LAUNCHES["tdown"] += 1
    return out


KERNELS = (zrun_presence, zrun_rank, gather_conv, tdown)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
