"""Sparse convolution compute (port of the inference half of
`egonn_tpu/sparse/conv.py`).

* `sparse_conv`: out[o] = sum_k feats[kmap[k, o]] @ W[k], with the optional
  fused eval epilogue; the gather conv kernel (`kernels.gather_conv`).
* `sparse_tdown`: the k=2 s=2 down conv in transposed form, driven by the
  fine level's up map (`kernels.tdown`), so inference never builds kmap_down.
* `sparse_conv_ones`, `sparse_conv1x1`, `sparse_tconv2x2`: plain products
  (the JAX package leaves them to XLA), written with torch matmuls.

Inference only: the custom-gradient forms that training uses are not
ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from egonn_tpu_torch.sparse import kernels


def sparse_conv(feats: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor,
                epi: Optional[tuple] = None) -> torch.Tensor:
    """Sparse convolution.

    feats (B, C_in, F_in) with zero padding rows; kmap (B, K, C_out) int32
    gather indices into C_in (sentinel C_in -> zero row); kernel
    (K, F_in, F_out).  Returns (B, C_out, F_out).

    epi = (scale (F_out,), bias (F_out,), relu: bool, mask (B, C_out)) fuses
    the eval-mode BN affine + ReLU + row mask into the output store."""
    return kernels.gather_conv(feats, kmap, kernel, epi=epi)


def sparse_tdown(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
                 kernel: torch.Tensor, c_coarse: int, epi: Optional[tuple] = None
                 ) -> torch.Tensor:
    """k=2 s=2 down conv from the fine level's up map (up_parent/up_koffset,
    both (B, C_fine)); the same sum as sparse_conv over kmap_down, since each
    (parent, slot) pair has at most one child.  Returns (B, c_coarse, F_out)."""
    return kernels.tdown(feats, up_parent, up_koffset, kernel, c_coarse, epi=epi)


def sparse_conv_ones(kmap: torch.Tensor, kernel: torch.Tensor, n_in_rows: int
                     ) -> torch.Tensor:
    """Stem conv over constant-ones 1-channel features:
    out[b, c] = sum_k [kmap[b, k, c] valid] * kernel[k, 0, :]."""
    valid = (kmap < n_in_rows).to(kernel.dtype)  # (B, K, C_out)
    return torch.matmul(valid.transpose(1, 2), kernel[:, 0, :])


def sparse_conv1x1(feats: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """1x1 convolution: feats (B, C, F_in) @ kernel (F_in, F_out)."""
    return torch.matmul(feats, kernel)


def sparse_tconv2x2(feats_coarse: torch.Tensor, up_parent: torch.Tensor,
                    up_koffset: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Transposed k=2 s=2 conv from level l+1 onto level l's coordinates:
    out[c] = feats_coarse[up_parent[c]] @ kernel[up_koffset[c]] (zero where
    up_parent is the sentinel C_coarse).

    feats_coarse (B, C_coarse, F_in); up_parent, up_koffset (B, C_fine);
    kernel (8, F_in, F_out)."""
    b, c_coarse, f_in = feats_coarse.shape
    n_slots, _, f_out = kernel.shape
    feats_p = torch.cat([feats_coarse, feats_coarse.new_zeros(b, 1, f_in)], dim=1)
    g = torch.gather(feats_p, 1, up_parent.long()[..., None].expand(-1, -1, f_in))
    # every slot's product in one matmul, then each voxel keeps its own slot
    all_slots = torch.matmul(g, kernel.permute(1, 0, 2).reshape(f_in, n_slots * f_out))
    all_slots = all_slots.reshape(b, -1, n_slots, f_out)
    slot = up_koffset.long()[..., None, None].expand(-1, -1, 1, f_out)
    return torch.gather(all_slots, 2, slot)[:, :, 0, :]
