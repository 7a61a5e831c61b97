"""Sparse convolution compute (port of `egonn_tpu/sparse/conv.py`).

* `sparse_conv`: out[o] = sum_k feats[kmap[k, o]] @ W[k], with the optional
  fused eval epilogue; the gather conv kernel (`kernels.gather_conv`).  It
  has no gradient: training goes through the three functions below.
* `sparse_tdown`: the k=2 s=2 down conv in transposed form, driven by the
  fine level's up map (`kernels.tdown`), so inference never builds kmap_down.
* `sparse_conv_ones`: the stem over constant-ones features
  (`kernels.stem_ones`).
* `sparse_tconv2x2`: the transposed k=2 s=2 conv (`kernels.tconv`: each
  fine voxel times its own slot's kernel, over the up map's slot order,
  which `level_slots` keeps on the level).
* `sparse_conv1x1`: a plain product (the JAX package leaves it to XLA),
  written with a torch matmul.

Activations may be bf16 (`activation_dtype`, `EGONN_BF16_ACTS=1` on a CUDA
device, as the JAX package's on a TPU): every conv returns its features'
type.  The gather convs then run the bf16 kernels; the plain products
(the 1x1 conv, and the transposed conv, which keeps its all-slot torch
product for bf16 activations until a bf16 cell measures it) compute in f32
on the bf16 values (torch's matmul does not promote, JAX's
einsum does) and round once to bf16.  In the backward the cotangents of
bf16 activations are bf16: every dX is a bf16 conv again, every dW sums the
exact products of the bf16 values in f32 and is returned f32, the
parameters' type (`gather_dw` on bf16 features; the transposed conv's dW
in f32 as JAX's `preferred_element_type=jnp.float32` einsum).

The custom gradients of the JAX package (`conv.py:124-217`), as
`torch.autograd.Function`s.  Each saves its inputs, never the gathered
activations, and its backward is a gather program again:

* `sparse_conv_sym` (odd self kernels): dX = gather_conv(g, kmap reversed
  along K, W^T) (offset -d is offset d reversed in C order), dW = gather_dw.
* `sparse_conv_down` (k=2 s=2 over kmap_down): dX = sparse_tconv2x2(g, up map,
  W^T) (`kernels.tconv` over the fine level's slot order), dW = gather_dw.
* `sparse_tconv2x2_vjp`: dX = gather_conv(g, the coarse level's kmap_down,
  W^T), dW = the slot-masked products of the gathered coarse features.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from egonn_tpu_torch.sparse import kernels
from egonn_tpu_torch.sparse.types import Level
from egonn_tpu_torch.utils.tracing import span

# Eval-mode BN affine + ReLU + row mask fused into the conv kernels' output
# store (the models pass an `epi` tuple).  EGONN_FUSE_BN=0, or
# set_fuse_bn(False), runs each conv, then its BN and ReLU as separate ops
# (the JAX package's toggle): the same function, associated differently,
# x * s + b against (x - m) * rsqrt(v + eps) * scale + bias.
FUSE_BN_EVAL = os.environ.get("EGONN_FUSE_BN", "1") == "1"


def activation_dtype(device) -> torch.dtype:
    """Storage type of the EgoNN trunk's and heads' activations on `device`:
    bf16 where EGONN_BF16_ACTS=1 (read at each call; default 0) and the
    device is a CUDA card, as the JAX package stores them in bf16 on a TPU
    alone; else f32.  Halves the activations' memory; the conv kernels then
    compute as the TPU kernels do (`sparse/kernels.py`)."""
    if os.environ.get("EGONN_BF16_ACTS", "0") == "1" and torch.device(device).type == "cuda":
        return torch.bfloat16
    return torch.float32


def set_fuse_bn(enabled: bool) -> None:
    """Fuse the eval-mode BN / ReLU epilogue into the convs (default) or not."""
    global FUSE_BN_EVAL
    FUSE_BN_EVAL = enabled


def _transposed(kernel: torch.Tensor) -> torch.Tensor:
    """W^T per offset, contiguous as the kernels require."""
    return kernel.transpose(1, 2).contiguous()


def _refuse_grad(name: str, *tensors: torch.Tensor,
                 instead: str = "sparse_conv_sym or sparse_conv_down") -> None:
    """The inference-only convs have no backward: raise rather than let a
    CUDA kernel's output silently cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no gradient: use {instead}")


def sparse_conv(feats: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor,
                epi: Optional[tuple] = None) -> torch.Tensor:
    """Sparse convolution.

    feats (B, C_in, F_in) with zero padding rows; kmap (B, K, C_out) int32
    gather indices into C_in (sentinel C_in -> zero row); kernel
    (K, F_in, F_out).  Returns (B, C_out, F_out) in the features' type.

    epi = (scale (F_out,), bias (F_out,), relu: bool, mask (B, C_out)) fuses
    the eval-mode BN affine + ReLU + row mask into the output store.  Raises
    where a gradient is asked for."""
    _refuse_grad("sparse_conv", feats, kernel)
    return kernels.gather_conv(feats, kmap, kernel, epi=epi)


class _ConvSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, kmap, kernel):
        ctx.save_for_backward(feats, kmap, kernel)
        return kernels.gather_conv(feats, kmap, kernel)

    @staticmethod
    def backward(ctx, g):
        feats, kmap, kernel = ctx.saved_tensors
        g = g.contiguous()
        d_feats = d_kernel = None
        if ctx.needs_input_grad[0]:
            # the reversed self map is itself a self map (centre stays centre)
            d_feats = kernels.gather_conv(g, kmap.flip(1).contiguous(), _transposed(kernel))
        if ctx.needs_input_grad[2]:
            d_kernel = kernels.gather_dw(feats, kmap, g)
        return d_feats, None, d_kernel


def sparse_conv_sym(feats: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor
                    ) -> torch.Tensor:
    """Stride-1 self-convolution over a symmetric (odd k^3) offset set, with
    the gather-only backward."""
    return _ConvSym.apply(feats, kmap, kernel)


class _ConvDown(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, kmap_down, up_parent, up_koffset, kernel, slots):
        ctx.save_for_backward(feats, kmap_down, up_parent, up_koffset, kernel)
        ctx.slots = slots
        return kernels.gather_conv(feats, kmap_down, kernel)

    @staticmethod
    def backward(ctx, g):
        feats, kmap_down, up_parent, up_koffset, kernel = ctx.saved_tensors
        g = g.contiguous()
        d_feats = d_kernel = None
        if ctx.needs_input_grad[0]:
            # the transpose of the down conv is the transposed conv
            d_feats = sparse_tconv2x2(g, up_parent, up_koffset, kernel.transpose(1, 2),
                                      ctx.slots)
        if ctx.needs_input_grad[4]:
            d_kernel = kernels.gather_dw(feats, kmap_down, g)
        return d_feats, None, None, None, d_kernel, None


def sparse_conv_down(feats: torch.Tensor, kmap_down: torch.Tensor, up_parent: torch.Tensor,
                     up_koffset: torch.Tensor, kernel: torch.Tensor,
                     slots: Optional[kernels.SlotOrder] = None) -> torch.Tensor:
    """k=2 s=2 down conv over the coarse level's kmap_down (B, 8, C_coarse),
    with the gather-only backward through the fine level's up map (`slots`
    its slot order, None: built by the backward on the card)."""
    return _ConvDown.apply(feats, kmap_down, up_parent, up_koffset, kernel, slots)


class _Tconv2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats_coarse, up_parent, up_koffset, kmap_down, kernel, slots):
        ctx.save_for_backward(feats_coarse, up_parent, up_koffset, kmap_down, kernel)
        return sparse_tconv2x2(feats_coarse, up_parent, up_koffset, kernel, slots)

    @staticmethod
    def backward(ctx, g):
        feats_coarse, up_parent, up_koffset, kmap_down, kernel = ctx.saved_tensors
        g = g.contiguous()
        d_feats = d_kernel = None
        if ctx.needs_input_grad[0]:
            d_feats = kernels.gather_conv(g, kmap_down, _transposed(kernel))
        if ctx.needs_input_grad[4]:
            # dW[k] = sum over fine voxels in slot k of feats[parent]^T g, in
            # f32 (on the bf16 values of bf16 activations: exact products)
            b, _, f_in = feats_coarse.shape
            feats_p = torch.cat([feats_coarse, feats_coarse.new_zeros(b, 1, f_in)], dim=1)
            gathered = torch.gather(feats_p, 1,
                                    up_parent.long()[..., None].expand(-1, -1, f_in)).float()
            g32 = g.float()
            d_kernel = torch.stack([
                torch.einsum("bcf,bco->fo", gathered * (up_koffset == k)[..., None], g32)
                for k in range(kernel.shape[0])])
        return d_feats, None, None, None, d_kernel, None


def sparse_tconv2x2_vjp(feats_coarse: torch.Tensor, up_parent: torch.Tensor,
                        up_koffset: torch.Tensor, kmap_down: torch.Tensor,
                        kernel: torch.Tensor,
                        slots: Optional[kernels.SlotOrder] = None) -> torch.Tensor:
    """sparse_tconv2x2 with the gather-only backward: dX is the down conv of
    g with W^T over the coarse level's kmap_down."""
    return _Tconv2x2.apply(feats_coarse, up_parent, up_koffset, kmap_down, kernel, slots)


def sparse_tdown(feats: torch.Tensor, up_parent: torch.Tensor, up_koffset: torch.Tensor,
                 kernel: torch.Tensor, c_coarse: int, epi: Optional[tuple] = None
                 ) -> torch.Tensor:
    """k=2 s=2 down conv from the fine level's up map (up_parent/up_koffset,
    both (B, C_fine)); the same sum as sparse_conv over kmap_down, since each
    (parent, slot) pair has at most one child.  Returns (B, c_coarse, F_out)
    in the features' type.
    Inference only: raises where a gradient is asked for."""
    _refuse_grad("sparse_tdown", feats, kernel)
    return kernels.tdown(feats, up_parent, up_koffset, kernel, c_coarse, epi=epi)


class _StemOnes(torch.autograd.Function):
    """The stem in f32, saving only the map: its gradient is dW alone (the
    features are constant), the one torch.mm that autograd runs through the
    plain form's product, on the 0/1 matrix rebuilt from the map."""

    @staticmethod
    def forward(ctx, kmap, kernel, n_in_rows):
        ctx.save_for_backward(kmap)
        ctx.n_in_rows = n_in_rows
        return kernels.stem_ones(kmap, kernel, n_in_rows)

    @staticmethod
    def backward(ctx, g):
        d_kernel = None
        if ctx.needs_input_grad[1]:
            (kmap,) = ctx.saved_tensors
            k_vol = kmap.shape[1]
            valid = (kmap < ctx.n_in_rows).to(g.dtype).transpose(1, 2).reshape(-1, k_vol)
            d_kernel = torch.mm(valid.t(), g.reshape(-1, g.shape[-1]))[:, None, :]
        return None, d_kernel, None


def sparse_conv_ones(kmap: torch.Tensor, kernel: torch.Tensor, n_in_rows: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stem conv over constant-ones 1-channel features:
    out[b, c] = sum_k [kmap[b, k, c] valid] * kernel[k, 0, :], summed in f32
    (`kernels.stem_ones`) and returned in `dtype`."""
    return _StemOnes.apply(kmap, kernel, n_in_rows).to(dtype)


def sparse_conv1x1(feats: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """1x1 convolution: feats (B, C, F_in) @ kernel (F_in, F_out), in the
    kernel's type, returned in the features'."""
    return torch.matmul(feats.to(kernel.dtype), kernel).to(feats.dtype)


def level_slots(level: Level, c_coarse: int, dtype: torch.dtype
                ) -> Optional[kernels.SlotOrder]:
    """The slot order of `level`'s up map onto a level of c_coarse rows
    (`kernels.slot_order`), built at the first call and kept on the level:
    the transposed conv onto the level and the backward of the down conv
    from it share one.  None where the level records no up map or where the
    transposed conv takes none: a level off the card, or activations of
    type `dtype` bf16 (both multiply all slots, `kernels.tconv_plain`)."""
    if level.up_parent is None or not level.up_parent.is_cuda or dtype == torch.bfloat16:
        return None
    if level.up_slots is None:
        level.up_slots = kernels.slot_order(level.up_parent, level.up_koffset, c_coarse)
    return level.up_slots


def sparse_tconv2x2(feats_coarse: torch.Tensor, up_parent: torch.Tensor,
                    up_koffset: torch.Tensor, kernel: torch.Tensor,
                    slots: Optional[kernels.SlotOrder] = None) -> torch.Tensor:
    """Transposed k=2 s=2 conv from level l+1 onto level l's coordinates:
    out[c] = feats_coarse[up_parent[c]] @ kernel[up_koffset[c]] (zero where
    up_parent is the sentinel C_coarse), in the span `egonn.tconv`.

    feats_coarse (B, C_coarse, F_in); up_parent, up_koffset (B, C_fine);
    kernel (8, F_in, F_out); `slots` the up map's slot order (`level_slots`;
    None: built per call on the card).  f32 features: `kernels.tconv`, on
    the card each voxel times its own slot's kernel (without a gradient:
    training takes `sparse_tconv2x2_vjp`), on the CPU its plain version.
    bf16 features (no cell runs them yet) keep that plain all-slot product
    on the card too, computed in the kernel's type and returned in the
    features'."""
    with span("egonn.tconv"):
        if feats_coarse.dtype == torch.bfloat16:
            return kernels.tconv_plain(feats_coarse, up_parent, up_koffset, kernel)
        if feats_coarse.is_cuda:  # the kernel's output has no gradient
            _refuse_grad("sparse_tconv2x2 on the card", feats_coarse, kernel,
                         instead="sparse_tconv2x2_vjp")
        return kernels.tconv(feats_coarse, up_parent, up_koffset, kernel, slots)
