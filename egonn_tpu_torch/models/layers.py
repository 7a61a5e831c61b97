"""Building-block modules (port of `egonn_tpu/models/layers.py`): sparse conv
wrappers, the down conv step, ECA attention, GeM / MAC / SPoC / NetVLAD
pooling, descriptor and regressor MLPs.

Parameter names and shapes follow the flax modules, so a flax variable tree
maps one to one onto `state_dict()` keys (`utils/weights.py`): conv kernels
(K, F_in, F_out), 1x1 kernels and Linear weights (in, out).  Every module
takes a `torch.Generator` and draws its initial weights from it with the JAX
package's initialisers.  Train and eval follow `module.train()` /
`module.eval()`, as the flax modules follow their `train` flag.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from egonn_tpu_torch.sparse import conv as sconv
from egonn_tpu_torch.sparse.kernels import SlotOrder
from egonn_tpu_torch.sparse.norm import (
    SparseBatchNorm,
    broadcast_mul,
    global_avg_pool,
    global_max_pool,
)
from egonn_tpu_torch.sparse.types import Level, masked


def _uniform(shape: Sequence[int], scale: float, gen: torch.Generator) -> nn.Parameter:
    """uniform(-scale, scale)."""
    return nn.Parameter(torch.empty(tuple(shape)).uniform_(-scale, scale, generator=gen))


def _normal(shape: Sequence[int], std: float, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(tuple(shape)).normal_(0.0, std, generator=gen))


def me_conv_init(shape: Sequence[int], kernel_volume: int, in_channels: int,
                 gen: torch.Generator) -> nn.Parameter:
    """MinkowskiConvolution.reset_parameters: uniform(-s, s) with
    s = 1/sqrt(in_channels * kernel_volume)."""
    return _uniform(shape, 1.0 / math.sqrt(max(1, in_channels * kernel_volume)), gen)


def kaiming_me(shape: Sequence[int], kernel_volume: int, out_channels: int,
               gen: torch.Generator) -> nn.Parameter:
    """ME.utils.kaiming_normal_(mode='fan_out', relu) on a (K, in, out) kernel:
    fan_out = K * out."""
    return _normal(shape, math.sqrt(2.0 / max(1, kernel_volume * out_channels)), gen)


class SparseConv(nn.Module):
    """Stride-1 k^3 sparse conv over a self map, the constant-ones stem, or
    (given the finer level's up map) the k=2 s=2 down conv.  No bias.

    Dispatch as `egonn_tpu/models/layers.py:70-93`: with an eval epilogue
    the fused kernels (the down conv in transposed form, from the up map);
    without one the differentiable forms: the down conv over kmap_down,
    `sparse_conv_sym` for the odd self kernels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int,
                 gen: torch.Generator, kaiming: bool = False):
        super().__init__()
        shape = (kernel_volume, in_channels, out_channels)
        self.kernel = (kaiming_me(shape, kernel_volume, out_channels, gen) if kaiming
                       else me_conv_init(shape, kernel_volume, in_channels, gen))

    def forward(self, feats: Optional[torch.Tensor], kmap: Optional[torch.Tensor] = None,
                up_parent: Optional[torch.Tensor] = None,
                up_koffset: Optional[torch.Tensor] = None,
                epi: Optional[tuple] = None,
                slots: Optional[SlotOrder] = None) -> torch.Tensor:
        """feats None: the stem over constant-ones features, whose kmap (a
        self map, C_in == C_out) records neighbour presence only.  `slots`:
        the up map's slot order, for the down conv's backward
        (`sconv.level_slots`)."""
        if feats is None:
            return sconv.sparse_conv_ones(kmap, self.kernel, kmap.shape[-1])
        k_vol = self.kernel.shape[0]
        if epi is not None:
            if up_parent is not None and k_vol == 8:
                mask = epi[3]
                return sconv.sparse_tdown(feats, up_parent, up_koffset, self.kernel,
                                          mask.shape[-1], epi=epi)
            return sconv.sparse_conv(feats, kmap, self.kernel, epi=epi)
        if up_parent is not None:
            if kmap is None:
                raise ValueError("the down conv without an epilogue needs kmap_down: build "
                                 "the pyramid with with_kmap_down=True")
            return sconv.sparse_conv_down(feats, kmap, up_parent, up_koffset, self.kernel,
                                          slots)
        if k_vol in (27, 125, 343):
            return sconv.sparse_conv_sym(feats, kmap, self.kernel)
        return sconv.sparse_conv(feats, kmap, self.kernel)


def down_conv(conv: SparseConv, bn: SparseBatchNorm, feats: torch.Tensor, level: Level,
              finer: Level, training: bool) -> torch.Tensor:
    """The k=2 s=2 down conv from level `finer` onto `level`, with BN and
    ReLU.  Eval fuses BN + ReLU + mask into the conv: transposed from the
    finer level's up map where it is recorded, else a gather over
    `level.kmap_down`.  Train runs the conv over `level.kmap_down`, then BN
    and ReLU; so does eval with the fusion off (`sconv.FUSE_BN_EVAL`), in
    transposed form where the pyramid has no kmap_down."""
    if training or not sconv.FUSE_BN_EVAL:
        if training or level.kmap_down is not None:
            x = conv(feats, level.kmap_down, finer.up_parent, finer.up_koffset,
                     slots=sconv.level_slots(finer, level.capacity, feats.dtype)
                     if training else None)
        else:
            x = sconv.sparse_tdown(feats, finer.up_parent, finer.up_koffset, conv.kernel,
                                   level.mask.shape[-1])
        return torch.relu(bn(x, level.mask))
    s, shift = bn.affine()
    return conv(feats, level.kmap_down, finer.up_parent, finer.up_koffset,
                epi=(s, shift, True, level.mask))


class SparseConv1x1(nn.Module):
    """1x1 conv, kernel (in, out); kaiming fan_out on a 2-D tensor uses
    fan_out = in_channels."""

    def __init__(self, in_channels: int, out_channels: int, gen: torch.Generator,
                 kaiming: bool = False):
        super().__init__()
        shape = (in_channels, out_channels)
        self.kernel = (_normal(shape, math.sqrt(2.0 / max(1, in_channels)), gen) if kaiming
                       else _uniform(shape, 1.0 / math.sqrt(max(1, in_channels)), gen))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return sconv.sparse_conv1x1(feats, self.kernel)


class SparseConvTranspose2x2(nn.Module):
    """Transposed k=2 s=2 conv onto the recorded finer level (FPN top-down);
    with a coarse level that carries kmap_down, through the gather-only
    backward (`sparse_tconv2x2_vjp`)."""

    def __init__(self, in_channels: int, out_channels: int, gen: torch.Generator):
        super().__init__()
        # ME transpose init: n = out_channels * kernel_volume
        self.kernel = _uniform((8, in_channels, out_channels),
                               1.0 / math.sqrt(max(1, out_channels * 8)), gen)

    def forward(self, feats: torch.Tensor, fine_level: Level,
                coarse_level: Optional[Level] = None) -> torch.Tensor:
        slots = sconv.level_slots(fine_level, feats.shape[1], feats.dtype)
        if coarse_level is not None and coarse_level.kmap_down is not None:
            return sconv.sparse_tconv2x2_vjp(feats, fine_level.up_parent,
                                             fine_level.up_koffset, coarse_level.kmap_down,
                                             self.kernel, slots)
        return sconv.sparse_tconv2x2(feats, fine_level.up_parent, fine_level.up_koffset,
                                     self.kernel, slots)


class Linear(nn.Module):
    """torch.nn.Linear-parity dense layer with an (in, out) weight."""

    def __init__(self, in_features: int, out_features: int, gen: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(max(1, in_features))
        self.weight = _uniform((in_features, out_features), bound, gen)
        self.bias = _uniform((out_features,), bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """In the promoted type of x and the weight, as flax's Dense: bf16
        activations give f32 outputs."""
        return x.to(torch.promote_types(x.dtype, self.weight.dtype)) @ self.weight + self.bias


class ECALayer(nn.Module):
    """Efficient Channel Attention: masked global avg pool -> 1-D correlation
    over channels (kernel size from log2(C)) -> sigmoid -> broadcast multiply."""

    def __init__(self, channels: int, gen: torch.Generator):
        super().__init__()
        t = int(abs((np.log2(channels) + 1) / 2))  # gamma = 2, b = 1
        self.k_size = t if t % 2 else t + 1
        # torch Conv1d default init with in_ch = 1
        self.conv = _uniform((self.k_size,), 1.0 / math.sqrt(self.k_size), gen)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = global_avg_pool(feats, mask)                      # (B, C)
        pad = (self.k_size - 1) // 2
        windows = F.pad(y, (pad, pad)).unfold(1, self.k_size, 1)  # (B, C, k)
        y = torch.sigmoid(windows @ self.conv)
        return broadcast_mul(feats, y)


class BasicBlock(nn.Module):
    """ME BasicBlock: conv3 -> BN -> ReLU -> conv3 -> BN (+ECA) -> + residual
    (1x1 + BN when the width changes) -> ReLU -> mask.  In eval mode each BN
    (and the first ReLU) is fused into its conv's epilogue, unless
    `sconv.FUSE_BN_EVAL` is off.  kaiming: the
    EgoNN trunk re-initialises its convs kaiming fan_out; MinkFPN does not."""

    def __init__(self, inplanes: int, planes: int, gen: torch.Generator,
                 use_eca: bool = False, kaiming: bool = True):
        super().__init__()
        self.conv1 = SparseConv(inplanes, planes, 27, gen, kaiming=kaiming)
        self.norm1 = SparseBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, 27, gen, kaiming=kaiming)
        self.norm2 = SparseBatchNorm(planes)
        self.eca = ECALayer(planes, gen) if use_eca else None
        if inplanes != planes:
            self.downsample_conv = SparseConv1x1(inplanes, planes, gen, kaiming=kaiming)
            self.downsample_norm = SparseBatchNorm(planes)
        else:
            self.downsample_conv = self.downsample_norm = None

    def attend(self, out: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Channel attention after the second conv: ECA where asked for (SE
        in `senet.SEBasicBlock`)."""
        return out if self.eca is None else self.eca(out, mask)

    def forward(self, feats: torch.Tensor, level: Level) -> torch.Tensor:
        if self.training or not sconv.FUSE_BN_EVAL:
            out = torch.relu(self.norm1(self.conv1(feats, level.kmap_self), level.mask))
            out = self.norm2(self.conv2(out, level.kmap_self), level.mask)
        else:
            s1, b1 = self.norm1.affine()
            out = self.conv1(feats, level.kmap_self, epi=(s1, b1, True, level.mask))
            s2, b2 = self.norm2.affine()
            out = self.conv2(out, level.kmap_self, epi=(s2, b2, False, level.mask))
        out = self.attend(out, level.mask)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(feats), level.mask)
        else:
            residual = feats
        return masked(torch.relu(out + residual), level.mask)


class GeM(nn.Module):
    """Generalized-mean pooling: learnable p (init 3), clamp(min=eps) ** p,
    masked average, ** 1/p; an empty cloud pools to eps."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.p = nn.Parameter(torch.full((1,), 3.0))

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = torch.clamp_min(feats, self.eps) ** self.p
        x = global_avg_pool(masked(x, mask), mask)
        x = torch.maximum(x, self.eps ** self.p)
        return x ** (1.0 / self.p)


class PoolingWrapper(nn.Module):
    """Pooling by name: MAC, SPoC, GeM, or NetVLAD over 64 clusters
    (`netvlad`; `netvladgc` adds context gating)."""

    def __init__(self, pool_method: str, in_dim: int, output_dim: int, gen: torch.Generator):
        super().__init__()
        self.pool_method = pool_method
        self.gem = self.netvlad = None
        if pool_method in ("netvlad", "netvladgc"):
            from egonn_tpu_torch.models.netvlad import NetVLADLoupe

            self.netvlad = NetVLADLoupe(in_dim, 64, output_dim, gen,
                                        gating=pool_method == "netvladgc")
            return
        if pool_method not in ("MAC", "SPoC", "GeM"):
            raise NotImplementedError(f"Unknown pooling method: {pool_method}")
        if in_dim != output_dim:
            raise ValueError(f"{pool_method} keeps the width: {in_dim} != {output_dim}")
        self.gem = GeM() if pool_method == "GeM" else None

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.pool_method == "MAC":
            return global_max_pool(masked(feats, mask), mask)
        if self.pool_method == "SPoC":
            return global_avg_pool(masked(feats, mask), mask)
        if self.netvlad is not None:
            return self.netvlad(feats, mask)
        return self.gem(feats, mask)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), with the norm taken as sqrt(max(sum x^2, eps^2))
    so that its gradient stays finite on all-zero padding rows."""
    nsq = (x * x).sum(dim, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(nsq, eps * eps))


class DescriptorDecoder(nn.Module):
    """in -> mid -> out MLP, mid = out + (in - out) // 2, optional L2 norm."""

    def __init__(self, in_channels: int, out_channels: int, gen: torch.Generator,
                 normalize: bool = True):
        super().__init__()
        mid = out_channels + (in_channels - out_channels) // 2
        self.fc1 = Linear(in_channels, mid, gen)
        self.fc2 = Linear(mid, out_channels, gen)
        self.normalize = normalize

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.fc2(torch.relu(self.fc1(feats)))
        return l2_normalize(x) if self.normalize else x


class MLPRegressor(nn.Module):
    """Linear -> ReLU -> Linear -> tanh | softplus | sigmoid."""

    def __init__(self, in_channels: int, out_channels: int, activation: str,
                 gen: torch.Generator):
        super().__init__()
        if activation not in ("tanh", "softplus", "sigmoid"):
            raise NotImplementedError(activation)
        mid = in_channels // 2
        self.fc1 = Linear(in_channels, mid, gen)
        self.fc2 = Linear(mid, out_channels, gen)
        self.activation = activation

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.fc2(torch.relu(self.fc1(feats)))
        if self.activation == "tanh":
            return torch.tanh(x)
        if self.activation == "softplus":
            return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus
        return torch.sigmoid(x)
