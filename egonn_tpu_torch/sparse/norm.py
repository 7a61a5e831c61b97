"""Masked batch norm and global pooling over padded voxel buffers (port of
`egonn_tpu/sparse/norm.py`).

BatchNorm normalises y = (x - mean) * rsqrt(var + eps) * scale + bias, with
padding rows zeroed.  In eval mode mean and var are the running statistics,
and `affine()` exposes the same map as a per-channel (s, b) for fusion into a
conv's epilogue.  In train mode (`module.train()`) they are the statistics of
the valid voxels of the whole batch (the biased variance), and the running
statistics move by momentum 0.1 towards the batch mean and the unbiased
variance var * cnt / max(cnt - 1, 1), in place.  `nn.BatchNorm1d` over the
padded buffers would count the padding.

Under data parallelism (`process_group` set, `parallel/mesh.py`) the batch is
the global batch: the two passes' sums are summed over the ranks, first
[sum x*m, sum m] for the mean, then sum (x - mean)^2 * m for the variance (the
two-pass form of the single process), so every rank's running statistics
come out equal.

Statistics and the normalisation are computed in f32 whatever the input's
type, and the output comes back in the input's type (bf16 activations,
`sparse/conv.py::activation_dtype`), as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from egonn_tpu_torch.parallel.mesh import all_reduce_sum


class SparseBatchNorm(nn.Module):
    """Masked BatchNorm over (B, C, F) voxel features with a (B, C) mask.
    Parameters `scale`, `bias`; buffers `mean`, `var` (the JAX package's
    params / batch_stats names)."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.features = features
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.process_group = None  # data parallel: statistics over every rank's rows

    def affine(self) -> tuple:
        """Eval-mode BN as y = x * s + b, s = scale * rsqrt(var + eps),
        b = bias - mean * s."""
        s = self.scale * torch.rsqrt(self.var + self.eps)
        return s, self.bias - self.mean * s

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            group = self.process_group
            m = mask[..., None].to(torch.float32)
            x = feats.to(torch.float32) * m
            total, cnt = x.sum((0, 1)), m.sum()
            if group is not None:  # one all-reduce for both sums
                sums = all_reduce_sum(torch.cat([total, cnt.reshape(1)]), group)
                total, cnt = sums[:-1], sums[-1]
            cnt = torch.clamp_min(cnt, 1.0)
            mean = total / cnt
            var = all_reduce_sum(((x - mean) ** 2 * m).sum((0, 1)), group) / cnt  # biased
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
                self.mean.copy_((1 - self.momentum) * self.mean + self.momentum * mean)
                self.var.copy_((1 - self.momentum) * self.var + self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (feats.to(torch.float32) - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale + self.bias
        return (y * mask[..., None].to(y.dtype)).to(feats.dtype)


def global_avg_pool(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over voxels: (B, C, F), (B, C) -> (B, F)."""
    m = mask[..., None].to(torch.float32)
    cnt = torch.clamp_min(m.sum(1), 1.0)
    return (feats.to(torch.float32) * m).sum(1) / cnt


def global_max_pool(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked max over voxels: (B, C, F), (B, C) -> (B, F)."""
    neg = torch.finfo(feats.dtype).min
    return torch.where(mask[..., None], feats, neg).amax(1)


def broadcast_mul(feats: torch.Tensor, per_cloud: torch.Tensor) -> torch.Tensor:
    """Multiply every voxel's features by a per-cloud (B, F) vector."""
    return feats * per_cloud[:, None, :].to(feats.dtype)
