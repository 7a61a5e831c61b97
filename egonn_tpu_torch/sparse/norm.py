"""Masked batch norm (eval mode) and global pooling over padded voxel buffers
(port of `egonn_tpu/sparse/norm.py`).

Eval-mode BatchNorm uses the running statistics: y = (x - mean) *
rsqrt(var + eps) * scale + bias, with padding rows zeroed.  `affine()`
exposes the same map as a per-channel (s, b) for fusion into a conv's
epilogue.  Train-mode statistics are not ported.
"""
from __future__ import annotations

import torch
from torch import nn


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

    def affine(self) -> tuple:
        """Eval-mode BN as y = x * s + b, s = scale * rsqrt(var + eps),
        b = bias - mean * s."""
        s = self.scale * torch.rsqrt(self.var + self.eps)
        return s, self.bias - self.mean * s

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = (feats - self.mean) * torch.rsqrt(self.var + self.eps)
        y = y * self.scale + self.bias
        return y * mask[..., None].to(y.dtype)


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
