"""NetVLAD pooling with optional context gating (port of
`egonn_tpu/models/netvlad.py`), over padded (B, C, F) features with a (B, C)
mask.

NetVLADLoupe: soft assignment of every voxel to `cluster_size` clusters
(features @ cluster_weights, BatchNorm, softmax; padding rows then zeroed),
residuals against the learned centres summed per cluster, intra-normalised
per cluster, flattened, L2-normalised, projected to `output_dim`, then
optionally gated (GatingContext: x * sigmoid(BN(x @ W))).

Both BatchNorms are flax `nn.BatchNorm`, not the masked `SparseBatchNorm`:
they normalise every row, padding included (eps 1e-5).  In train mode they
take flax's statistics: the mean and the one-pass variance E[x^2] - E[x]^2
(clipped at 0) over every row, and the running statistics move by flax's
momentum 0.99 towards them (the biased variance).  Under data parallelism
the sums are over every rank's rows.  Parameter names are the flax names.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from egonn_tpu_torch.models.layers import l2_normalize
from egonn_tpu_torch.parallel.mesh import all_reduce_sum


def _trunc_normal(shape, std: float, gen: torch.Generator) -> nn.Parameter:
    """flax `truncated_normal(std)`: std times a standard normal cut at +-2."""
    t = torch.empty(tuple(shape))
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return nn.Parameter(t)


class FlaxBatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the last axis: y = (x - mean) * (rsqrt(var +
    eps) * scale) + bias on every row, in flax's order of operations; mean
    and var the running statistics in eval mode, the batch's in train mode.
    Parameters `scale`, `bias`; buffers `mean`, `var`."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.process_group = None  # data parallel: statistics over every rank's rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            f = x.shape[-1]
            rows = x.reshape(-1, f).to(torch.float32)
            sums = all_reduce_sum(torch.cat([rows.sum(0), (rows * rows).sum(0),
                                             rows.new_full((1,), rows.shape[0])]),
                                  self.process_group)
            mean, mean2 = sums[:f] / sums[-1], sums[f:2 * f] / sums[-1]
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class GatingContext(nn.Module):
    def __init__(self, dim: int, gen: torch.Generator):
        super().__init__()
        self.gating_weights = _trunc_normal((dim, dim), 1.0 / math.sqrt(dim), gen)
        self.bn = FlaxBatchNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.bn(x @ self.gating_weights))


class NetVLADLoupe(nn.Module):
    """With the BatchNorms the JAX package's `PoolingWrapper` always asks for
    (`add_batch_norm=True`)."""

    def __init__(self, feature_size: int, cluster_size: int, output_dim: int,
                 gen: torch.Generator, gating: bool = True):
        super().__init__()
        f, k = feature_size, cluster_size
        std = 1.0 / math.sqrt(f)
        self.cluster_weights = _trunc_normal((f, k), std, gen)
        self.cluster_bn = FlaxBatchNorm(k)
        self.cluster_weights2 = _trunc_normal((1, f, k), std, gen)
        self.hidden1_weights = _trunc_normal((f * k, output_dim), 1.0 / math.sqrt(f * k), gen)
        self.context_gating = GatingContext(output_dim, gen) if gating else None

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """feats (B, C, F), mask (B, C) -> (B, output_dim)."""
        b, _, f = feats.shape
        activation = self.cluster_bn(feats @ self.cluster_weights)      # (B, C, K)
        activation = torch.softmax(activation, dim=-1) * mask[..., None]
        a = activation.sum(1, keepdim=True) * self.cluster_weights2     # (B, F, K)
        vlad = torch.einsum("bck,bcf->bfk", activation, feats) - a
        vlad = l2_normalize(vlad, dim=1).reshape(b, -1)
        vlad = l2_normalize(vlad, dim=1) @ self.hidden1_weights
        if self.context_gating is not None:
            vlad = self.context_gating(vlad)
        return vlad
