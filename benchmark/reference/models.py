"""EgoNN (MinkGL: ECA trunk, global and local FPN heads) and MinkLoc3D
(MinkFPN + GeM), plain PyTorch, with the module and parameter names of the
port's models so that one state dict loads into both.

Every sparse conv is a gather per kernel offset and a matmul; down convs
gather over the coarse level's `kmap_down`; BatchNorm is masked (batch
statistics in train mode, running statistics otherwise); autograd gives
the gradients.  Each conv and dense product appends a record of its shape
and valid map entries to `WORK` while a list is installed there
(`record_work`), and, where autograd later runs its backward, the records of
its two backward products: the benchmark counts operations and bytes from
these, never from the program's kernel arguments.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.sparse import Level

WORK: Optional[List[dict]] = None


@contextlib.contextmanager
def record_work(log: List[dict]):
    global WORK
    prev, WORK = WORK, log
    try:
        yield log
    finally:
        WORK = prev


def _record(role: str, out: torch.Tensor, backward: tuple, **shape) -> None:
    """Append the forward record, and hook the backward records on `out`'s
    gradient: `backward` names the roles of dX and dW (None: not counted)."""
    if WORK is None:
        return
    log = WORK
    log.append(dict(role=role, train=out.requires_grad, **shape))
    if out.requires_grad:
        def hook(grad, shape=shape):
            for r in backward:
                if r is not None:
                    log.append(dict(role=r, train=True, **shape))
        out.register_hook(hook)


def masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return x * mask[..., None].to(x.dtype)


def _nnz(kmap: torch.Tensor, c_in: int) -> int:
    return int(((kmap >= 0) & (kmap < c_in)).sum())


def gather_conv(feats: torch.Tensor, kmap: torch.Tensor, kernel: torch.Tensor,
                role: str) -> torch.Tensor:
    """out[b, c] = sum_k feats[b, kmap[b, k, c]] @ kernel[k]; the sentinel
    gathers a zero row."""
    b, c_in, f_in = feats.shape
    feats_p = torch.cat([feats, feats.new_zeros(b, 1, f_in)], dim=1)
    idx = torch.where((kmap >= 0) & (kmap < c_in), kmap, c_in).long()
    out = feats.new_zeros(b, kmap.shape[2], kernel.shape[2])
    for k in range(kmap.shape[1]):
        out = out + torch.gather(feats_p, 1, idx[:, k, :, None].expand(-1, -1, f_in)) @ kernel[k]
    if WORK is not None:
        _record(role, out, (f"{role}_dx", f"{role}_dw"), b=b, c_in=c_in, f_in=f_in,
                k=kmap.shape[1], c_out=kmap.shape[2], f_out=kernel.shape[2],
                nnz=_nnz(kmap, c_in))
    return out


def conv_ones(kmap: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The stem over constant-ones features: the sum of the kernel rows of
    the offsets whose neighbour exists."""
    valid = (kmap < kmap.shape[-1]).to(kernel.dtype)
    out = torch.matmul(valid.transpose(1, 2), kernel[:, 0, :])
    if WORK is not None:
        _record("ones", out, (None, "ones_dw"), b=kmap.shape[0], c_in=kmap.shape[2], f_in=1,
                k=kmap.shape[1], c_out=kmap.shape[2], f_out=kernel.shape[2],
                nnz=_nnz(kmap, kmap.shape[2]))
    return out


def tconv2x2(feats: torch.Tensor, fine: Level, kernel: torch.Tensor) -> torch.Tensor:
    """Transposed k=2 s=2 conv onto the finer level:
    out[c] = feats[up_parent[c]] @ kernel[up_koffset[c]]."""
    b, c_coarse, f_in = feats.shape
    feats_p = torch.cat([feats, feats.new_zeros(b, 1, f_in)], dim=1)
    g = torch.gather(feats_p, 1, fine.up_parent.long()[..., None].expand(-1, -1, f_in))
    f_out = kernel.shape[2]
    every_slot = (g @ kernel.permute(1, 0, 2).reshape(f_in, 8 * f_out)).reshape(b, -1, 8, f_out)
    slot = fine.up_koffset.long()[..., None, None].expand(-1, -1, 1, f_out)
    out = torch.gather(every_slot, 2, slot)[:, :, 0, :]
    if WORK is not None:
        valid = (fine.up_parent >= 0) & (fine.up_parent < c_coarse)
        _record("tconv", out, ("tconv_dx", "tconv_dw"), b=b, c_in=c_coarse, f_in=f_in, k=8,
                c_out=fine.up_parent.shape[1], f_out=kernel.shape[2], nnz=int(valid.sum()))
    return out


def dense(x: torch.Tensor, weight: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    out = x @ weight
    if WORK is not None:
        rows = int(mask.sum()) if mask is not None else x.shape[0] * x.shape[1]
        _record("dense", out, ("dense_dx", "dense_dw"), b=x.shape[0], c_in=x.shape[1],
                f_in=weight.shape[0], k=1, c_out=x.shape[1], f_out=weight.shape[1], nnz=rows)
    return out


class SparseConv(nn.Module):
    def __init__(self, f_in: int, f_out: int, k_vol: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k_vol, f_in, f_out))


class SparseConv1x1(nn.Module):
    def __init__(self, f_in: int, f_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(f_in, f_out))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, mask)


class SparseConvTranspose2x2(nn.Module):
    def __init__(self, f_in: int, f_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(8, f_in, f_out))


class SparseBatchNorm(nn.Module):
    """Masked BatchNorm: train mode normalises by the valid voxels' mean and
    biased variance and moves the running statistics by 0.1 towards the
    mean and the unbiased variance; eval mode uses the running ones."""

    def __init__(self, n: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask[..., None].to(x.dtype)
            cnt = torch.clamp_min(m.sum(), 1.0)
            mean = (x * m).sum((0, 1)) / cnt
            var = (((x * m) - mean) ** 2 * m).sum((0, 1)) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
                self.mean.copy_(0.9 * self.mean + 0.1 * mean)
                self.var.copy_(0.9 * self.var + 0.1 * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + 1e-5) * self.scale + self.bias
        return masked(y, mask)


def avg_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)


class ECALayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        t = int(abs((np.log2(channels) + 1) / 2))
        self.k_size = t if t % 2 else t + 1
        self.conv = nn.Parameter(torch.zeros(self.k_size))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        y = avg_pool(x, mask)
        pad = (self.k_size - 1) // 2
        y = torch.sigmoid(F.pad(y, (pad, pad)).unfold(1, self.k_size, 1) @ self.conv)
        return x * y[:, None, :]


class BasicBlock(nn.Module):
    def __init__(self, f_in: int, f_out: int, use_eca: bool):
        super().__init__()
        self.conv1 = SparseConv(f_in, f_out, 27)
        self.norm1 = SparseBatchNorm(f_out)
        self.conv2 = SparseConv(f_out, f_out, 27)
        self.norm2 = SparseBatchNorm(f_out)
        self.eca = ECALayer(f_out) if use_eca else None
        if f_in != f_out:
            self.downsample_conv = SparseConv1x1(f_in, f_out)
            self.downsample_norm = SparseBatchNorm(f_out)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor, lvl: Level) -> torch.Tensor:
        out = torch.relu(self.norm1(gather_conv(x, lvl.kmap_self, self.conv1.kernel, "self"),
                                    lvl.mask))
        out = self.norm2(gather_conv(out, lvl.kmap_self, self.conv2.kernel, "self"), lvl.mask)
        if self.eca is not None:
            out = self.eca(out, lvl.mask)
        res = x
        if self.downsample_conv is not None:
            res = self.downsample_norm(self.downsample_conv(x, lvl.mask), lvl.mask)
        return masked(torch.relu(out + res), lvl.mask)


def down(conv: SparseConv, bn: SparseBatchNorm, x: torch.Tensor, lvl: Level) -> torch.Tensor:
    return torch.relu(bn(gather_conv(x, lvl.kmap_down, conv.kernel, "down"), lvl.mask))


class Linear(nn.Module):
    def __init__(self, f_in: int, f_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(f_in, f_out))
        self.bias = nn.Parameter(torch.zeros(f_out))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        return dense(x, self.weight, mask) + self.bias


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), 1e-24))


class DescriptorDecoder(nn.Module):
    def __init__(self, f_in: int, f_out: int, normalize: bool):
        super().__init__()
        mid = f_out + (f_in - f_out) // 2
        self.fc1, self.fc2, self.normalize = Linear(f_in, mid), Linear(mid, f_out), normalize

    def forward(self, x, mask):
        x = self.fc2(torch.relu(self.fc1(x, mask)), mask)
        return l2_normalize(x) if self.normalize else x


class MLPRegressor(nn.Module):
    def __init__(self, f_in: int, f_out: int, activation: str):
        super().__init__()
        self.fc1, self.fc2 = Linear(f_in, f_in // 2), Linear(f_in // 2, f_out)
        self.activation = activation

    def forward(self, x, mask):
        x = self.fc2(torch.relu(self.fc1(x, mask)), mask)
        if self.activation == "tanh":
            return torch.tanh(x)
        return torch.logaddexp(x, torch.zeros_like(x))  # softplus


class GeM(nn.Module):
    def __init__(self):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), 3.0))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        eps = 1e-6
        y = avg_pool(masked(torch.clamp_min(x, eps) ** self.p, mask), mask)
        return torch.maximum(y, eps ** self.p) ** (1.0 / self.p)


class PoolingWrapper(nn.Module):
    def __init__(self):
        super().__init__()
        self.gem = GeM()


class MinkHead(nn.Module):
    """Top-down FPN: 1x1 on the top level, then per level down a transposed
    conv plus a 1x1 lateral where the level is an input."""

    def __init__(self, in_levels, in_channels, out_channels: int):
        super().__init__()
        self.in_d = dict(zip(in_levels, in_channels))
        self.lo, self.hi = min(in_levels), max(in_levels)
        setattr(self, f"conv1x1_{self.hi}", SparseConv1x1(self.in_d[self.hi], out_channels))
        for level in range(self.hi - 1, self.lo - 1, -1):
            setattr(self, f"tconv_{level + 1}", SparseConvTranspose2x2(out_channels, out_channels))
            if level in self.in_d:
                setattr(self, f"conv1x1_{level}", SparseConv1x1(self.in_d[level], out_channels))

    def forward(self, pyr: List[Level], trunk: Dict[int, torch.Tensor]) -> torch.Tensor:
        y = getattr(self, f"conv1x1_{self.hi}")(trunk[self.hi], pyr[self.hi].mask)
        for level in range(self.hi - 1, self.lo - 1, -1):
            y = tconv2x2(y, pyr[level], getattr(self, f"tconv_{level + 1}").kernel)
            if level in self.in_d:
                y = y + getattr(self, f"conv1x1_{level}")(trunk[level], pyr[level].mask)
        return masked(y, pyr[self.lo].mask)


class MinkTrunk(nn.Module):
    def __init__(self, planes, conv0_kernel_size: int, use_eca: bool):
        super().__init__()
        self.n = len(planes)
        inplanes = planes[0]
        self.conv0 = SparseConv(1, inplanes, conv0_kernel_size ** 3)
        self.bn0 = SparseBatchNorm(inplanes)
        for i, plane in enumerate(planes, start=1):
            setattr(self, f"conv{i}", SparseConv(inplanes, inplanes, 8))
            setattr(self, f"bn{i}", SparseBatchNorm(inplanes))
            setattr(self, f"block{i}_0", BasicBlock(inplanes, plane, use_eca))
            inplanes = plane

    def forward(self, pyr: List[Level]) -> Dict[int, torch.Tensor]:
        x = masked(torch.relu(self.bn0(conv_ones(pyr[0].kmap_self, self.conv0.kernel),
                                       pyr[0].mask)), pyr[0].mask)
        out = {}
        for i in range(1, self.n + 1):
            x = down(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), x, pyr[i])
            x = getattr(self, f"block{i}_0")(x, pyr[i])
            out[i] = x
        return out


class MinkGL(nn.Module):
    """EgoNN: trunk planes (32, 64, 64, 128, 128, 128, 128), global head on
    levels 5-7 -> 128 -> 256-d GeM, local head on levels 3-4 -> 64 ->
    128-d normalised descriptors, tanh keypoint offsets, softplus sigma."""

    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        planes = tuple(m["planes"])
        self.g_levels, self.l_levels = tuple(m["global_in_levels"]), tuple(m["local_in_levels"])
        self.trunk = MinkTrunk(planes, m["conv0_kernel_size"], m["block"] == "ECABasicBlock")
        gmap, lmap = m["global_map_channels"], m["local_map_channels"]
        self.global_head = MinkHead(self.g_levels, [planes[i - 1] for i in self.g_levels], gmap)
        self.global_descriptor_decoder = DescriptorDecoder(gmap, m["global_descriptor_size"],
                                                           normalize=False)
        self.global_pooling = PoolingWrapper()
        self.local_head = MinkHead(self.l_levels, [planes[i - 1] for i in self.l_levels], lmap)
        self.local_descriptor_decoder = DescriptorDecoder(lmap, m["local_descriptor_size"],
                                                          normalize=True)
        self.local_keypoint_regressor = MLPRegressor(lmap, 3, "tanh")
        self.local_sigma_regressor = MLPRegressor(lmap, 1, "softplus")

    def forward(self, pyr: List[Level], quantizer, with_local: bool = True):
        trunk = self.trunk(pyr)
        gm = pyr[min(self.g_levels)].mask
        xg = self.global_descriptor_decoder(self.global_head(pyr, trunk), gm)
        y = {"global": self.global_pooling.gem(masked(xg, gm), gm)}
        if with_local:
            lv = min(self.l_levels)
            lvl = pyr[lv]
            xl = self.local_head(pyr, trunk)
            y["descriptors"] = masked(self.local_descriptor_decoder(xl, lvl.mask), lvl.mask)
            kp = quantizer.keypoint_position(lvl.coords_rows * 2 ** lv, 2 ** lv,
                                             self.local_keypoint_regressor(xl, lvl.mask))
            y["keypoints"] = masked(kp, lvl.mask)
            y["kp_mask"] = lvl.mask
            y["sigma"] = masked(self.local_sigma_regressor(xl, lvl.mask), lvl.mask)
        return y


class MinkFPN(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        m = cfg["model"]
        planes, self.ntd = tuple(m["planes"]), m["num_top_down"]
        self.nb = len(planes)
        inplanes = planes[0]
        self.conv0 = SparseConv(1, inplanes, m["conv0_kernel_size"] ** 3)
        self.bn0 = SparseBatchNorm(inplanes)
        widths = [inplanes]
        for i, plane in enumerate(planes, start=1):
            setattr(self, f"conv{i}", SparseConv(inplanes, inplanes, 8))
            setattr(self, f"bn{i}", SparseBatchNorm(inplanes))
            setattr(self, f"block{i}_0", BasicBlock(inplanes, plane,
                                                    m["block"] == "ECABasicBlock"))
            inplanes = plane
            widths.append(plane)
        self.conv1x1_0 = SparseConv1x1(planes[-1], m["feature_size"])
        for j in range(self.ntd):
            setattr(self, f"tconv{j}", SparseConvTranspose2x2(m["feature_size"],
                                                               m["feature_size"]))
            setattr(self, f"conv1x1_{j + 1}", SparseConv1x1(widths[self.nb - 1 - j],
                                                            m["feature_size"]))

    def forward(self, pyr: List[Level]):
        x = masked(torch.relu(self.bn0(conv_ones(pyr[0].kmap_self, self.conv0.kernel),
                                       pyr[0].mask)), pyr[0].mask)
        laterals = {0: x} if self.ntd == self.nb else {}
        for i in range(1, self.nb + 1):
            x = down(getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), x, pyr[i])
            x = getattr(self, f"block{i}_0")(x, pyr[i])
            if self.nb - self.ntd <= i < self.nb:
                laterals[i] = x
        x = self.conv1x1_0(x, pyr[self.nb].mask)
        level = self.nb
        for j in range(self.ntd):
            level -= 1
            x = tconv2x2(x, pyr[level], getattr(self, f"tconv{j}").kernel)
            x = x + getattr(self, f"conv1x1_{j + 1}")(laterals[level], pyr[level].mask)
        return masked(x, pyr[level].mask), level


class MinkLoc(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.backbone = MinkFPN(cfg)
        self.pooling = PoolingWrapper()

    def forward(self, pyr: List[Level], quantizer=None, with_local: bool = False):
        x, level = self.backbone(pyr)
        return {"global": self.pooling.gem(x, pyr[level].mask)}


# offsets of a kernel that a voxel of a LiDAR scan finds filled, about
FILLED_OFFSETS = {125: 6, 27: 8, 8: 2.5}


def param_kinds(model: nn.Module) -> Dict[str, tuple]:
    """{state-dict name: (kind, fan_in)} for the seeded weights; a sparse
    conv's fan_in counts the offsets a voxel finds filled."""
    kinds = {}
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, SparseConv):
            k, f_in, _ = mod.kernel.shape
            kinds[pre + "kernel"] = ("conv", f_in * FILLED_OFFSETS.get(k, k))
        elif isinstance(mod, SparseConvTranspose2x2):
            kinds[pre + "kernel"] = ("conv", mod.kernel.shape[1])
        elif isinstance(mod, SparseConv1x1):
            kinds[pre + "kernel"] = ("dense", mod.kernel.shape[0])
        elif isinstance(mod, Linear):
            kinds[pre + "weight"] = ("dense", mod.weight.shape[0])
            kinds[pre + "bias"] = ("bias", mod.weight.shape[0])
        elif isinstance(mod, SparseBatchNorm):
            for name in ("scale", "bias", "mean", "var"):
                kinds[pre + name] = ("bn_" + name, 1)
        elif isinstance(mod, ECALayer):
            kinds[pre + "conv"] = ("eca", mod.k_size)
        elif isinstance(mod, GeM):
            kinds[pre + "p"] = ("gem", 1)
    return kinds


MODELS = {"MinkGL": MinkGL, "MinkLoc": MinkLoc}
