"""Reference checkpoint converter (port of
`egonn_tpu/utils/checkpoint_convert.py`, kept as the port's own copy): a
reference (jac99/Egonn, MinkowskiEngine) `.pth` state dict becomes a
`{"params": ..., "batch_stats": ...}` tree of numpy arrays under the flax
names, which `utils/weights.py::load_flax_variables` moves into the port's
MinkGL (`convert_egonn_state_dict`) or MinkLoc3D (`convert_minkloc3d_state_dict`).

* ME conv kernels are (K, in, out) with the offsets in ME's region order,
  which depends on the kernel size's parity: odd kernels walk the centred
  cube [-r, r]^3 with x fastest, even kernels [0, k)^3 with z fastest
  (C order, as ours: the identity).  Ours are C order over (dx, dy, dz)
  (`sparse/pyramid.py::kernel_offsets`).
* 1x1 ME kernels are (in, out) matrices, as ours.
* MinkowskiBatchNorm `.bn.{weight, bias, running_mean, running_var}` ->
  `{scale, bias}` + batch_stats `{mean, var}`.
* torch Linear weight (out, in) -> ours (in, out).
* ECA's Conv1d weight (1, 1, k) -> (k,); GeM's p (1,) as is.

No published checkpoint is in the repository, so the mapping is held on
synthetic state dicts in the reference layout.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch


def me_offset_permutation(kernel_size: int) -> np.ndarray:
    """Permutation p with ours[k] = theirs[p[k]].  Odd k: the ME index of
    offset (dx, dy, dz) is (dx+r) + (dy+r) k + (dz+r) k^2; even k: the
    identity."""
    k = kernel_size
    if k % 2 == 0:
        return np.arange(k ** 3)
    r = k // 2
    return np.asarray([(dx + r) + (dy + r) * k + (dz + r) * k ** 2
                       for dx, dy, dz in itertools.product(range(-r, r + 1), repeat=3)])


def _conv(sd, name, kernel_size):
    w = np.asarray(sd[name])
    if w.ndim == 2:  # 1x1 kernel, (in, out)
        return w
    return w[me_offset_permutation(kernel_size)]


def _bn(sd, prefix):
    return ({"scale": np.asarray(sd[f"{prefix}.bn.weight"]),
             "bias": np.asarray(sd[f"{prefix}.bn.bias"])},
            {"mean": np.asarray(sd[f"{prefix}.bn.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.bn.running_var"])})


def _linear(sd, prefix):
    out = {"weight": np.asarray(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def _block(sd, prefix, use_eca):
    """ECABasicBlock / BasicBlock (reference layers/eca_block.py)."""
    params: Dict = {}
    stats: Dict = {}
    params["conv1"] = {"kernel": _conv(sd, f"{prefix}.conv1.kernel", 3)}
    params["norm1"], stats["norm1"] = _bn(sd, f"{prefix}.norm1")
    params["conv2"] = {"kernel": _conv(sd, f"{prefix}.conv2.kernel", 3)}
    params["norm2"], stats["norm2"] = _bn(sd, f"{prefix}.norm2")
    if use_eca and f"{prefix}.eca.conv.weight" in sd:
        params["eca"] = {"conv": np.asarray(sd[f"{prefix}.eca.conv.weight"])[0, 0]}
    if f"{prefix}.downsample.0.kernel" in sd:
        params["downsample_conv"] = {"kernel": _conv(sd, f"{prefix}.downsample.0.kernel", 1)}
        params["downsample_norm"], stats["downsample_norm"] = _bn(sd, f"{prefix}.downsample.1")
    return params, stats


def _mlp2(sd, prefix):
    """2-layer heads: reference nn.Sequential indices 0 and 2."""
    return {"fc1": _linear(sd, f"{prefix}.net.0.linear"),
            "fc2": _linear(sd, f"{prefix}.net.2.linear")}


def _head(sd, prefix, in_levels):
    params: Dict = {}
    for lvl in in_levels:
        params[f"conv1x1_{lvl}"] = {"kernel": _conv(sd, f"{prefix}.conv1x1.{lvl}.kernel", 1)}
    for lvl in range(min(in_levels) + 1, max(in_levels) + 1):
        params[f"tconv_{lvl}"] = {"kernel": _conv(sd, f"{prefix}.tconv.{lvl}.kernel", 2)}
    return params


def _numpy(sd: Dict) -> Dict:
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}


def convert_egonn_state_dict(sd: Dict) -> Dict:
    """Reference MinkGL state dict (the published EgoNN: 7 levels of ECA
    blocks, global head on levels 5-7, local head on 3-4) -> variables of
    the port's MinkGL."""
    sd = _numpy(sd)
    trunk_p: Dict = {}
    trunk_s: Dict = {}
    trunk_p["conv0"] = {"kernel": _conv(sd, "trunk.convs.0.kernel", 5)}
    trunk_p["bn0"], trunk_s["bn0"] = _bn(sd, "trunk.bn.0")
    for i in range(1, 8):
        trunk_p[f"conv{i}"] = {"kernel": _conv(sd, f"trunk.convs.{i}.kernel", 2)}
        trunk_p[f"bn{i}"], trunk_s[f"bn{i}"] = _bn(sd, f"trunk.bn.{i}")
        trunk_p[f"block{i}_0"], trunk_s[f"block{i}_0"] = _block(sd, f"trunk.blocks.{i}.0",
                                                               use_eca=True)
    params = {
        "trunk": trunk_p,
        "global_head": _head(sd, "global_head", (5, 6, 7)),
        "local_head": _head(sd, "local_head", (3, 4)),
        "global_pooling": {"gem": {"p": np.asarray(sd["global_pooling.pooling.p"])}},
    }
    for mod in ("global_descriptor_decoder", "local_descriptor_decoder",
                "local_keypoint_regressor", "local_sigma_regressor"):
        params[mod] = _mlp2(sd, mod)
    return {"params": params, "batch_stats": {"trunk": trunk_s}}


def convert_minkloc3d_state_dict(sd: Dict) -> Dict:
    """Reference MinkLoc3D state dict (third_party/minkloc3d: MinkFPN planes
    32/64/64, layers 1/1/1, one top-down step, conv0 k=5, GeM) -> variables
    of the port's frozen MinkLoc3D.  Keys: `backbone.conv0/bn0`,
    `backbone.convs.{i}` + `backbone.bn.{i}`, blocks at
    `backbone.blocks.{i}.{j}`, the 1x1 convs at `backbone.conv1x1.{j}`, the
    transposed convs at `backbone.tconvs.{j}`, GeM's `pooling.p`."""
    sd = _numpy(sd)
    bp: Dict = {}
    bs: Dict = {}
    bp["conv0"] = {"kernel": _conv(sd, "backbone.conv0.kernel", 5)}
    bp["bn0"], bs["bn0"] = _bn(sd, "backbone.bn0")
    for i in range(3):
        lvl = i + 1
        bp[f"conv{lvl}"] = {"kernel": _conv(sd, f"backbone.convs.{i}.kernel", 2)}
        bp[f"bn{lvl}"], bs[f"bn{lvl}"] = _bn(sd, f"backbone.bn.{i}")
        bp[f"block{lvl}_0"], bs[f"block{lvl}_0"] = _block(sd, f"backbone.blocks.{i}.0",
                                                          use_eca=False)
    for j in range(2):
        bp[f"conv1x1_{j}"] = {"kernel": _conv(sd, f"backbone.conv1x1.{j}.kernel", 1)}
    bp["tconv0"] = {"kernel": _conv(sd, "backbone.tconvs.0.kernel", 2)}
    return {"params": {"backbone": bp, "pooling": {"gem": {"p": np.asarray(sd["pooling.p"])}}},
            "batch_stats": {"backbone": bs}}


def load_reference_checkpoint(path: str, model: str = "egonn") -> Dict:
    """Read a reference `.pth` (tensors only, on the CPU) and convert it;
    model "egonn" or "MinkLoc3D"."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if model == "MinkLoc3D":
        return convert_minkloc3d_state_dict(sd)
    return convert_egonn_state_dict(sd)
