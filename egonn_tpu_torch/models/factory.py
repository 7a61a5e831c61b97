"""Model factory (port of `egonn_tpu/models/factory.py`).

* `create_egonn_model`: the published EgoNN architecture — ECA blocks,
  planes (32, 64, 64, 128, 128, 128, 128), global head on levels {5, 6, 7}
  -> 128 ch -> 256-d GeM descriptor, local head on levels {3, 4} -> 64 ch ->
  128-d L2-normalised descriptors + keypoint and sigma regressors — with its
  pyramid spec.
* `create_minkloc_model`: MinkLoc (global descriptor only) from the model
  parameters, or frozen as the published MinkLoc3D (planes 32/64/64, layers
  1/1/1, one top-down step, conv0 k=5, BasicBlock, GeM, 256-d).  Capacities
  max(256, cap0 >> min(l, 4)); every level records its up map.
* `model_factory`: dispatch on the model name (`MinkLoc3D`, `MinkLoc*` /
  `MinkFPN*`, `egonn`).

Each builds its model in eval mode on `device`, with weights drawn from a
`torch.Generator` seeded with `seed`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import nn

from egonn_tpu_torch.models.minkgl import MinkGL
from egonn_tpu_torch.models.minkloc import MinkLoc
from egonn_tpu_torch.ops.quantization import AnyQuantizer
from egonn_tpu_torch.sparse.pyramid import PyramidSpec, egonn_pyramid_spec

Device = Union[str, torch.device]


@dataclass
class BuiltModel:
    model: nn.Module          # MinkGL or MinkLoc
    quantizer: AnyQuantizer
    pyramid_spec: PyramidSpec
    model_type: str           # 'egonn' | 'minkloc'
    device: torch.device


def _built(model: nn.Module, quantizer, spec: PyramidSpec, model_type: str,
           device: Device) -> BuiltModel:
    model = model.to(torch.device(device)).eval()
    device = next(model.parameters()).device  # e.g. "cuda" resolves to "cuda:0"
    return BuiltModel(model, quantizer, spec, model_type, device)


def create_egonn_model(model_params, cap0: Optional[int] = None,
                       device: Device = torch.device("cuda"), seed: int = 0) -> BuiltModel:
    """model_params needs `.model == "egonn"`, `.quantizer` (a port quantizer)
    and `.cap0` (used when `cap0` is None)."""
    if model_params.model != "egonn":
        raise NotImplementedError(f"Unknown model: {model_params.model}")
    planes = (32, 64, 64, 128, 128, 128, 128)
    layers = (1, 1, 1, 1, 1, 1, 1)
    gen = torch.Generator().manual_seed(seed)
    model = MinkGL(
        trunk_planes=planes, trunk_layers=layers, gen=gen, conv0_kernel_size=5,
        block="ECABasicBlock", in_channels=1,
        global_in_levels=(5, 6, 7), global_map_channels=128,
        global_descriptor_size=256, global_pool_method="GeM", global_normalize=False,
        local_in_levels=(3, 4), local_map_channels=64,
        local_descriptor_size=128, local_normalize=True,
    )
    spec = egonn_pyramid_spec(cap0=cap0 or model_params.cap0, num_levels=len(planes))
    return _built(model, model_params.quantizer, spec, "egonn", device)


def create_minkloc_model(model_params, cap0: Optional[int] = None,
                         frozen_minkloc3d: bool = False,
                         device: Device = torch.device("cuda"), seed: int = 0) -> BuiltModel:
    """model_params needs `.quantizer` and `.cap0`, and unless frozen the
    MinkLoc fields of a `config.ModelParams` (`planes`, `layers`,
    `num_top_down`, `conv0_kernel_size`, `block`, `pooling`, `feature_size`,
    `output_dim`)."""
    if frozen_minkloc3d:
        planes, layers, num_top_down, conv0, block, pooling = (
            (32, 64, 64), (1, 1, 1), 1, 5, "BasicBlock", "GeM")
        feature_size = output_dim = 256
    else:
        planes, layers = tuple(model_params.planes), tuple(model_params.layers)
        num_top_down, conv0 = model_params.num_top_down, model_params.conv0_kernel_size
        block, pooling = model_params.block, model_params.pooling
        feature_size, output_dim = model_params.feature_size, model_params.output_dim
    gen = torch.Generator().manual_seed(seed)
    model = MinkLoc(in_channels=1, feature_size=feature_size, output_dim=output_dim,
                    planes=planes, layers=layers, num_top_down=num_top_down,
                    conv0_kernel_size=conv0, gen=gen, block=block, pooling_method=pooling)
    num_levels = len(planes)
    c0 = cap0 or model_params.cap0
    spec = PyramidSpec(
        capacities=tuple(max(256, c0 >> min(l, 4)) for l in range(num_levels + 1)),
        conv0_kernel_size=conv0,
        block_kernel_size=3,
        self_levels=tuple(range(1, num_levels + 1)),
        up_levels=tuple(range(0, num_levels)),
        conv0_ones=True,  # MinkLoc feeds constant-ones 1-channel features too
    )
    return _built(model, model_params.quantizer, spec, "minkloc", device)


def model_factory(model_params, cap0: Optional[int] = None,
                  device: Device = torch.device("cuda"), seed: int = 0) -> BuiltModel:
    name = model_params.model or ""
    if name == "MinkLoc3D":
        return create_minkloc_model(model_params, cap0, frozen_minkloc3d=True, device=device,
                                    seed=seed)
    if "MinkLoc" in name or "MinkFPN" in name:
        return create_minkloc_model(model_params, cap0, device=device, seed=seed)
    if "egonn" in name:
        return create_egonn_model(model_params, cap0, device=device, seed=seed)
    raise NotImplementedError(f"Model not implemented: {name}")
