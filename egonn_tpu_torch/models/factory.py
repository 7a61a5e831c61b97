"""Model factory (port of `egonn_tpu/models/factory.py:22-60`): the published
EgoNN architecture — ECA blocks, planes (32, 64, 64, 128, 128, 128, 128),
global head on levels {5, 6, 7} -> 128 ch -> 256-d GeM descriptor, local head
on levels {3, 4} -> 64 ch -> 128-d L2-normalised descriptors + keypoint and
sigma regressors — with its pyramid spec.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from egonn_tpu_torch.models.minkgl import MinkGL
from egonn_tpu_torch.ops.quantization import AnyQuantizer
from egonn_tpu_torch.sparse.pyramid import PyramidSpec, egonn_pyramid_spec


@dataclass
class BuiltModel:
    model: MinkGL
    quantizer: AnyQuantizer
    pyramid_spec: PyramidSpec
    model_type: str
    device: torch.device


def create_egonn_model(model_params, cap0: Optional[int] = None,
                       device: Union[str, torch.device] = torch.device("cuda"),
                       seed: int = 0) -> BuiltModel:
    """Build EgoNN in eval mode on `device`, with weights drawn from a
    `torch.Generator` seeded with `seed`.

    model_params needs `.model == "egonn"`, `.quantizer` (a port quantizer)
    and `.cap0` (used when `cap0` is None)."""
    if model_params.model != "egonn":
        raise NotImplementedError(f"Unknown model: {model_params.model}")
    planes = (32, 64, 64, 128, 128, 128, 128)
    layers = (1, 1, 1, 1, 1, 1, 1)
    global_in_levels = (5, 6, 7)
    local_in_levels = (3, 4)
    gen = torch.Generator().manual_seed(seed)
    model = MinkGL(
        trunk_planes=planes, trunk_layers=layers, gen=gen, conv0_kernel_size=5,
        block="ECABasicBlock", in_channels=1,
        global_in_levels=global_in_levels, global_map_channels=128,
        global_descriptor_size=256, global_pool_method="GeM", global_normalize=False,
        local_in_levels=local_in_levels, local_map_channels=64,
        local_descriptor_size=128, local_normalize=True,
    )
    model = model.to(torch.device(device)).eval()
    device = next(model.parameters()).device  # e.g. "cuda" resolves to "cuda:0"
    spec = egonn_pyramid_spec(cap0=cap0 or model_params.cap0, num_levels=len(planes))
    return BuiltModel(model, model_params.quantizer, spec, "egonn", device)
