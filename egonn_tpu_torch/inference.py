"""The port's entry point: the inference forward of a batch of clouds through
a model of `models/factory.py` (EgoNN or MinkLoc), quantize -> build_pyramid
-> model (the counterpart of `bench.py`'s jitted forward)."""
from __future__ import annotations

from typing import Dict

import torch

from egonn_tpu_torch.models.factory import BuiltModel
from egonn_tpu_torch.sparse.pyramid import build_pyramid
from egonn_tpu_torch.utils.tracing import span


@torch.no_grad()
def forward(built: BuiltModel, clouds: torch.Tensor, mask: torch.Tensor,
            with_local: bool = True) -> Dict[str, torch.Tensor]:
    """clouds (B, N, 3) float32 cartesian points, mask (B, N) bool, both on
    `built.device`.  Returns the model's outputs: `global` (B, output_dim)
    and, for EgoNN at the local head's level unless `with_local` is False,
    `descriptors`, `keypoints`, `sigma`, `kp_mask`."""
    with span("egonn.forward"):
        spec = built.pyramid_spec
        for name, t in (("clouds", clouds), ("mask", mask)):
            if t.device != built.device:
                raise ValueError(f"{name} on {t.device}, the model on {built.device}")
        res = built.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False)
        pyramid = build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)
        if built.model_type == "egonn":
            return built.model(pyramid, built.quantizer, disable_local_head=not with_local)
        return built.model(pyramid, built.quantizer)
