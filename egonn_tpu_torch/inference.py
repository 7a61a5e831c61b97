"""The port's entry point: the inference forward of a batch of clouds through
a model of `models/factory.py` (EgoNN, MinkLoc or MinkUNet), quantize ->
build_pyramid -> model (the counterpart of `bench.py`'s jitted forward)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from egonn_tpu_torch.models.factory import BuiltModel
from egonn_tpu_torch.sparse.pyramid import build_pyramid
from egonn_tpu_torch.utils.tracing import span


@torch.no_grad()
def forward(built: BuiltModel, clouds: torch.Tensor, mask: torch.Tensor,
            with_local: bool = True, feats: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
    """clouds (B, N, 3) float32 cartesian points, mask (B, N) bool, both on
    `built.device`; feats (B, N, in_channels) float32 per-point features,
    for MinkUNet alone (which takes them and no other model does).  The
    quantizer packs keys with the pyramid spec's `pack`.  Returns the
    model's outputs: `global` (B, output_dim) and, for EgoNN at the local
    head's level unless `with_local` is False, `descriptors`, `keypoints`,
    `sigma`, `kp_mask`; for MinkUNet `logits` (B, N, num_classes) and
    `point_mask` (B, N), zero logits and False for a point that is masked,
    outside the pack's range or in a voxel beyond level 0's capacity."""
    with span("egonn.forward"):
        spec = built.pyramid_spec
        segment = built.model_type == "minkunet"
        if (feats is not None) != segment:
            raise ValueError(f"per-point features are {'required' if segment else 'not taken'}"
                             f" by a {built.model_type} model")
        for name, t in (("clouds", clouds), ("mask", mask), ("feats", feats)):
            if t is not None and t.device != built.device:
                raise ValueError(f"{name} on {t.device}, the model on {built.device}")
        res = built.quantizer.quantize(clouds, mask, spec.capacities[0], need_index=False,
                                       pack=spec.pack, need_inverse=segment)
        pyramid = build_pyramid(res.coords_t, res.mask, spec, keys0=res.keys)
        if segment:
            return built.model(pyramid, res, feats)
        if built.model_type == "egonn":
            return built.model(pyramid, built.quantizer, disable_local_head=not with_local)
        return built.model(pyramid, built.quantizer)
