"""MinkLoc3D (MinkFPN + GeM): the program's model from
`egonn_tpu_torch.models.factory` and the reference's MinkLoc, both from
configs/minkloc3d_mulran.json."""
from __future__ import annotations

from types import SimpleNamespace

from benchmark.reference import models, sparse

OUTPUTS = ("global",)


def program(cfg: dict, device):
    from egonn_tpu_torch.models.factory import model_factory
    from egonn_tpu_torch.ops.quantization import CartesianQuantizer

    m = cfg["model"]
    params = SimpleNamespace(
        model=m["model"], cap0=m["cap0"], quantizer=CartesianQuantizer(m["quantization_step"]),
        planes=m["planes"], layers=m["layers"], num_top_down=m["num_top_down"],
        conv0_kernel_size=m["conv0_kernel_size"], block=m["block"], pooling=m["pooling"],
        feature_size=m["feature_size"], output_dim=m["output_dim"])
    return model_factory(params, device=device)


def reference(cfg: dict):
    """(model, quantizer, pyramid spec) of the reference, on the CPU."""
    m = cfg["model"]
    spec = sparse.minkloc_spec(m["cap0"], len(m["planes"]), m["conv0_kernel_size"])
    return models.MinkLoc(cfg), sparse.CartesianQuantizer(m["quantization_step"]), spec
