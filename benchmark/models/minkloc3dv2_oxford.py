"""MinkLoc3Dv2 (MinkFPN 64/128/64/32, two top-down steps, ECA, GeM, cartesian
0.01 on normalized submaps): the program's model from
`egonn_tpu_torch.models.factory` with the configuration's capacity table,
its staged train step's parameters, and the reference's MinkLoc, all from
configs/minkloc3dv2_oxford.json."""
from __future__ import annotations

from types import SimpleNamespace

from benchmark.reference import models, sparse, staged

OUTPUTS = ("global",)


def program(cfg: dict, device):
    from egonn_tpu_torch.models.factory import model_factory
    from egonn_tpu_torch.ops.quantization import CartesianQuantizer

    m = cfg["model"]
    params = SimpleNamespace(
        model=m["model"], cap0=m["cap0"], capacities=list(m["capacities"]),
        quantizer=CartesianQuantizer(m["quantization_step"]), planes=m["planes"],
        layers=m["layers"], num_top_down=m["num_top_down"],
        conv0_kernel_size=m["conv0_kernel_size"], block=m["block"], pooling=m["pooling"],
        feature_size=m["feature_size"], output_dim=m["output_dim"])
    return model_factory(params, device=device)


def train_params(cfg: dict):
    t = cfg["train"]
    return SimpleNamespace(
        batch_split_size=t["batch_split_size"], aug_mode=t["aug_mode"],
        dataset=t["dataset"], loss=t["loss"],
        tau1=t["tau1"], positives_per_query=t["positives_per_query"],
        similarity=t["similarity"], lr=t["lr"], weight_decay=t["weight_decay"])


def reference(cfg: dict):
    """(model, quantizer, pyramid spec) of the reference, on the CPU."""
    m = cfg["model"]
    spec = staged.reference_spec(m["capacities"], m["conv0_kernel_size"])
    return models.MinkLoc(cfg), sparse.CartesianQuantizer(m["quantization_step"]), spec
