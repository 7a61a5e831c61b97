"""EgoNN: the program's model from `egonn_tpu_torch.models.factory` and the
reference's MinkGL, both from configs/egonn.json."""
from __future__ import annotations

from types import SimpleNamespace

from benchmark.reference import models, sparse

OUTPUTS = ("global", "descriptors", "keypoints", "sigma", "kp_mask")


def program(cfg: dict, device):
    from egonn_tpu_torch.models.factory import model_factory
    from egonn_tpu_torch.ops.quantization import PolarQuantizer

    m = cfg["model"]
    params = SimpleNamespace(model=m["model"], cap0=m["cap0"],
                             quantizer=PolarQuantizer(m["quantization_step"]))
    return model_factory(params, device=device)


def train_params(cfg: dict):
    t = cfg["train"]
    return SimpleNamespace(aug_mode=t["aug_mode"], loss=t["loss"], margin=t["margin"],
                           loss_gammas=tuple(t["loss_gammas"]), lr=t["lr"],
                           weight_decay=t["weight_decay"])


def reference(cfg: dict):
    """(model, quantizer, pyramid spec) of the reference, on the CPU."""
    m = cfg["model"]
    spec = sparse.egonn_spec(m["cap0"], tuple(m["pyramid_decay"]), len(m["planes"]))
    return models.MinkGL(cfg), sparse.PolarQuantizer(m["quantization_step"]), spec
