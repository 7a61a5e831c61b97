"""MinkUNet34C segmenting scans at 5 cm: the program's model from
`egonn_tpu_torch.models.factory` with the configuration's key pack and
capacity table, and the reference's MinkUNet34C, both from
configs/minkunet34c_semantickitti.json."""
from __future__ import annotations

from types import SimpleNamespace

from benchmark.reference import minkunet, sparse

OUTPUTS = ("logits",)


def program(cfg: dict, device):
    from egonn_tpu_torch.models.factory import model_factory
    from egonn_tpu_torch.ops.quantization import CartesianQuantizer
    from egonn_tpu_torch.sparse.packing import PackSpec

    m = cfg["model"]
    params = SimpleNamespace(
        model=m["model"], cap0=m["cap0"], capacities=list(m["capacities"]),
        quantizer=CartesianQuantizer(m["quantization_step"]), in_channels=m["in_channels"],
        num_classes=m["num_classes"],
        pack=PackSpec(tuple(m["pack_bits"]), tuple(m["pack_offsets"])))
    return model_factory(params, device=device)


def reference(cfg: dict):
    """(model, quantizer, pyramid spec) of the reference, on the CPU."""
    m = cfg["model"]
    spec = sparse.PyramidSpec(tuple(m["capacities"]), m["conv0_kernel_size"], 3,
                              sparse.PackSpec(tuple(m["pack_bits"]), tuple(m["pack_offsets"])))
    return minkunet.MinkUNet34C(cfg), sparse.CartesianQuantizer(m["quantization_step"]), spec
