"""The phases of a MinkUNet forward (`inference.forward` on a MinkUNet34C
of `models/minkunet.py`): one `egonn.forward` holding `egonn.quantize`
(with the inverse), `egonn.pyramid` (with level 0's 3^3 map),
`egonn.trunk`, `egonn.decoder` and `egonn.devoxelize`, each once and in
that order, the four transposed convs' `egonn.tconv` inside the decoder;
and the phases partition the forward: every op the forward runs lies in
one of them, so that their device times add up to the forward's."""
import dataclasses
import json

import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from benchmark.core import scans
from egonn_tpu_torch import inference
from egonn_tpu_torch.config import ModelParams
from egonn_tpu_torch.models.factory import model_factory
from egonn_tpu_torch.models.minkunet import MinkUNetBase

PHASES = ["egonn.quantize", "egonn.pyramid", "egonn.trunk", "egonn.decoder",
          "egonn.devoxelize"]


def _events(fn, path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def test_forward_phases_partition_the_forward(tmp_path):
    params = ModelParams("model_configs/minkunet34c_semantickitti.txt")
    params.capacities = [768, 768, 512, 256, 256]
    built = model_factory(params, device="cpu")
    unet = type("MinkUNet", (MinkUNetBase,), dict(INIT_DIM=8, PLANES=(8,) * 8, LAYERS=(1,) * 8))
    model = unet(4, 19, torch.Generator().manual_seed(0))
    built = dataclasses.replace(built, model=model.eval())
    clouds = scans.lidar_scans(2, 1024, scans.generator("cpu", 0, 2)) * 0.1
    mask = torch.ones(clouds.shape[:2], dtype=torch.bool)
    feats = torch.cat([clouds, torch.rand(2, 1024, 1)], -1)
    events = _events(lambda: [inference.forward(built, clouds, mask, feats=feats)
                              for _ in range(2)], tmp_path / "trace.json")
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("egonn.")),
                   key=lambda s: (s[1], -s[2]))
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "cpu_op"]
    tops = [s for s in spans if s[0] == "egonn.forward"]
    assert len(tops) == 2
    for _, t0, t1 in tops:
        inner = [s for s in spans if s[0] != "egonn.forward" and t0 <= s[1] and s[2] <= t1]
        phases = [s for s in inner if s[0] != "egonn.tconv"]
        assert [s[0] for s in phases] == PHASES
        assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
        tconvs = [s for s in inner if s[0] == "egonn.tconv"]
        (decoder,) = [s for s in phases if s[0] == "egonn.decoder"]
        assert len(tconvs) == 4 and all(decoder[1] <= s[1] and s[2] <= decoder[2]
                                         for s in tconvs)
        inside = [op for op in ops if t0 <= op[0] and op[1] <= t1]
        assert inside
        assert all(any(s <= op[0] and op[1] <= e for _, s, e in phases) for op in inside)
