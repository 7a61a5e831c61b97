"""The port's spans and phase-scoped profiler traces
(`egonn_tpu_torch/utils/tracing.py`, over torch.profiler): a span is a
no-op unless a profiler runs, and then nests at the program's layer
boundaries; a capture is off by default, a trace when EGONN_TRACE_DIR is
set, a nested capture a no-op."""
import json
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps this worker's torch threads)
from egonn_tpu_torch import inference
from egonn_tpu_torch.config import ModelParams, TrainingParams
from egonn_tpu_torch.data.lidar_sim import lidar_scan_clouds
from egonn_tpu_torch.models.factory import create_egonn_model, model_factory
from egonn_tpu_torch.train.trainer import make_train_step
from egonn_tpu_torch.utils import tracing

# the CPU sizes of tests/test_torch_train.py::test_kernel_calls_per_step
CAP0, N_POINTS, B_GLOBAL, B_LOCAL, LR = 512, 1024, 4, 2, 1e-3
FORWARD_PHASES = ["egonn.quantize", "egonn.pyramid", "egonn.trunk"]


def test_capture_noop_without_env(monkeypatch, tmp_path):
    monkeypatch.delenv("EGONN_TRACE_DIR", raising=False)
    with tracing.capture("x"):
        with tracing.span("y"):
            pass
    assert not os.path.exists(str(tmp_path / "x"))


def test_capture_writes_trace(monkeypatch, tmp_path):
    monkeypatch.setenv("EGONN_TRACE_DIR", str(tmp_path))
    with tracing.capture("unit"):
        with tracing.span("phase"):
            (torch.arange(8.0) * 2 + 1).sum()
    path = tmp_path / "unit" / "trace.json"
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "phase" in names


def test_nested_capture_degrades_to_noop(monkeypatch, tmp_path):
    monkeypatch.setenv("EGONN_TRACE_DIR", str(tmp_path))
    with tracing.capture("outer"):
        with tracing.capture("inner"):
            pass
    assert not os.path.exists(str(tmp_path / "inner"))
    assert (tmp_path / "outer" / "trace.json").exists()
    assert not tracing._capture_active


def test_capture_disabled_flag(monkeypatch, tmp_path):
    monkeypatch.setenv("EGONN_TRACE_DIR", str(tmp_path))
    with tracing.capture("off", enabled=False):
        pass
    assert not os.path.exists(str(tmp_path / "off"))


def test_span_without_profiler_makes_no_range(monkeypatch, tmp_path):
    """No profiler: one shared no-op, whatever EGONN_TRACE_DIR says, and no
    record_function is made."""
    def refused(name):
        raise AssertionError(f"record_function({name!r}) made without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setenv("EGONN_TRACE_DIR", str(tmp_path))
    assert not torch.autograd.profiler._is_profiler_enabled
    with tracing.span("egonn.a") as a:
        assert a is None
    assert tracing.span("egonn.a") is tracing.span("egonn.b")


def test_span_follows_the_profiler_flag():
    """The flag `span` tests is up exactly while a profiler records."""
    assert not torch.autograd.profiler._is_profiler_enabled
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with tracing.span("egonn.flagged"):
            torch.ones(4).add_(1)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("egonn.flagged") is tracing.span("egonn.other")
    assert "egonn.flagged" in {e.name for e in prof.events()}


def _spans(fn, path):
    """fn() under a CPU profiler: its `egonn.*` ranges in the Chrome trace
    written to `path` as (name, start, end), in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"].startswith("egonn.")),
                  key=lambda s: (s[1], -s[2]))


def _inside(spans, outer):
    """The spans nested in `outer` (itself left out), in order of start."""
    _, s0, e0 = outer
    return [s for s in spans if s is not outer and s0 <= s[1] and s[2] <= e0]


def _clouds(n):
    clouds = torch.from_numpy(lidar_scan_clouds(n, N_POINTS, seed=0) * 0.3)
    return clouds, torch.ones(clouds.shape[:2], dtype=torch.bool)


def _phases(spans):
    """The spans other than the transposed convs' (`egonn.tconv`) and their
    weight gradients' (`egonn.tconv_dw`), which nest inside the phase that
    runs them."""
    return [s for s in spans if s[0] not in ("egonn.tconv", "egonn.tconv_dw")]


def _tconvs_inside(spans, outer, name="egonn.tconv"):
    return sum(s[0] == name for s in _inside(spans, outer))


@pytest.mark.parametrize("model", ["egonn", "minkloc3d_mulran"])
def test_forward_spans(model, tmp_path):
    """Each inference forward is one egonn.forward holding quantize,
    pyramid, trunk and the heads, in that order; each transposed conv is an
    egonn.tconv inside the phase that runs it (MinkFPN's top-down step in
    the trunk, EgoNN's in the global head (2) and the local head (1))."""
    if model == "egonn":
        built = create_egonn_model(ModelParams("model_configs/egonn.txt"), cap0=CAP0,
                                   device="cpu")
        heads = ["egonn.global_head", "egonn.local_head"]
        tconvs = {"egonn.trunk": 0, "egonn.global_head": 2, "egonn.local_head": 1}
    else:
        built = model_factory(ModelParams("model_configs/minkloc3d_mulran.txt"), cap0=CAP0,
                              device="cpu")
        heads = ["egonn.global_head"]
        tconvs = {"egonn.trunk": 1, "egonn.global_head": 0}
    clouds, mask = _clouds(2)
    spans = _spans(lambda: [inference.forward(built, clouds, mask) for _ in range(2)],
                   tmp_path / "trace.json")
    tops = [s for s in spans if s[0] == "egonn.forward"]
    assert len(tops) == 2
    for top in tops:
        inner = _inside(spans, top)
        assert [s[0] for s in _phases(inner)] == FORWARD_PHASES + heads
        assert {p[0]: _tconvs_inside(spans, p) for p in inner if p[0] in tconvs} == tconvs
        assert _tconvs_inside(spans, top) == sum(tconvs.values())
    assert sum(len(_inside(spans, t)) + 1 for t in tops) == len(spans)


def _train_batch():
    """2 places of 2 scans (the second shifted) and 2 pairs whose positive
    is the anchor."""
    clouds, ones = _clouds(B_GLOBAL // 2 + B_LOCAL)
    glob = clouds[:B_GLOBAL // 2].repeat_interleave(2, 0)
    glob[1::2] += torch.tensor([0.3, -0.2, 0.0])
    labels = torch.arange(B_GLOBAL) // 2
    g = dict(clouds=glob, point_mask=ones[:B_GLOBAL],
             positives_mask=(labels[:, None] == labels[None]) & ~torch.eye(B_GLOBAL,
                                                                          dtype=torch.bool),
             negatives_mask=labels[:, None] != labels[None])
    anc = clouds[B_GLOBAL // 2:]
    l = dict(anc_clouds=anc, anc_mask=ones[:B_LOCAL], pos_clouds=anc.clone(),
             pos_mask=ones[:B_LOCAL],
             t_gt=torch.from_numpy(np.tile(np.eye(4, dtype=np.float32), (B_LOCAL, 1, 1))))
    return g, l


def test_train_step_spans(tmp_path):
    """A train step is one egonn.train_step holding three forwards (each
    with its input and model phases, the first augmented), the losses (the
    point search inside them), the backward and the optimizer, in order; a
    validation step the same without augmentation, backward or optimizer."""
    tp = TrainingParams("config/config_egonn.txt", "model_configs/egonn.txt",
                        require_dataset=False)
    step = make_train_step(create_egonn_model(tp.model_params, cap0=CAP0, device="cpu"), tp)
    g, l = _train_batch()
    forward = FORWARD_PHASES + ["egonn.global_head", "egonn.local_head"]
    for train in (True, False):
        gen = torch.Generator().manual_seed(0) if train else None
        spans = _spans(lambda: step(g, l, gen, LR, train), tmp_path / f"{train}.json")
        (top,) = [s for s in spans if s[0] == "egonn.train_step"]
        inner = _inside(spans, top)
        assert len(inner) + 1 == len(spans)
        phases = [s for s in inner if s[0].startswith("egonn.step.")]
        want = ["egonn.step.forward", "egonn.step.loss", "egonn.step.forward",
                "egonn.step.forward", "egonn.step.loss"]
        want += ["egonn.step.backward", "egonn.step.optimizer"] if train else []
        assert [s[0] for s in phases] == want
        for i, p in enumerate(phases):
            names = [s[0] for s in _phases(_inside(spans, p))]
            if p[0] == "egonn.step.forward":
                assert names == (["egonn.augment"] if train and i == 0 else []) + forward
                assert _tconvs_inside(spans, p) == 3  # the heads' transposed convs
            elif p is phases[4]:
                assert names and set(names) == {"egonn.loss.nearest_point"}
            else:
                assert names == []
                # the backward runs the down convs' dX as transposed convs: 7
                # levels for the global loss, 4 for each local side
                assert _tconvs_inside(spans, p) == (15 if p[0] == "egonn.step.backward" else 0)
                # and the weight gradients of the transposed convs the losses
                # reach: the global head's two, each local side's one
                assert _tconvs_inside(spans, p, "egonn.tconv_dw") == (
                    4 if p[0] == "egonn.step.backward" else 0)
