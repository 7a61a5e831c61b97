"""The port's phase-scoped profiler traces (`egonn_tpu_torch/utils/tracing.py`,
over torch.profiler) keep the JAX package's contract: off by default, a
trace when EGONN_TRACE_DIR is set, a nested capture a no-op."""
import json
import os

import torch

from egonn_tpu_torch.utils import tracing


def test_capture_noop_without_env(monkeypatch, tmp_path):
    monkeypatch.delenv("EGONN_TRACE_DIR", raising=False)
    with tracing.capture("x"):
        with tracing.annotate("y"):
            pass
    assert not os.path.exists(str(tmp_path / "x"))


def test_capture_writes_trace(monkeypatch, tmp_path):
    monkeypatch.setenv("EGONN_TRACE_DIR", str(tmp_path))
    with tracing.capture("unit"):
        with tracing.annotate("phase"):
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
