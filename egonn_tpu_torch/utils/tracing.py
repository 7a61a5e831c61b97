"""Phase-scoped profiler traces (port of `egonn_tpu/utils/tracing.py`) over
`torch.profiler`.

Off unless EGONN_TRACE_DIR=<dir> is set.  Then `capture(subdir)` records
a profiler trace (host and CUDA activity) into <dir>/<subdir>/trace.json,
viewable in Perfetto or chrome://tracing, and `annotate(name)` labels a
host range (`record_function`: batch_prep, eval_embed, eval_ransac) so that
the viewer separates the input pipeline from device work;
`step_annotation(name, n)` labels one train or validation step.  The
trainer captures epoch EGONN_TRACE_EPOCH (`trace_epoch`, default 2: past
the kernels' build).  A capture inside an active one is a no-op: the
profiler does not nest.
"""
from __future__ import annotations

import contextlib
import os

import torch


def trace_dir() -> str | None:
    return os.environ.get("EGONN_TRACE_DIR") or None


def trace_epoch() -> int:
    return int(os.environ.get("EGONN_TRACE_EPOCH", "2"))


_capture_active = False


@contextlib.contextmanager
def _guarded_trace(path: str):
    global _capture_active
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _capture_active = True
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
    finally:
        _capture_active = False


def capture(subdir: str, enabled: bool = True):
    """A context manager tracing into EGONN_TRACE_DIR/<subdir>, or a no-op
    when tracing is off, disabled for this call, or a capture is active."""
    base = trace_dir()
    if not (base and enabled) or _capture_active:
        return contextlib.nullcontext()
    path = os.path.join(base, subdir)
    os.makedirs(path, exist_ok=True)
    print(f"[trace] capturing profiler trace -> {path}")
    return _guarded_trace(path)


def annotate(name: str):
    """A labelled host range while tracing is on, else a no-op."""
    if trace_dir() is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def step_annotation(name: str, step_num: int):
    """A host range labelled `<name>#<step_num>` while tracing is on, else a
    no-op: one train or validation step in the trace."""
    return annotate(f"{name}#{step_num}")
