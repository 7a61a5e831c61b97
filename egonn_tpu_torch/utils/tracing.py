"""Named host ranges and phase-scoped profiler traces (port of
`egonn_tpu/utils/tracing.py`) over `torch.profiler`.

`span(name)` is a `record_function` range while a profiler runs, and one
shared no-op context otherwise (one flag test: no range, no allocation, no
environment read).  The program opens spans at its layer boundaries, so
they show in any `torch.profiler` trace, on the profiler's clock beside the
kernels they launch:

    egonn.forward          inference.forward, the whole call
    egonn.augment          the training augmentation (device_preprocess_global)
    egonn.quantize         PolarQuantizer / CartesianQuantizer.quantize (the
                           point -> voxel inverse where asked for)
    egonn.pyramid          sparse/pyramid.py::build_pyramid
    egonn.trunk            MinkGL's trunk, MinkLoc's backbone; MinkUNet's
                           voxel features, stem and encoder
    egonn.global_head      head, decoder, normalisation, masking, pooling
    egonn.local_head       MinkGL's local head through sigma and kp_mask
    egonn.decoder          MinkUNet's decoder: the transposed convs, their
                           BatchNorm, the concatenations, blocks 5-8
    egonn.devoxelize       MinkUNet's `final` 1x1 conv and each point's
                           gather of its voxel's logits
    egonn.tconv            each transposed conv (sparse/conv.py::
                           sparse_tconv2x2): the FPN top-down steps and
                           heads, and every down conv's dX in a backward,
                           inside whichever phase runs it
    egonn.tconv_dw         each transposed conv's weight gradient in a
                           backward (sparse/conv.py::_Tconv2x2), apart
                           from egonn.tconv
    egonn.train_step       TrainStep / StagedTrainStep.__call__ (train and
                           validation)
    egonn.step.embed       the staged step's stage 1: the augmentation and
                           every chunk's forward with gradients off
    egonn.step.forward     each of the step's three forwards; each chunk's
                           forward of the staged step's stage 3
    egonn.step.loss        the global loss, the local loss and the stats; the
                           staged step's loss and its embedding gradient
    egonn.loss.nearest_point  losses/keypoint.py::_nearest_point_dist
    egonn.step.backward    the backward pass (each chunk's, staged)
    egonn.step.optimizer   the gradient all-reduce and the optimizer step
    egonn.batch_prep       do_train's batch assembly (the Prefetcher thread)
    egonn.eval_embed       the evaluator's embeddings
    egonn.eval_ransac      the evaluator's local registration

Traces are off unless EGONN_TRACE_DIR=<dir> is set.  Then `capture(subdir)`
records a profiler trace (host and CUDA activity, the spans included) into
<dir>/<subdir>/trace.json, viewable in Perfetto or chrome://tracing.  The
trainer captures epoch EGONN_TRACE_EPOCH (`trace_epoch`, default 2: past
the kernels' build), the evaluator its first evaluation.  A capture inside
an active one is a no-op: the profiler does not nest.
"""
from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A `record_function` range named `name` while a profiler runs, else a
    shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
