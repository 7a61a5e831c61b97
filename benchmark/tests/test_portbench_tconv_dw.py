"""The transposed conv's weight-gradient reader (`metrics/tconv_dw_ms.train.py`)
on the hand-written traces of `test_portbench_spans`: the device time of the
kernels launched inside `egonn.tconv_dw`, on any thread, per call; nothing on
a trace of a program that opens no such span."""
from __future__ import annotations

import pytest

from test_portbench_spans import (TRAIN_HOST, TRAIN_KERNELS, TRAIN_RECORDS, TRAIN_SPANS,
                                  chrome_trace, context, read, train_context)
from test_portbench_tconv import TRAIN_TCONV

# a transposed conv's weight gradient in the backward (DW, 80 us, launched
# by autograd's thread)
TRAIN_TCONV_DW = [("egonn.tconv_dw", 940, 1000)]


def test_reader_leaves_a_program_without_the_span_out(tmp_path):
    _tracer, ctx = train_context(tmp_path)
    assert read("tconv_dw_ms.train", ctx) is None
    # a program with the transposed conv's span but not its dW's
    _tracer, ctx = context(tmp_path, chrome_trace((0, 2000), TRAIN_SPANS + TRAIN_TCONV,
                                                  TRAIN_KERNELS, TRAIN_HOST), 1, TRAIN_RECORDS)
    assert read("tconv_dw_ms.train", ctx) is None


def test_reader_counts_its_span_alone_on_any_thread(tmp_path):
    """The dW kernel, launched by autograd's thread inside `egonn.tconv_dw`,
    counts there alone: the transposed convs' and the down convs' dX stay
    in `egonn.tconv`, and the backward keeps its time."""
    spans = TRAIN_SPANS + TRAIN_TCONV + TRAIN_TCONV_DW
    _tracer, ctx = context(tmp_path, chrome_trace((0, 2000), spans, TRAIN_KERNELS, TRAIN_HOST),
                           2, TRAIN_RECORDS)
    assert read("tconv_dw_ms.train", ctx) is None  # two traced calls, one top span
    _tracer, ctx = context(tmp_path, chrome_trace((0, 2000), spans, TRAIN_KERNELS, TRAIN_HOST),
                           1, TRAIN_RECORDS)
    assert read("tconv_dw_ms.train", ctx) == pytest.approx(0.080, rel=1e-12)
    assert read("tconv_ms.train", ctx) == pytest.approx(0.090, rel=1e-12)
    assert read("backward_ms.train", ctx) == pytest.approx(0.120, rel=1e-12)
