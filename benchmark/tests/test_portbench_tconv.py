"""The transposed conv's readers (`metrics/tconv_ms.fwd.py`,
`tconv_ms.train.py`) on the hand-written traces of `test_portbench_spans`:
the device time of the kernels launched inside `egonn.tconv`, on any thread,
per call; nothing on a trace of a program that opens no such span."""
from __future__ import annotations

import pytest

from test_portbench_spans import (FWD_HOST, FWD_KERNELS, FWD_RECORDS, FWD_SPANS, TRAIN_HOST,
                                  TRAIN_KERNELS, TRAIN_RECORDS, TRAIN_SPANS, chrome_trace,
                                  context, fwd_context, read, train_context)

# each forward's GEMM (50 us) launched inside a transposed conv in the trunk
FWD_TCONV = [("egonn.tconv", 138, 145), ("egonn.tconv", 628, 640)]
# a head's transposed conv in the second forward (GATHER, 50 us) and a down
# conv's dX in the backward (GATHER, 40 us, launched by autograd's thread)
TRAIN_TCONV = [("egonn.tconv", 390, 410), ("egonn.tconv", 1190, 1250)]


def test_readers_leave_a_program_without_the_span_out(tmp_path):
    _tracer, ctx = fwd_context(tmp_path)
    assert read("tconv_ms.fwd", ctx) is None
    _tracer, ctx = train_context(tmp_path)
    assert read("tconv_ms.train", ctx) is None


def test_forward_reader(tmp_path):
    _tracer, ctx = context(tmp_path, chrome_trace((0, 1000), FWD_SPANS + FWD_TCONV, FWD_KERNELS,
                                                  FWD_HOST), 2, FWD_RECORDS)
    assert read("tconv_ms.fwd", ctx) == pytest.approx(0.050, rel=1e-12)
    # the enclosing phase keeps its time
    assert read("trunk_ms.fwd", ctx) == pytest.approx(0.152, rel=1e-12)


def test_train_reader_counts_the_backward_thread(tmp_path):
    _tracer, ctx = context(tmp_path, chrome_trace((0, 2000), TRAIN_SPANS + TRAIN_TCONV,
                                                  TRAIN_KERNELS, TRAIN_HOST), 1, TRAIN_RECORDS)
    assert read("tconv_ms.train", ctx) == pytest.approx(0.090, rel=1e-12)
    assert read("backward_ms.train", ctx) == pytest.approx(0.120, rel=1e-12)
