"""The span readers (`core/spans.py`, `metrics/*_ms.*`, `launches.*`,
`syncs.*`) on two small hand-written Chrome traces, one of two forwards and
one of a train step, shaped as the profiler writes them: the program's
`egonn.*` ranges, launches by runtime and driver calls matched to kernels
by correlation id, host-blocking calls inside and outside the calls.  The
readers that were there before them, and `breakdown`, read the values they
read before the spans existed."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark.core import spans
from benchmark.core.layers import LayerContext
from benchmark.core.runner import BENCH_DIR, load_module
from benchmark.core.trace import Tracer, breakdown, read_chrome_trace
from conftest import make_small_copy, run_small

GATHER = "void egonn::gather_mm_kernel<64>(float const*)"
GATHER32 = "void egonn::gather_mm_kernel<32>(float const*)"
DW = "void egonn::gather_dw_kernel<32>(float const*)"
EW = "void at::native::elementwise_kernel<128, 2>(int)"
RED = "void at::native::reduce_kernel<512, 1>(float)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n"
ADAM = "void at::native::multi_tensor_apply_kernel<4>(float)"
RUNTIME, DRIVER = ("cuda_runtime", "cudaLaunchKernel"), ("cuda_driver", "cuLaunchKernel")

# two forwards in a stretch of 0-1000 us: spans (name, start, end) on the
# main thread; kernels (launch, launch start, kernel, start, duration)
FWD_SPANS = [
    ("egonn.forward", 10, 400), ("egonn.quantize", 12, 60), ("egonn.pyramid", 60, 120),
    ("egonn.trunk", 120, 300), ("egonn.global_head", 300, 350),
    ("egonn.local_head", 350, 398),
    ("egonn.forward", 500, 900), ("egonn.quantize", 502, 550), ("egonn.pyramid", 550, 610),
    ("egonn.trunk", 610, 790), ("egonn.global_head", 790, 840),
    ("egonn.local_head", 840, 898),
]
FWD_KERNELS = [
    (RUNTIME, 20, EW, 30, 40), (RUNTIME, 70, "void egonn::zrun_rank_kernel(int)", 75, 20),
    (DRIVER, 100, "egonn::lookup_kernel<4>", 105, 10), (RUNTIME, 130, GATHER, 135, 100),
    (RUNTIME, 140, GEMM, 235, 50), (RUNTIME, 310, RED, 312, 8),
    (RUNTIME, 360, GATHER32, 362, 30),
    (RUNTIME, 450, "void at::native::vectorized_elementwise_kernel<4>(int)", 452, 4),
    (RUNTIME, 510, EW, 520, 44), (RUNTIME, 560, "void egonn::zrun_rank_kernel(int)", 565, 20),
    (DRIVER, 590, "egonn::lookup_kernel<4>", 595, 10), (RUNTIME, 620, GATHER, 625, 104),
    (RUNTIME, 630, GEMM, 729, 50), (RUNTIME, 800, RED, 802, 8),
    (RUNTIME, 850, GATHER32, 852, 30),
]
# other host calls (category, name, start, end, thread)
FWD_HOST = [
    ("cpu_op", "aten::atan2", 14, 28, 1), ("cpu_op", "aten::mm", 138, 150, 1),
    ("cuda_runtime", "cudaMemcpyAsync", 106, 108, 1),
    ("cuda_runtime", "cudaStreamSynchronize", 108, 118, 1),
    ("cpu_op", "aten::sum", 305, 318, 1),
    ("cuda_runtime", "cudaStreamSynchronize", 600, 606, 1),
    ("cuda_runtime", "cudaDeviceSynchronize", 995, 999, 1),
]
FWD_RECORDS = [
    dict(role="self", train=False, b=2, c_in=1000, c_out=1000, f_in=32, f_out=64, k=27,
         nnz=20000),
    dict(role="down", train=False, b=2, c_in=1000, c_out=500, f_in=64, f_out=64, k=8,
         nnz=1000),
]

# one train step in a stretch of 0-2000 us; the backward's kernels launched
# from thread 2 (autograd's worker) while thread 1 sits in the backward span
TRAIN_SPANS = [
    ("egonn.train_step", 10, 1900),
    ("egonn.step.forward", 20, 300), ("egonn.augment", 22, 40), ("egonn.quantize", 40, 60),
    ("egonn.pyramid", 60, 100), ("egonn.trunk", 100, 250), ("egonn.global_head", 250, 270),
    ("egonn.local_head", 270, 295),
    ("egonn.step.loss", 300, 350), ("egonn.step.forward", 350, 500),
    ("egonn.step.forward", 500, 650), ("egonn.step.loss", 650, 900),
    ("egonn.loss.nearest_point", 660, 850), ("egonn.step.backward", 900, 1500),
    ("egonn.step.optimizer", 1500, 1880),
]
TRAIN_KERNELS = [
    (RUNTIME, 30, EW, 35, 10), (RUNTIME, 120, GATHER, 125, 60), (RUNTIME, 310, RED, 312, 6),
    (RUNTIME, 400, GATHER, 402, 50), (RUNTIME, 550, GATHER, 552, 50),
    (RUNTIME, 655, EW, 657, 3), (RUNTIME, 700, EW, 702, 100), (RUNTIME, 710, RED, 802, 20),
    (RUNTIME + (2,), 950, DW, 952, 80), (RUNTIME + (2,), 1200, GATHER, 1202, 40),
    (DRIVER, 1600, ADAM, 1602, 30),
]
TRAIN_HOST = [
    ("cpu_op", "aten::where", 701, 709, 1),
    ("cuda_runtime", "cudaStreamSynchronize", 720, 730, 1),
    ("cpu_op", "autograd::engine::evaluate_function: GatherBackward", 1100, 1300, 2),
    ("cuda_runtime", "cudaEventSynchronize", 1300, 1310, 2),
    ("cpu_op", "Optimizer.step#Adam.step", 1510, 1870, 1),
    ("cuda_runtime", "cudaDeviceSynchronize", 1950, 1990, 1),
]
TRAIN_RECORDS = [
    dict(role="self", train=True, b=4, c_in=1000, c_out=1000, f_in=32, f_out=32, k=27,
         nnz=30000),
    dict(role="self_dw", train=True, b=4, c_in=1000, c_out=1000, f_in=32, f_out=32, k=27,
         nnz=30000),
]


def _x(cat, name, ts, end, tid=1, pid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": float(ts),
            "dur": float(end - ts), "args": args}


def chrome_trace(stretch, span_rows, kernel_rows, host_rows, drop=(), lost=()):
    """The events of a profiled stretch; `drop` leaves out the launches of
    those kernel rows (their correlation then matches nothing), `lost` the
    kernels of those rows (as the profiler loses some)."""
    events = [_x("user_annotation", Tracer.MARKER, *stretch)]
    events += [_x("user_annotation", n, s, e) for n, s, e in span_rows]
    events += [_x(cat, name, s, e, tid) for cat, name, s, e, tid in host_rows]
    for i, (launch, at, kernel, ks, kd) in enumerate(kernel_rows):
        cat, name, tid = (launch + (1,))[:3]
        corr = 100 + i
        if i not in drop:
            events.append(_x(cat, name, at, at + 1, tid, correlation=corr))
        if i not in lost:
            events.append(_x("kernel", kernel, ks, ks + kd, tid=7, pid=0, correlation=corr,
                             device=0, stream=7))
    events.append({"ph": "i", "cat": "Trace", "name": "Record Window End", "ts": 2500.0})
    return {"traceEvents": events}


def context(tmp_path, trace: dict, calls: int, records):
    """(the Tracer whose file and Trace the readers find, the context)."""
    tracer = Tracer(torch.device("cpu"), str(tmp_path))
    with open(tracer.path, "w") as f:
        json.dump(trace, f)
    tracer.trace = read_chrome_trace(tracer.path, Tracer.MARKER)
    return tracer, LayerContext(tracer.trace, calls, records)


def read(name: str, ctx):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "metric").read(ctx)


def fwd_context(tmp_path, calls=2, drop=(), lost=()):
    return context(tmp_path, chrome_trace((0, 1000), FWD_SPANS, FWD_KERNELS, FWD_HOST, drop,
                                          lost), calls, FWD_RECORDS)


def train_context(tmp_path, calls=1):
    return context(tmp_path, chrome_trace((0, 2000), TRAIN_SPANS, TRAIN_KERNELS, TRAIN_HOST),
                   calls, TRAIN_RECORDS)


FWD_VALUES = {  # a forward: (40 + 44) / 2 us in quantize, ...
    "quantize_ms.fwd": 0.042, "pyramid_ms.fwd": 0.030, "trunk_ms.fwd": 0.152,
    "heads_ms.fwd": 0.038, "enqueue_ms.fwd": 0.395, "launches.fwd": 7.0, "syncs.fwd": 1.0,
}
TRAIN_VALUES = {
    "forward_ms.train": 0.170, "loss_ms.train": 0.129, "nearest_point_ms.train": 0.120,
    "backward_ms.train": 0.120, "optimizer_ms.train": 0.030, "launches.train": 11.0,
    "syncs.train": 2.0,
}


def test_forward_readers(tmp_path):
    _tracer, ctx = fwd_context(tmp_path)
    for name, value in FWD_VALUES.items():
        assert read(name, ctx) == pytest.approx(value, rel=1e-12, abs=0), name
    # the phases hold every kernel the forwards launched
    assert spans.device_ms(ctx, "egonn.forward", "egonn.forward") == pytest.approx(
        sum(FWD_VALUES[k] for k in ("quantize_ms.fwd", "pyramid_ms.fwd", "trunk_ms.fwd",
                                    "heads_ms.fwd")), rel=1e-12)


def test_train_readers_count_the_backward_thread(tmp_path):
    _tracer, ctx = train_context(tmp_path)
    for name, value in TRAIN_VALUES.items():
        assert read(name, ctx) == pytest.approx(value, rel=1e-12, abs=0), name
    # the autograd thread's two kernels (80 + 40 us) are the backward's
    st = spans.of(ctx.trace)
    assert {tid for name, _, _, tid, _ in st.api if name == "cudaLaunchKernel"} == {1, 2}
    phases = ("forward_ms.train", "loss_ms.train", "backward_ms.train", "optimizer_ms.train")
    assert spans.device_ms(ctx, "egonn.train_step", "egonn.train_step") == pytest.approx(
        sum(TRAIN_VALUES[k] for k in phases), rel=1e-12)


@pytest.mark.parametrize("case", ["calls", "unmatched", "no_spans", "cpu"])
def test_readers_refuse_to_guess(tmp_path, case):
    """Another number of top spans than traced calls, a kernel time more
    than 1% unmatched, a program without spans, a CPU run: None."""
    if case == "calls":
        _tracer, ctx = fwd_context(tmp_path, calls=3)
    elif case == "unmatched":
        _tracer, ctx = fwd_context(tmp_path, drop=(3,))  # 100 of 266 us
    elif case == "no_spans":
        _tracer, ctx = context(tmp_path, chrome_trace((0, 1000), [], FWD_KERNELS, FWD_HOST),
                               2, FWD_RECORDS)
    else:
        _tracer, ctx = context(tmp_path, chrome_trace((0, 1000), FWD_SPANS, [], FWD_HOST), 2,
                               FWD_RECORDS)
    assert all(read(name, ctx) is None for name in FWD_VALUES)


def test_the_unmatched_share_is_held_to_one_per_cent(tmp_path):
    """Of the fixture's 528 us of kernels, the harness's 4 us kernel without
    its launch (0.76%) leaves the forwards' readings as they are; a head's
    8 us kernel without its launch (1.5%) refuses them."""
    _tracer, ctx = fwd_context(tmp_path, drop=(7,))
    assert read("launches.fwd", ctx) == 7.0
    assert read("trunk_ms.fwd", ctx) == pytest.approx(FWD_VALUES["trunk_ms.fwd"], rel=1e-12)
    _tracer, ctx = fwd_context(tmp_path, drop=(5,))
    assert read("launches.fwd", ctx) is None


def test_a_lost_kernel_record_still_counts_as_a_launch(tmp_path):
    """The first call's quantize kernel (40 us) missing from the trace, its
    launch call there: 7 launches a call still, 22 us of quantize a call."""
    _tracer, ctx = fwd_context(tmp_path, lost=(0,))
    assert read("launches.fwd", ctx) == 7.0
    assert read("quantize_ms.fwd", ctx) == pytest.approx(0.022, rel=1e-12)


# what the readers that came before the spans, and `breakdown`, read on the
# fixtures: the parent commit's values
OLD_FWD = {"idle_share.fwd": 47.20000000000001, "gather_conv_roofline.fwd": 0.13655540479421077,
           "mfu.fwd": 0.018204444444444443, "torch_kernels_ms.fwd": 0.102}
OLD_TRAIN = {"idle_share.train": 77.55000000000001,
             "gather_conv_roofline.train": 0.2338197014925373,
             "gather_dw_roofline.train": 0.5845492537313433, "mfu.train": 0.012412121212121213,
             "torch_kernels_ms.train": 0.16899999999999998}
OLD_BREAKDOWN_FWD = {
    "device_ops": [["egonn::gather_mm_kernel<64>(float const*)", 0.00020399999999999997],
                   ["sm80_xmma_gemm_f32f32_f32f32_f32_nn_n", 9.999999999999999e-05],
                   ["at::native::elementwise_kernel<128, 2>(int)", 8.4e-05],
                   ["egonn::gather_mm_kernel<32>(float const*)", 5.9999999999999995e-05],
                   ["egonn::zrun_rank_kernel(int)", 3.9999999999999996e-05],
                   ["egonn::lookup_kernel<4>", 1.9999999999999998e-05],
                   ["at::native::reduce_kernel<512, 1>(float)", 1.6e-05],
                   ["at::native::vectorized_elementwise_kernel<4>(int)", 4e-06]],
    "idle_gaps": [["host: none", 0.000118], ["host: none", 6.4e-05],
                  ["host: none", 5.9999999999999995e-05], ["egonn.global_head", 4.2e-05],
                  ["egonn.global_head", 4.2e-05], ["aten::atan2", 2.9999999999999997e-05],
                  ["egonn.trunk", 2.7e-05], ["egonn.global_head", 2.3e-05],
                  ["egonn.trunk", 1.9999999999999998e-05],
                  ["egonn.trunk", 1.9999999999999998e-05]]}
OLD_BREAKDOWN_TRAIN = {
    "device_ops": [["egonn::gather_mm_kernel<64>(float const*)", 0.00019999999999999998],
                   ["at::native::elementwise_kernel<128, 2>(int)", 0.000113],
                   ["egonn::gather_dw_kernel<32>(float const*)", 7.999999999999999e-05],
                   ["at::native::multi_tensor_apply_kernel<4>(float)", 2.9999999999999997e-05],
                   ["at::native::reduce_kernel<512, 1>(float)", 2.6e-05]],
    "idle_gaps": [["Optimizer.step#Adam.step", 0.000368],
                  ["egonn.step.backward", 0.00035999999999999997],
                  ["autograd::engine::evaluate_function: GatherBackward", 0.00016999999999999999],
                  ["egonn.step.loss", 0.00013], ["egonn.trunk", 0.000127],
                  ["egonn.step.forward", 9.999999999999999e-05],
                  ["egonn.step.forward", 8.4e-05], ["egonn.pyramid", 7.999999999999999e-05],
                  ["egonn.step.forward", 5.4999999999999995e-05],
                  ["egonn.loss.nearest_point", 4.2e-05]]}


@pytest.mark.parametrize("kind", ["fwd", "train"])
def test_the_old_readers_read_as_before(tmp_path, kind):
    _tracer, ctx = (fwd_context if kind == "fwd" else train_context)(tmp_path)
    old, old_breakdown = ((OLD_FWD, OLD_BREAKDOWN_FWD) if kind == "fwd"
                          else (OLD_TRAIN, OLD_BREAKDOWN_TRAIN))
    assert {name: read(name, ctx) for name in old} == old
    assert json.loads(json.dumps(breakdown(ctx.trace))) == old_breakdown


def test_a_traced_cpu_run_leaves_the_span_metrics_out(tmp_path, capsys):
    """The small copy of the b128 cell, traced on the CPU: the run is whole
    and correct, and the span readers (no kernels there) report nothing."""
    bench = make_small_copy(tmp_path)
    rc, result = run_small(bench, "egonn.embed-b128", capsys, trace=1)
    assert rc == 0 and result["correct"]
    assert not set(result["metrics"]) & set(FWD_VALUES)
