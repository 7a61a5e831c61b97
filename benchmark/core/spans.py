"""Per-layer readings from the program's spans (`egonn.*` ranges that
`egonn_tpu_torch/utils/tracing.py::span` opens while a profiler runs) in
the traced stretch's Chrome trace.

A kernel is charged to every span whose host interval holds the start of
the runtime or driver call that launched it (the `cuda_runtime` or
`cuda_driver` event with the kernel's `args.correlation`), on any thread:
autograd's worker launches the backward kernels while the main thread sits
in `egonn.step.backward`.  A launch call (`LAUNCH_APIS`, or any call a
kernel's correlation names) and a host-blocking call (`SYNC_APIS`) are
charged to the spans holding their start in the same way; launches are
counted from the calls, so a kernel record the profiler lost (it has lost
the first few dozen of a stretch) still counts, though its time cannot.
Values are per call: the sum over the stretch divided by
`ctx.traced_calls`.

A reading is None, never a guess, on a CPU run (no kernels), when the
stretch holds another number of top spans (`egonn.forward` a forward,
`egonn.train_step` a step) than traced calls (a program without the spans,
or a stretch cut inside a call), or when more than `MAX_UNMATCHED` of the
stretch's kernel time has no matched launch.

The harness hands a reader the `Trace` (`core/trace.py`), which keeps no
correlation ids; the Chrome trace it was read from is the file of the
`Tracer` that holds that very `Trace`, and is read again here, once a run.
"""
from __future__ import annotations

import gc
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.core.trace import Trace, Tracer, kernel_name

PREFIX = "egonn."
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
LAUNCH_APIS = (
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
    "cudaLaunchCooperativeKernel", "cuLaunchKernel", "cuLaunchKernelEx",
    "cuLaunchCooperativeKernel",
)
# calls that block the host until the device has caught up
SYNC_APIS = (
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpy",
    "cuMemcpyDtoH", "cuMemcpyDtoH_v2", "cuMemcpyHtoD", "cuMemcpyHtoD_v2",
    "cuMemcpyDtoD", "cuMemcpyDtoD_v2",
)
MAX_UNMATCHED = 0.01  # share of the stretch's kernel time without a matched launch

Launched = Tuple[str, float, float, Optional[float]]  # kernel, start, end, launch start (us)
ApiCall = Tuple[str, float, float, int, bool]         # name, start, end (us), thread, a launch


@dataclass
class SpanTrace:
    start: float                                      # the stretch (us, host clock)
    end: float
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    kernels: List[Launched] = field(default_factory=list)
    api: List[ApiCall] = field(default_factory=list)

    def intervals(self, names: Sequence[str]) -> List[Tuple[float, float]]:
        return sorted(iv for n in names for iv in self.spans.get(n, []))

    def unmatched_share(self) -> float:
        total = sum(e - s for _, s, e, _ in self.kernels)
        lost = sum(e - s for _, s, e, at in self.kernels if at is None)
        return lost / total if total > 0 else 1.0


def read_spans(path: str, start: float, end: float) -> SpanTrace:
    """The `egonn.*` spans inside [start, end], every kernel with the start
    of its launch, and the runtime and driver calls, from a Chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    st = SpanTrace(start, end)
    launch_at: Dict[int, float] = {}
    kernels, api = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        s = float(e["ts"])
        t = s + float(e["dur"])
        if cat == "user_annotation" and name.startswith(PREFIX):
            if start <= s and t <= end:
                st.spans.setdefault(name, []).append((s, t))
        elif cat == "kernel":
            kernels.append((kernel_name(name), s, t, e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            api.append((name, s, t, int(e.get("tid", 0)), corr))
            if corr is not None:
                launch_at[corr] = min(s, launch_at.get(corr, s))
    st.kernels = [(n, s, t, launch_at.get(c)) for n, s, t, c in kernels]
    launched = {c for _, _, _, c in kernels if c is not None}
    st.api = [(n, s, t, tid, n in LAUNCH_APIS or c in launched) for n, s, t, tid, c in api]
    return st


def _holds(intervals: List[Tuple[float, float]], at: float) -> bool:
    return any(s <= at <= e for s, e in intervals)


_cache: Dict[int, Tuple[Trace, Optional[SpanTrace]]] = {}


def _trace_file(trace: Trace) -> Optional[str]:
    for obj in gc.get_objects():
        if isinstance(obj, Tracer) and obj.trace is trace:
            return obj.path
    return None


def of(trace: Trace) -> Optional[SpanTrace]:
    """The spans of the stretch `trace` was read for, read once."""
    hit = _cache.get(id(trace))
    if hit is None or hit[0] is not trace:
        path = _trace_file(trace)
        hit = (trace, read_spans(path, trace.start, trace.end) if path else None)
        _cache.clear()
        _cache[id(trace)] = hit
    return hit[1]


def stretch(ctx, top: str) -> Optional[SpanTrace]:
    """The stretch's spans where they can be read: kernels ran, one `top`
    span a traced call, and the kernels' launches matched."""
    if ctx.trace is None or not ctx.trace.kernels or ctx.traced_calls <= 0:
        return None
    st = of(ctx.trace)
    if st is None or len(st.spans.get(top, [])) != ctx.traced_calls:
        return None
    if st.unmatched_share() > MAX_UNMATCHED:
        return None
    return st


def device_ms(ctx, top: str, *names: str) -> Optional[float]:
    """Device ms a call of the kernels launched inside any span of `names`."""
    st = stretch(ctx, top)
    if st is None:
        return None
    ivs = st.intervals(names)
    us = sum(e - s for _, s, e, at in st.kernels if at is not None and _holds(ivs, at))
    return 1e-3 * us / ctx.traced_calls


def host_ms(ctx, top: str) -> Optional[float]:
    """Host ms a call inside the `top` span (its duration)."""
    st = stretch(ctx, top)
    if st is None:
        return None
    return 1e-3 * sum(e - s for s, e in st.spans[top]) / ctx.traced_calls


def launches(ctx, top: str) -> Optional[float]:
    """Kernel launch calls a call made inside the `top` span, on any
    thread."""
    st = stretch(ctx, top)
    if st is None:
        return None
    ivs = st.intervals([top])
    return sum(1 for _, s, _, _, launch in st.api if launch and _holds(ivs, s)) \
        / ctx.traced_calls


def syncs(ctx, top: str) -> Optional[float]:
    """Host-blocking runtime or driver calls a call made inside the `top`
    span, on any thread."""
    st = stretch(ctx, top)
    if st is None:
        return None
    ivs = st.intervals([top])
    return sum(1 for name, s, _, _, _ in st.api if name in SYNC_APIS and _holds(ivs, s)) \
        / ctx.traced_calls
