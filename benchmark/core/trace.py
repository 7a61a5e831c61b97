"""The traced stretch of a `--trace 1` run: `torch.profiler` over a few calls
of the window, read back from its Chrome trace.

`Tracer.start()` synchronizes and starts the profiler, `stop()` synchronizes
and stops it, so every device kernel in the trace belongs to the calls in
between; the stretch is the host span of a `portbench.traced` range around
them; `read()`, once the window has closed, exports and reads the trace.
`Trace` holds the kernels' and host ops' intervals (microseconds on the
host clock, which the profiler aligns the device's to).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

Interval = Tuple[str, float, float]  # name, start us, end us


@dataclass
class Trace:
    start: float
    end: float
    kernels: List[Interval] = field(default_factory=list)
    host_ops: List[Interval] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the kernels' intervals, clipped to the stretch."""
        out: List[Tuple[float, float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def kernel_seconds(self, predicate) -> float:
        return sum(e - s for name, s, e in self.kernels if predicate(name)) * 1e-6


def kernel_name(name: str) -> str:
    """A demangled kernel name without its return type: `egonn::...`."""
    return name[5:] if name.startswith("void ") else name


def read_chrome_trace(path: str, marker: str) -> Optional[Trace]:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("name") == marker and "dur" in e
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    start = min(float(e["ts"]) for e in spans)
    end = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    t = Trace(start, end)
    for e in events:
        if "dur" not in e or e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        iv = (e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat == "kernel":
            t.kernels.append((kernel_name(iv[0]), iv[1], iv[2]))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "python_function") \
                and iv[0] != marker:
            t.host_ops.append(iv)
    return t


class Tracer:
    """Profiles one stretch of the window; on a CPU run it records host ops
    only (no device metric is read from it)."""

    MARKER = "portbench.traced"

    def __init__(self, device: torch.device, out_dir: str):
        self.device = device
        self.path = os.path.join(out_dir, "trace.json")
        os.makedirs(out_dir, exist_ok=True)
        self._prof = self._done = self._range = None
        self.trace: Optional[Trace] = None

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once (its first start loads CUPTI),
        in set-up."""
        with torch.profiler.profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    def start(self) -> None:
        self._sync()
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.__enter__()
        self._range = torch.profiler.record_function(self.MARKER)
        self._range.__enter__()

    def stop(self) -> None:
        self._sync()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._done, self._prof = self._prof, None

    def read(self) -> Optional[Trace]:
        """Export and read the stopped profiler's trace (after the window)."""
        if self._done is not None:
            self._done.export_chrome_trace(self.path)
            self._done = None
            self.trace = read_chrome_trace(self.path, self.MARKER)
        return self.trace

    @property
    def active(self) -> bool:
        return self._prof is not None


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the innermost host op running across the gap's middle."""
    by_name: dict = {}
    for name, s, e in t.kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    prev = t.start
    for s, e in t.busy() + [(t.end, t.end)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        over = [(oe - os_, n) for n, os_, oe in t.host_ops if os_ <= mid <= oe]
        named.append([min(over)[1] if over else "host: none", (e - s) * 1e-6])
    return {"device_ops": [[_short(n), v] for n, v in ops], "idle_gaps": named}


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit]
