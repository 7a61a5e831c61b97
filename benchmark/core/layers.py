"""What the per-layer metric readers (`metrics/<name>.py`) read: the traced
stretch and the reference's work records of the calls in it.  Each reader
returns a number or None where it finds nothing to read (a CPU run has no
device kernels)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from benchmark.core import work
from benchmark.core.trace import Trace


@dataclass
class LayerContext:
    trace: Optional[Trace]           # the traced stretch (None: no trace)
    traced_calls: int                # forwards or steps in it
    traced_records: List[dict]       # the reference's work records of those calls


def _kernels(ctx: LayerContext) -> bool:
    return ctx.trace is not None and bool(ctx.trace.kernels) and ctx.traced_calls > 0


def idle_share(ctx: LayerContext) -> Optional[float]:
    """Per cent of the traced stretch in which no kernel ran on the device."""
    if not _kernels(ctx):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_seconds() / ctx.trace.seconds)


def roofline(ctx: LayerContext, kernel: str) -> Optional[float]:
    """Per cent: the least time of the traced calls' products that `kernel`
    computes, over the device time of the kernels named for it."""
    if not _kernels(ctx):
        return None
    prefix = work.KERNEL_PREFIX[kernel]
    measured = ctx.trace.kernel_seconds(lambda n: n.startswith(prefix))
    records = [r for r in ctx.traced_records if work.kernel_of(r) == kernel]
    if measured <= 0 or not records:
        return None
    return 100.0 * work.least_seconds(records) / measured


def mfu(ctx: LayerContext) -> Optional[float]:
    """Per cent of the f32-operand peak: the traced calls' useful operations
    over the traced stretch."""
    if not _kernels(ctx) or not ctx.traced_records:
        return None
    return 100.0 * work.total_ops(ctx.traced_records) / ctx.trace.seconds \
        / work.F32_OPERAND_OPS_PER_S


def torch_kernels_ms(ctx: LayerContext) -> Optional[float]:
    """Device ms per call of the kernels outside the program's `egonn::`
    namespace (PyTorch's own)."""
    if not _kernels(ctx):
        return None
    return 1e3 * ctx.trace.kernel_seconds(lambda n: not n.startswith("egonn::")) / ctx.traced_calls
