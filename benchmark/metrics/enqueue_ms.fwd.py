"""Host ms a forward inside `egonn.forward` (the span's duration)."""
from benchmark.core import spans


def read(ctx):
    return spans.host_ms(ctx, "egonn.forward")
