"""Device ms a forward of the kernels launched in `egonn.quantize`."""
from benchmark.core import spans


def read(ctx):
    return spans.device_ms(ctx, "egonn.forward", "egonn.quantize")
