"""Device ms a forward of the kernels launched in `egonn.trunk`."""
from benchmark.core import spans


def read(ctx):
    return spans.device_ms(ctx, "egonn.forward", "egonn.trunk")
