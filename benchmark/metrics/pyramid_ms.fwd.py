"""Device ms a forward of the kernels launched in `egonn.pyramid`."""
from benchmark.core import spans


def read(ctx):
    return spans.device_ms(ctx, "egonn.forward", "egonn.pyramid")
