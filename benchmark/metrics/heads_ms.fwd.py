"""Device ms a forward of the kernels launched in `egonn.global_head` and
`egonn.local_head`."""
from benchmark.core import spans


def read(ctx):
    return spans.device_ms(ctx, "egonn.forward", "egonn.global_head", "egonn.local_head")
