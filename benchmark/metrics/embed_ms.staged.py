"""Device ms a staged step of the kernels launched in `egonn.step.embed`."""
from benchmark.core import spans


def read(ctx):
    return spans.device_ms(ctx, "egonn.train_step", "egonn.step.embed")
