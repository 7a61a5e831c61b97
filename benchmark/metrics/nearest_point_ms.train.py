"""Device ms a step of the kernels launched in `egonn.loss.nearest_point`
(inside `egonn.step.loss`)."""
from benchmark.core import spans


def read(ctx):
    return spans.device_ms(ctx, "egonn.train_step", "egonn.loss.nearest_point")
