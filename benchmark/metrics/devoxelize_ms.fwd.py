"""Device ms a forward of the kernels launched in `egonn.devoxelize` (the
per-voxel head and the gather of each point's logits); nothing where the
program opens no such span."""
from benchmark.core import spans


def read(ctx):
    st = spans.stretch(ctx, "egonn.forward")
    if st is None or not st.spans.get("egonn.devoxelize"):
        return None
    return spans.device_ms(ctx, "egonn.forward", "egonn.devoxelize")
