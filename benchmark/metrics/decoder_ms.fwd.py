"""Device ms a forward of the kernels launched in `egonn.decoder` (a
U-Net's transposed convs, their BatchNorm, the concatenations and the
decoder's blocks); nothing where the program opens no such span."""
from benchmark.core import spans


def read(ctx):
    st = spans.stretch(ctx, "egonn.forward")
    if st is None or not st.spans.get("egonn.decoder"):
        return None
    return spans.device_ms(ctx, "egonn.forward", "egonn.decoder")
