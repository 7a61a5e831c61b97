"""Device ms a step of the kernels launched in `egonn.tconv_dw` (the
transposed convs' weight gradients in the backward, on any thread); nothing
where the program opens no such span."""
from benchmark.core import spans


def read(ctx):
    st = spans.stretch(ctx, "egonn.train_step")
    if st is None or not st.spans.get("egonn.tconv_dw"):
        return None
    return spans.device_ms(ctx, "egonn.train_step", "egonn.tconv_dw")
