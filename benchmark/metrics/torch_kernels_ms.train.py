"""Device ms per call of PyTorch's own kernels (outside `egonn::`)."""
from benchmark.core import layers


def read(ctx):
    return layers.torch_kernels_ms(ctx)
