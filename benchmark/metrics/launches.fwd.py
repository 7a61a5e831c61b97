"""Kernels a forward launched inside `egonn.forward`."""
from benchmark.core import spans


def read(ctx):
    return spans.launches(ctx, "egonn.forward")
