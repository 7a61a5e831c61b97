"""Kernels a step launched inside `egonn.train_step`."""
from benchmark.core import spans


def read(ctx):
    return spans.launches(ctx, "egonn.train_step")
