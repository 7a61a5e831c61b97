"""gather_dw's share of its roofline over the traced steps."""
from benchmark.core import layers


def read(ctx):
    return layers.roofline(ctx, "gather_dw")
