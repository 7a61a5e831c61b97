"""gather_conv's share of its roofline over the traced calls."""
from benchmark.core import layers


def read(ctx):
    return layers.roofline(ctx, "gather_conv")
