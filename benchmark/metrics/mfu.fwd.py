"""The useful operations of the traced calls over the traced stretch, per
cent of the f32-operand peak."""
from benchmark.core import layers


def read(ctx):
    return layers.mfu(ctx)
