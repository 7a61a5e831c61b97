"""Per cent of the traced stretch in which the device ran no kernel."""
from benchmark.core import layers


def read(ctx):
    return layers.idle_share(ctx)
