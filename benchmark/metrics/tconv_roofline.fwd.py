"""tconv's share of its roofline over the traced calls' transposed convs
(`core/tconv_work.py`); nothing where the traced calls ran no tconv."""
from benchmark.core import tconv_work


def read(ctx):
    return tconv_work.roofline(ctx)
