"""The useful operations of the traced staged steps over the traced
stretch, per cent of the f32-operand peak: one forward and one backward a
cloud (stage 3's records); stage 1's forward is recomputation and is not
counted."""
from dataclasses import replace

from benchmark.core import layers


def read(ctx):
    useful = [r for r in ctx.traced_records if r.get("stage") == 3]
    return layers.mfu(replace(ctx, traced_records=useful))
