"""Host-blocking runtime or driver calls a step made inside
`egonn.train_step`."""
from benchmark.core import spans


def read(ctx):
    return spans.syncs(ctx, "egonn.train_step")
