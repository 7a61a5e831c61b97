"""Host-blocking runtime or driver calls a forward made inside
`egonn.forward`."""
from benchmark.core import spans


def read(ctx):
    return spans.syncs(ctx, "egonn.forward")
