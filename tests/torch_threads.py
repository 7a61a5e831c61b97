"""One intra-op thread policy for the port's tests.

Every `tests/test_torch_*.py` imports this module at its top.  An xdist
worker imports every test module while it collects, so the first import caps
the worker's torch before any test runs: the worker gets its share of the
cores, `cores // workers` threads and at least one.  Under `-n 6` on eight
cores that is one thread; a test run alone keeps every core.  Without the
cap each worker's torch starts a thread per core, and the workers' small ops
wait on each other's spinning pools far longer than they compute.

`threads(n)` holds a block to at most n threads: `shared_by(n)` splits the
worker's share among the n processes of a spawned-rank test while they run
(`parallel.mesh.run_ranks` gives each spawned rank this process's thread
count), and a test whose recorded sums were taken on one thread holds them
under `threads(1)`.
"""
import contextlib
import os

import torch


def threads_for(cores: int, workers: int) -> int:
    """Intra-op threads of one of `workers` processes sharing `cores`."""
    return max(1, cores // workers)


def worker_threads() -> int:
    """This process's share: its usable cores over the xdist workers
    (`PYTEST_XDIST_WORKER_COUNT`, which xdist sets in each worker; 1 outside
    xdist)."""
    return threads_for(len(os.sched_getaffinity(0)),
                       int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


torch.set_num_threads(worker_threads())


@contextlib.contextmanager
def threads(n: int):
    """At most n intra-op threads (and at least one) in the block, restored
    after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, min(before, n)))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def shared_by(processes: int):
    """The worker's threads split among `processes` ranks (this process and
    the ranks it spawns inside the block)."""
    return threads(torch.get_num_threads() // processes)
