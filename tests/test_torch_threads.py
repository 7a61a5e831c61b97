"""The port's test thread policy (`tests/torch_threads.py`): the formula at
eight cores, and the cap live in the worker running this test."""
import pytest
import torch

import torch_threads


@pytest.mark.parametrize("cores, workers, threads", [
    (8, 1, 8), (8, 6, 1), (8, 16, 1),
    pytest.param(None, None, None, id="live"),
])
def test_thread_policy(cores, workers, threads):
    """cores // workers and at least one; live: this worker's torch runs
    the count the formula gives for its cores and xdist workers (the one
    case that fails if the cap is lost)."""
    if cores is None:
        assert torch.get_num_threads() == torch_threads.worker_threads()
    else:
        assert torch_threads.threads_for(cores, workers) == threads
