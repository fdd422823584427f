"""One intra-op torch thread for the port's CPU test modules.

The Tier-1 run puts six test processes on shared cores, and a pool of
spinning intra-op threads per process slows them all (the training-runtime
file took 626 s inside that run with torch's default pool, 31 s alone).
A module imports the fixture to take it; it is module-scoped, and the old
count comes back at teardown, so nothing leaks into the next file that an
xdist worker runs. This file holds no test of its own.
"""
import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
