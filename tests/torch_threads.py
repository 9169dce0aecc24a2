"""One intra-op thread for the port's CPU tests.

Every ``tests/test_torch_*.py`` module imports ``one_torch_thread`` by name,
which makes it an autouse fixture of that module (``test_torch_threads.py``
fails for a module that does not). The tier-1 run puts several test workers
on the CPU's cores; torch's intra-op pool of one thread a core in each of
them oversubscribes the cores, and the port's torch-bound cases then wait
for cores many times longer than their own work takes (a case of 7 s alone
took 275 s beside five others). One thread a worker keeps each case to its
own work; what the tests check is unchanged.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch.set_num_threads(1) for the module, the count before it back
    afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
