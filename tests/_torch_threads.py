"""One torch intra-op thread for a port test module.

A module imports ``one_torch_thread`` (an autouse fixture) to take it.  The
tier-1 command runs six pytest workers on the host's cores, and each worker's
torch would otherwise start one intra-op thread per core: the threads
oversubscribe the cores.  On an 8-core host six such files run together took
251 s, against 136 s with one torch thread each (``OMP_NUM_THREADS=1``).
The module's checks are the same; its float32 sums may run in another order
than under more threads, as they do between hosts.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
