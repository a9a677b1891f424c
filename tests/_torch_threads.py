"""Keep the port's CPU tests to a few torch threads.

The suite runs under pytest-xdist, several worker processes on one host.
torch's intra-op pool defaults to one thread per core in every process (and
one pool per Python thread that calls into it: the scheduler tests step on
a dispatcher thread beside their submitters), so a port test file running
beside a timing-fenced JAX test took the host's cores from it.  The port's
test files import this fixture; it is autouse and module-scoped, and puts
the thread count back when the module is done.
"""

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)
