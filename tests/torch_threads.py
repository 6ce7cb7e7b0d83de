"""The port's CPU test modules run torch with one intra-op thread.

The test workers share the machine's cores, and a torch thread pool left
idle after a parallel region spins for a while, slowing every other
worker's work (the reference's XLA compiles above all).  The tensors of
these tests are small, so one thread costs them little.  A test module
takes the fixture by importing it:

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for the module; the count is restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
