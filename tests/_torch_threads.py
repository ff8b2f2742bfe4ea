"""One torch thread for every CPU test of the port.

A test module takes it by importing the fixture by name, which makes the
autouse fixture apply to every test there:

    from _torch_threads import one_torch_thread  # noqa: F401

This module imports only pytest and torch, so a module that runs on the
card without the JAX package (``--noconftest -m gpu``) may import it too.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch intra-op thread a test, the process's own count restored
    after it.  Under the test run's xdist workers, each worker's torch ops
    past the parallel grain start a full thread pool of their own; the pools
    then contend with each other and with JAX's pools on a shared CPU, and
    a test runs many times slower than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
