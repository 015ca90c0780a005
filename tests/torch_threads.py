"""A fixture for the port's CPU tests that run train steps: one PyTorch
intra-op thread while the importing module's tests run.

The suite runs several pytest workers on the host's cores at once.
PyTorch's OpenMP pool spins while it waits for work, so with a pool of one
thread per core in every worker the pools contend for the cores and a
small train step runs many times slower than with one thread.  Importing
``one_torch_thread`` into a test module applies it to that module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
