"""Torch on one intra-op thread for a test module.

The suite runs under pytest-xdist with six workers on eight cores, and
each worker's torch would start a thread per core for its intra-op pool:
on the port's small test tensors those threads mostly spin against each
other and against the JAX package's own pools.  A test module that imports
:func:`one_torch_thread` runs its tests with one torch thread and restores
the count at its teardown.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
