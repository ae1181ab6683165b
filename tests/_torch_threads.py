"""One intra-op thread for the port's CPU tests.

Several pytest workers share the machine's cores, and each worker's
torch would start an OpenMP pool as wide as the machine: on smoke-size
tensors the pools' threads spin-wait for one another across processes,
which made one test 40 times slower under a full parallel run than
alone.  Every ``tests/test_torch_*.py`` module imports this autouse
fixture, so its tests run torch on one thread and give the setting back
when the module ends.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
