"""The port's CPU test files run torch on one intra-op thread.

Under several busy test workers, torch's default pool of many threads
waits on descheduled ones between thousands of small ops. Each
``tests/test_torch_*.py`` imports :func:`one_torch_thread`, which pytest
then applies to every test of that file.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's intra-op pool on one thread for this file's tests, restored
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
