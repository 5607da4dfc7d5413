"""One torch thread while a port test module runs.

A test module imports the fixture (`from torch_threads import
one_torch_thread  # noqa: F401`) to run its tests on one torch thread.
The suite's xdist workers share the machine's cores, and each worker's
OpenMP pool of one thread a core oversubscribed them: the port's files ran
2-18x slower. The fixture restores the thread count when the module is
done, so a module without it (`test_torch_hair.py`) runs at torch's
default, as users do.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
