"""An autouse fixture for the port's test modules: one intra-op torch
thread while the module runs. The port's CPU paths are many small tensor
operations; with torch's default of one thread per core, each of them
waits on cores that the suite's other worker processes hold (a tiled
query took 100x longer, a small volpath render 30x). Import it into a
test module to apply it there:

    from torch_threads import one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
