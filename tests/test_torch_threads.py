"""One intra-op torch thread in each of the port's test modules.

The port's test modules import :func:`one_torch_thread`, an autouse
fixture of module scope: it sets one thread before the module's fixtures
and tests run and puts the count back after, so a module sees the same
count whether it runs alone or in the whole suite, and the JAX package's
modules are left as they were.  pytest-xdist runs several workers at
once, and each one with a torch thread per core would oversubscribe the
cores many times over.  The ranks that ``launch.mesh.run_on_mesh``
spawns set their own count.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_a_port_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
